"""Parameter dataclasses of the PyTorch port.

Counterpart of `cyclistsocialforce_tpu.params` for the vehicle, bicycle,
planar point, planar bicycle, inverted-pendulum bicycle, balancing-rider
and Hess bike-rider families.
Validation runs once, on the host, in `create()` with the JAX package's
rules (reference parameters.py:421-935), including `calib_mode` (clamp
and warn instead of raise).

Leaf representation: a value shared by the whole population is a Python
float, a (min, max) limit pair a tuple of two floats, and a pole or gain
set (`poles`, `gains`) a tuple of Python complex numbers or floats, a
matrix or vector of the balancing rider (`NESTED_FIELDS`) nested tuples
of floats. A
per-agent value (after `as_population`) is a torch tensor whose leading
axis is the agent axis: float64, or complex128 for poles. Python numbers
take the dtype and device of the tensors they meet, so shared parameters
need no device placement; per-agent tensors are placed by
`as_population(..., device=...)`. A field may also be None (an optional
table not built), a static tuple or flag that `as_population` leaves
as it is (`STATIC_FIELDS`; a model's `step_constants` makes device
tensors of what its step reads), or a table shared by the population
(`POPULATION_SHARED`), which `as_population` places on the device but
does not broadcast.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

LIMIT_PREC = 1e-4  # reference parameters.py:428

_TWO_PI = 2.0 * math.pi

# fields stored as (min, max) limit pairs
PAIR_FIELDS = ("v_max_riding", "a_max", "a_desired_default")
# fields stored as a set of values per rider (a pole set, a gain set)
SET_FIELDS = ("poles", "gains")
# fields stored as nested tuples of floats when the population shares them
# (the balancing rider's matrices and pole functions): name -> the number
# of dimensions of one value; a value with one more (per rider, as
# `as_population` makes it) is a tensor
NESTED_FIELDS = {"br_A0": 2, "br_A1": 2, "br_A2": 2, "br_B": 1,
                 "br_B_roll": 1, "br_pole_lin": 2, "br_gains_fixed": 1}


def _err(calib_mode: bool, verbose: bool, msg: str):
    if calib_mode:
        if verbose:
            warnings.warn(msg)
        return True
    raise ValueError(msg)


def _chk_nonneg(name, val, calib_mode=False, verbose=True,
                clamp_to=LIMIT_PREC):
    val = np.asarray(val, dtype=float)
    if np.any(val < 0):
        _err(calib_mode, verbose, f"{name} must be >=0, instead it was {val}")
        val = np.where(val < 0, clamp_to, val)
    return val


def _chk_range(name, val, lo, hi, calib_mode=False, verbose=True,
               clamp=(None, None), lo_open=False, hi_open=False):
    val = np.asarray(val, dtype=float)
    bad_lo = (val <= lo) if lo_open else (val < lo)
    bad_hi = (val >= hi) if hi_open else (val > hi)
    if np.any(bad_lo | bad_hi):
        _err(calib_mode, verbose,
             f"{name} must be in [{lo},{hi}], instead it was {val}")
        c_lo = lo if clamp[0] is None else clamp[0]
        c_hi = hi if clamp[1] is None else clamp[1]
        val = np.clip(val, c_lo, c_hi)
    return val


def _pair(name, val):
    """Validate a (negative, positive) limit pair, e.g. a_max."""
    val = np.asarray(val, dtype=float)
    if val.shape[-1] != 2:
        raise TypeError(f"{name} must be a (min, max) pair.")
    if np.any(val[..., 0] >= 0) or np.any(val[..., 1] <= 0):
        raise ValueError(
            f"{name}[0] must be <0 and {name}[1] must be >0, "
            f"instead it was {val}")
    return val


def _repair_lut_rows(tab):
    """Repair the non-finite rows of a speed-grid table [G, ...] in place:
    each is interpolated linearly from its nearest finite neighbours (or
    copies the one it has). A plant that loses controllability at a grid
    speed (v = 0 exactly: the yaw row of A scales with v) gives such a row,
    as the reference's ct.place fails there; the rows lie below the riding
    speeds the steps read."""
    flat = tab.reshape(tab.shape[0], -1)
    bad = ~np.isfinite(flat).all(axis=1)
    if bad.any():
        good = np.where(~bad)[0]
        for j in np.where(bad)[0]:
            lo = good[good < j]
            hi = good[good > j]
            if len(lo) and len(hi):
                a, b = lo[-1], hi[0]
                t = (j - a) / (b - a)
                tab[j] = (1 - t) * tab[a] + t * tab[b]
            else:
                tab[j] = tab[lo[-1] if len(lo) else hi[0]]
    return tab


# the external models' parameter dicts of VehicleParams
PARAM_DICT_FIELDS = ("rep_force", "dest_force")


def param_dict(name: str, value) -> dict:
    """A parameter slot of an external model as a plain dict of Python
    floats (None: empty). A value per agent is refused: the slots hold
    numbers shared by the population."""
    out = {}
    for key, v in (value or {}).items():
        arr = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                         dtype=np.float64)
        if arr.size != 1 and not np.all(arr == arr.reshape(-1)[0]):
            raise ValueError(
                f"params.{name}[{key!r}] differs between agents: the "
                f"parameter dicts hold values shared by the population")
        out[key] = float(arr.reshape(-1)[0])
    return out


def _nested(arr):
    """A numpy array as nested tuples of Python floats."""
    return (tuple(_nested(a) for a in arr) if arr.ndim else float(arr))


def to_leaf(name: str, value):
    """Host value -> the port's leaf form (see the module docstring).
    Complex values (poles) stay complex, with their imaginary parts."""
    if value is None or isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if np.iscomplexobj(arr):
        arr = arr.astype(np.complex128)
        if arr.ndim == 0:
            return complex(arr)
        if arr.ndim == 1 and name in SET_FIELDS:
            return tuple(complex(c) for c in arr)
        return torch.from_numpy(arr.copy())
    arr = arr.astype(np.float64)
    if arr.ndim == 0:
        return float(arr)
    if name in PAIR_FIELDS and arr.shape == (2,):
        return (float(arr[0]), float(arr[1]))
    if name in SET_FIELDS and arr.ndim == 1:
        return tuple(float(c) for c in arr)
    if NESTED_FIELDS.get(name) == arr.ndim:
        return _nested(arr)
    return torch.from_numpy(arr.copy())


@dataclass(frozen=True)
class VehicleParams:
    """Tactical and repulsive-force-field parameters of a generic vehicle
    (defaults: reference parameters.py:430-451)."""

    t_s: Any = 0.01
    d_arrived_inter: Any = 2.0
    d_arrived_stop: Any = 2.0
    v_max_stop: Any = 0.1
    v_max_harddecel: Any = 2.5
    hfov: Any = _TWO_PI
    # repulsive force-field parameters (BMD2023 "2D model" field shape)
    f_0: Any = 7.0
    e_0: Any = 0.995
    e_1: Any = 0.7
    sigma_0: Any = 0.5
    sigma_1: Any = 5.0
    sigma_2: Any = 0.3
    sigma_3: Any = 4.9
    # the parameter slots of external force models (reference
    # vehicle.py:111-125, external.py:141-181; `external.KATHS_*`): plain
    # dicts of numbers shared by the population, never tensors
    rep_force: dict = dataclasses.field(default_factory=dict)
    dest_force: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, calib_mode: bool = False, verbose: bool = True, **kw):
        """Validated construction (mirrors the reference's property
        setters)."""
        base = {f: kw.pop(f, getattr(cls, f)) for f in
                ("t_s", "d_arrived_inter", "d_arrived_stop", "v_max_stop",
                 "v_max_harddecel", "hfov", "f_0", "e_0", "e_1",
                 "sigma_0", "sigma_1", "sigma_2", "sigma_3")}
        slots = {f: param_dict(f, kw.pop(f, None))
                 for f in PARAM_DICT_FIELDS}
        base["t_s"] = _chk_nonneg("t_s", base["t_s"])
        base["d_arrived_inter"] = _chk_nonneg("d_arrived_inter",
                                              base["d_arrived_inter"])
        base["d_arrived_stop"] = _chk_nonneg("d_arrived_stop",
                                             base["d_arrived_stop"])
        base["v_max_stop"] = _chk_nonneg("v_max_stop", base["v_max_stop"])
        base["v_max_harddecel"] = _chk_nonneg("v_max_harddecel",
                                              base["v_max_harddecel"])
        base["hfov"] = _chk_range("hfov", base["hfov"], 0.0, _TWO_PI,
                                  lo_open=True)
        cm, vb = calib_mode, verbose
        base["f_0"] = _chk_nonneg("f_0", base["f_0"], cm, vb)
        # e_1 before e_0 (the reference initialises _e_1 = 0 first,
        # parameters.py:501-504)
        e1 = np.asarray(base["e_1"], dtype=float)
        e0 = np.asarray(base["e_0"], dtype=float)
        if np.any((e0 <= e1) | (e0 > 1)):
            _err(cm, vb, f"e_0 must be in ]e_1={e1}, 1], instead {e0}")
            e0 = np.clip(e0, e1 * 1.001, 0.99999)
        if np.any((e1 < 0) | (e1 >= e0)):
            _err(cm, vb, f"e_1 must be in [0, e_0={e0}[, instead {e1}")
            e1 = np.clip(e1, 0.0, 0.99999 * e0)
        base["e_0"], base["e_1"] = e0, e1
        base["sigma_0"] = _chk_nonneg("sigma_0", base["sigma_0"], cm, vb)
        base["sigma_1"] = _chk_nonneg("sigma_1", base["sigma_1"], cm, vb)
        base["sigma_2"] = _chk_range(
            "sigma_2", base["sigma_2"], 0.0, base["sigma_0"], cm, vb,
            clamp=(0.0, base["sigma_0"] - LIMIT_PREC), lo_open=True,
            hi_open=True)
        # reference quirk (parameters.py:722-733): in calib mode sigma_3
        # is warned about but NOT clamped
        s3 = np.asarray(base["sigma_3"], dtype=float)
        if np.any((s3 <= 0) | (s3 >= base["sigma_1"])):
            _err(cm, vb,
                 f"sigma_3 must be in ]0, sigma_1={base['sigma_1']}[, "
                 f"instead it was {s3}")
        base["sigma_3"] = s3
        fields = {**base, **kw}
        return cls(**{k: to_leaf(k, v) for k, v in fields.items()},
                   **slots)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CarParams(VehicleParams):
    """Reference parameters.py:753-763."""

    length: Any = 4.0
    width: Any = 2.0


@dataclass(frozen=True)
class BicycleParams(VehicleParams):
    """Bicycle and rider parameters (reference parameters.py:766-935)."""

    hfov: Any = _TWO_PI * 2.0 / 6.0
    v_max_stop: Any = 0.6
    v_max_riding: Any = (-1.0, 10.0)
    v_desired_default: Any = 5.0
    p_decay: Any = 5.0
    p_0: Any = 30.0
    l: Any = 1.0  # noqa: E741 - the reference's wheelbase name
    l_1: Any = 0.5
    l_2: Any = 0.5
    delta_max: Any = 1.4
    a_max: Any = (-10.0, 10.0)
    a_desired_default: Any = (-5.0, 5.0)
    k_p_v: Any = 10.0
    k_p_delta: Any = 10.0
    g: Any = 9.81

    @classmethod
    def create(cls, calib_mode: bool = False, verbose: bool = True, **kw):
        # wheelbase constraint solver (reference parameters.py:891-921):
        # exactly one of l, l_1, l_2 may be omitted; l = l_1 + l_2
        unset = object()
        l = kw.pop("l", unset)  # noqa: E741
        l_1 = kw.pop("l_1", unset)
        l_2 = kw.pop("l_2", unset)
        if l is unset and l_1 is unset and l_2 is unset:
            l, l_1, l_2 = cls.l, cls.l_1, cls.l_2  # noqa: E741
        else:
            l = None if l is unset else l  # noqa: E741
            l_1 = None if l_1 is unset else l_1
            l_2 = None if l_2 is unset else l_2
            if l_1 is None and l_2 is None:
                if l is None:
                    raise ValueError(
                        "If l_1 and l_2 are None, l may not be None!")
                l_1 = np.asarray(l) / 2
                l_2 = np.asarray(l) / 2
            elif l is None:
                l = np.asarray(l_1) + np.asarray(l_2)  # noqa: E741
            elif l_1 is None:
                l_1 = np.asarray(l) - np.asarray(l_2)
            elif l_2 is None:
                l_2 = np.asarray(l) - np.asarray(l_1)
            elif not np.allclose(np.asarray(l),
                                 np.asarray(l_1) + np.asarray(l_2)):
                raise ValueError("Equality l = l_1 + l_2 must hold!")

        fields = {
            "v_max_riding": _pair("v_max_riding",
                                  kw.pop("v_max_riding", cls.v_max_riding)),
            "v_desired_default": _chk_nonneg(
                "v_desired_default",
                kw.pop("v_desired_default", cls.v_desired_default)),
            "p_decay": _chk_nonneg("p_decay", kw.pop("p_decay", cls.p_decay)),
            "p_0": _chk_nonneg("p_0", kw.pop("p_0", cls.p_0)),
            "l": _chk_nonneg("l", l),
            "l_1": _chk_nonneg("l_1", l_1),
            "l_2": _chk_nonneg("l_2", l_2),
            "delta_max": _chk_range(
                "delta_max", kw.pop("delta_max", cls.delta_max), 0.0, np.pi),
            "a_max": _pair("a_max", kw.pop("a_max", cls.a_max)),
            "a_desired_default": _pair(
                "a_desired_default",
                kw.pop("a_desired_default", cls.a_desired_default)),
            "k_p_v": _chk_nonneg("k_p_v", kw.pop("k_p_v", cls.k_p_v)),
            "k_p_delta": _chk_nonneg("k_p_delta",
                                     kw.pop("k_p_delta", cls.k_p_delta)),
            "g": kw.pop("g", cls.g),
        }
        kw.setdefault("hfov", cls.hfov)
        kw.setdefault("v_max_stop", cls.v_max_stop)
        return super().create(calib_mode=calib_mode, verbose=verbose,
                              **fields, **kw)


@dataclass(frozen=True)
class PlanarPointBicycleParams(BicycleParams):
    """Mass-less point bicycle (reference parameters.py:1175-1201): one
    desired yaw pole (it overwrites `gains`, as in the reference)."""

    poles: Any = (-2.0 + 0.0j,)
    gains: Any = (2.0,)


@dataclass(frozen=True)
class PlanarBicycleParams(BicycleParams):
    """Planar two-wheeler (reference parameters.py:1203-1211): the desired
    conjugate pole pair of the steer/yaw loop."""

    poles: Any = (-1.0141284591434665 + 1.226826644413086j,
                  -1.0141284591434665 - 1.226826644413086j)


@dataclass(frozen=True)
class InvPendulumBicycleParams(BicycleParams):
    """Inverted-pendulum bicycle (reference parameters.py:1414-1970;
    defaults parameters.py:1429-1471, with the combined parameter
    tau_1_squared = (I_bike + m h^2) / (m g h)). The twod model runs on
    them as the reference's TwoDBicycle does.

    Two optional tables replace the invpendulum model's per-agent 6x6
    matrix exponential per step (models/invpendulum.py), both built by
    `create` from a float64 sweep of the exact propagator on the CPU:
    `ip_zoh_lut` (`create(zoh_lut=G)`): (table [G, 30] float64 tensor,
    v_lo, dv), the first five rows of expm([[Acl(v) t_s, Bcl(v) t_s],
    [0, 0]]) (25 Phi and 5 Gamma entries) on a uniform speed grid,
    interpolated linearly per step; shared by the population
    (`POPULATION_SHARED`). `ip_zoh_poly` (`create(zoh_poly=S)`): the same
    30 entries as a piecewise quintic over S speed segments of
    [IP_ZOH_POLY_V_LO, v_hi] (`ops.piecewise`), a static tuple of floats
    (`STATIC_FIELDS`). Without either the step takes the exact
    propagator."""

    v_max_riding: Any = (-1.0, 7.0)
    a_max: Any = (-3.0, 1.0)
    a_desired_default: Any = (-1.0, 0.5)
    h: Any = 1.0
    m: Any = 87.0
    i_bike_longlong: Any = 3.28
    i_steer_vertvert: Any = 0.07
    c_steer: Any = 50.0
    k_d0_r2: Any = -600.0
    k_d1_r2: Any = 0.2
    k_p_r1: Any = 0.25
    k_i0_r1: Any = 0.2
    v_max_walk: Any = 1.5
    delta_max_walk: Any = 0.174
    tau_1_squared: Any = (3.28 + 87.0 * 1.0**2) / (87.0 * 9.81 * 1.0)
    ip_zoh_lut: Any = None
    ip_zoh_poly: Any = None
    POPULATION_SHARED = ("ip_zoh_lut",)
    STATIC_FIELDS = ("ip_zoh_poly",)
    IP_ZOH_POLY_V_LO = 1.0

    @classmethod
    def create(cls, calib_mode: bool = False, verbose: bool = True,
               zoh_lut: int = 0, zoh_poly: int = 0, **kw):
        h = _chk_nonneg("h", kw.pop("h", cls.h))
        m = _chk_nonneg("m", kw.pop("m", cls.m))
        ibl = _chk_nonneg("i_bike_longlong",
                          kw.pop("i_bike_longlong", cls.i_bike_longlong))
        isv = _chk_nonneg("i_steer_vertvert",
                          kw.pop("i_steer_vertvert", cls.i_steer_vertvert))
        c_steer = _chk_nonneg("c_steer", kw.pop("c_steer", cls.c_steer))
        k_d0_r2 = np.asarray(kw.pop("k_d0_r2", cls.k_d0_r2), dtype=float)
        if np.any(k_d0_r2 >= 0):
            raise ValueError("k_d0_r2 must be <0 to stabilize the "
                             "lean/steer angle loop.")
        k_d1_r2 = np.asarray(kw.pop("k_d1_r2", cls.k_d1_r2), dtype=float)
        k_p_r1 = _chk_nonneg("k_p_r1", kw.pop("k_p_r1", cls.k_p_r1))
        k_i0_r1 = _chk_nonneg("k_i0_r1", kw.pop("k_i0_r1", cls.k_i0_r1))
        v_max_walk = _chk_nonneg("v_max_walk",
                                 kw.pop("v_max_walk", cls.v_max_walk))
        delta_max_walk = _chk_range(
            "delta_max_walk", kw.pop("delta_max_walk", cls.delta_max_walk),
            0.0, np.pi, lo_open=True)
        g = kw.get("g", cls.g)
        kw.setdefault("v_max_riding", cls.v_max_riding)
        kw.setdefault("a_max", cls.a_max)
        kw.setdefault("a_desired_default", cls.a_desired_default)
        tau_1_squared = (ibl + m * h**2) / (m * np.asarray(g) * h)
        p = super().create(
            calib_mode=calib_mode, verbose=verbose, h=h, m=m,
            i_bike_longlong=ibl, i_steer_vertvert=isv, c_steer=c_steer,
            k_d0_r2=k_d0_r2, k_d1_r2=k_d1_r2, k_p_r1=k_p_r1, k_i0_r1=k_i0_r1,
            v_max_walk=v_max_walk, delta_max_walk=delta_max_walk,
            tau_1_squared=tau_1_squared, **kw)
        if zoh_lut:
            p = p.replace(ip_zoh_lut=cls._build_zoh_lut(p, int(zoh_lut)))
        if zoh_poly:
            p = p.replace(ip_zoh_poly=cls._build_zoh_poly(p, int(zoh_poly)))
        return p

    @staticmethod
    def _build_zoh_lut(p, g: int):
        """The closed-loop ZOH propagator on a uniform grid of g speeds
        over v_max_riding, as (table [g, 30], v_lo, dv). Rows near the
        v = 0 controllability singularity (the gain polynomial diverges
        as 1/v^3) can be non-finite; the riding branch never reads them
        (its speeds stay above ~v_max_walk), so each is interpolated from
        its nearest finite neighbours, as the JAX package does."""
        v_lo = float(pair_lo(p.v_max_riding))
        v_hi = float(pair_hi(p.v_max_riding))
        vs = np.linspace(v_lo, v_hi, g)
        tab = _repair_lut_rows(InvPendulumBicycleParams._zoh_sweep(p)(vs))
        return (torch.from_numpy(tab), v_lo, (v_hi - v_lo) / (g - 1))

    @staticmethod
    def _zoh_sweep(p):
        """``vs [K] -> rows [K, 30]``: the closed-loop ZOH propagator (25
        Phi and 5 Gamma entries) at each speed, in float64 on the CPU
        through the port's `openloop_matrices` and `expm_small`."""
        from cyclistsocialforce_tpu_torch.models import invpendulum as IP
        from cyclistsocialforce_tpu_torch.ops.smallmat import expm_small

        t_s = float(p.t_s)
        pb = {f: float(getattr(p, f)) for f in IP.OPENLOOP_FIELDS}

        def sweep(vs):
            v = torch.as_tensor(np.asarray(vs, dtype=np.float64))
            E = expm_small(IP.zoh_augmented(p, pb, v, t_s))
            return torch.cat([E[:, :5, :5].reshape(-1, 25), E[:, :5, 5]],
                             dim=1).numpy()

        return sweep

    @staticmethod
    def _build_zoh_poly(p, n_seg: int):
        """Piecewise-quintic fit of the ZOH propagator's 30 entries over
        the riding band [IP_ZOH_POLY_V_LO, v_hi] (`ops.piecewise`): the
        band excludes the v -> 0 gain divergence, and below-band speeds
        clamp to its edge, which only the masked walking branch reads."""
        from cyclistsocialforce_tpu_torch.ops.piecewise import \
            fit_piecewise_poly

        v_lo = float(InvPendulumBicycleParams.IP_ZOH_POLY_V_LO)
        v_hi = float(pair_hi(p.v_max_riding))
        if v_hi <= v_lo:
            raise ValueError(
                f"zoh_poly needs v_max_riding > {v_lo} m/s (the fit band "
                f"must clear the v -> 0 gain-schedule divergence)")
        return fit_piecewise_poly(
            InvPendulumBicycleParams._zoh_sweep(p), v_lo, v_hi, int(n_seg))

    # ---- speed-scheduled model and controller parameters ----

    def timevarying_combined_params(self, v):
        """Speed-dependent combined lean-dynamics parameters (K, K tau_2,
        tau_3), reference parameters.py:1832-1855."""
        K_tau_2 = (v * self.l_2) / (self.g * self.l)
        K = (v * v) / (self.g * self.l)
        tau_3 = self.l / v
        return K, K_tau_2, tau_3

    # fitted polynomial-in-1/v full-state feedback gain schedule
    # (reference parameters.py:1857-1892)
    _KX_POLY = (
        (3.48203226e02, -5.12057324e03, 1.58364873e04, -1.98073306e04),
        (-4.51700000e01, 0.00000000e00, 0.00000000e00, 0.00000000e00),
        (-9.16379250e02, 1.31769807e04, -6.57341643e04, 8.22163589e04),
        (3.20214069e02, -4.69953797e03, 1.66378680e04, -2.43114309e04),
        (2.87549256e-08, -2.27913445e03, 0.00000000e00, 0.00000000e00),
    )
    _KU_POLY = (-3.38638984e-09, -2.27913445e03, 0.00000000e00,
                0.00000000e00)

    def fullstate_feedback_gains(self, v):
        """Speed-scheduled full-state feedback gains (K_x [..., 5], K_u
        [...]) for speeds v [...] (a tensor keeps its dtype and device, a
        number becomes float64): a polynomial in 1/v (reference
        parameters.py:1857-1892). The coefficients enter as Python floats,
        so a step copies nothing from the host."""
        if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
            v = torch.as_tensor(v, dtype=torch.float64)
        powers = (torch.ones_like(v), v**-1.0, v**-2.0, v**-3.0)

        def poly(coeffs):
            return sum(c * t for c, t in zip(coeffs, powers))

        K_x = torch.stack([poly(row) for row in self._KX_POLY], dim=-1)
        return K_x, poly(self._KU_POLY)

    def min_stable_speed_inner(self):
        """Minimum speed for inner-loop stability (reference
        parameters.py:1955-1970)."""
        x = self.k_d0_r2
        y = self.c_steer * self.g * (self.l_1 + self.l_2)
        z = y * self.k_d1_r2
        return (-y - (y**2 - 4 * x * z) ** 0.5) / (2 * x)


@dataclass(frozen=True)
class BalancingRiderParams(BicycleParams):
    """Whipple-Carvallo balancing-rider bicycle (reference
    parameters.py:1214-1412), reduced by `create` to what a step reads:
    the speed structure of the 5-state model with yaw,

        A(v) = br_A0 + v br_A1 + v^2 br_A2,  B = br_B (steer torque),
        br_B_roll (roll torque),

    from the canonical matrices of `bicycle_parameter_dict`
    (`ops.whipple`), and the rider's control behavior: pole features
    linear in speed (`br_pole_lin` [5, 2], intercept and slope: a
    component's mean functions from the pole model, or fixed poles), or
    fixed gains (`br_gains_fixed` [5]). The matrices are nested tuples of
    floats (`STATIC_FIELDS`, shared by every rider); the pole functions
    and fixed gains are too, or [N, ...] tensors per rider after
    `as_population`.

    Gain modes of `create` (deterministic control behavior), besides the
    exact per-rider Ackermann placement at the midpoint speed:
    `gains_lut=G`: K(v) on a uniform grid of G speeds over v_max_riding,
    (table [G, 5] float64 tensor, v_lo, dv), interpolated linearly;
    `gains_poly=S`: K(v) as a piecewise quintic over S segments of
    [GAINS_POLY_V_LO, v_hi] (`ops.piecewise`), below-band speeds clamped
    to the band's edge; `prop_lut=G` / `prop_poly=S`: the whole closed-loop
    midpoint propagator [P | Q | R | K] (40 entries) as a table or a
    piecewise quintic. The tables are shared by the population
    (`POPULATION_SHARED`); the fits are static tuples of floats. All are
    swept in float64 on the CPU through the port's `ops.control`.

    Stochastic control behavior (`stochastic_control_behavior=True`,
    reference parameters.py:1376-1411): each rider resamples its pole
    features from the conditional pole model (`polemodel_rt`, a
    `behavior.PoleModelRT`) once its speed moved more than
    `controlparam_resampling_speedthresh` from its last update, at most
    `br_resample_budget` riders per step (0: no cap; the rest defer) and
    only on every `br_resample_every`-th global step. The gains are then
    the exact per-rider placement, or K = charpoly(features) M(v) with the
    Ackermann basis M over speed as a table (`gains_lut=G`:
    `br_ackermann_lut`, [G, 6, 5]) or a piecewise quintic (`gains_poly=S`:
    `br_ackermann_poly`); the propagator modes are refused. Torque
    disturbances (`p_dist_roll`, `p_dist_steer` > 0, any mode): per step
    and rider a Bernoulli draw adds the roll torque `T_dist_roll` or the
    steer torque `T_dist_steer`. Both draw from the state's key
    (`state.agent_streams`), as the JAX package does.
    """

    m: Any = None
    br_A0: Any = None
    br_A1: Any = None
    br_A2: Any = None
    br_B: Any = None
    br_B_roll: Any = None
    br_pole_lin: Any = None
    br_gains_fixed: Any = None
    br_gains_lut: Any = None
    br_prop_lut: Any = None
    br_gains_poly: Any = None
    br_prop_poly: Any = None
    # the stochastic control behavior: the flag, the hysteresis, the pole
    # model, the budget and cadence of the resampling, and the Ackermann
    # basis as a table or a fit (the stochastic gains_lut / gains_poly)
    stochastic_control_behavior: Any = False
    controlparam_resampling_speedthresh: Any = 0.8333
    polemodel_rt: Any = None
    br_resample_budget: Any = 0
    br_resample_every: Any = 1
    br_ackermann_lut: Any = None
    br_ackermann_poly: Any = None
    # torque disturbances: the probabilities, the torques, and "one of
    # the probabilities is nonzero", kept fresh by `replace`
    p_dist_roll: Any = 0.0
    p_dist_steer: Any = 0.0
    T_dist_roll: Any = 9000.0
    T_dist_steer: Any = 1000.0
    br_disturb: Any = False
    POPULATION_SHARED = ("br_gains_lut", "br_prop_lut", "br_ackermann_lut")
    STATIC_FIELDS = ("br_A0", "br_A1", "br_A2", "br_B", "br_B_roll",
                     "br_gains_poly", "br_prop_poly", "br_ackermann_poly",
                     "stochastic_control_behavior", "polemodel_rt",
                     "br_resample_budget", "br_resample_every",
                     "br_disturb")
    # lower edge of the gains_poly/prop_poly fit band: K(v) has poles at
    # v = 0 and v ~ 1.25 (controllability losses)
    GAINS_POLY_V_LO = 2.0

    @classmethod
    def create(cls, bicycle_parameter_dict=None, poles=None, gains=None,
               controlparam_filename="BR1_ImRe5GivenV_pole-model-params"
                                     ".yaml",
               stochastic_control_behavior=False,
               controlparam_resampling_speedthresh=0.8333,
               controlparam_polemodel_component=0,
               p_dist_roll=0.0, p_dist_steer=0.0,
               T_dist_roll=9000.0, T_dist_steer=1000.0,
               gains_lut=0, prop_lut=0, prop_poly=0, gains_poly=0,
               resample_budget=0, resample_every=1,
               calib_mode=False, verbose=True, **kw):
        from cyclistsocialforce_tpu_torch import behavior
        from cyclistsocialforce_tpu_torch.ops import whipple

        stochastic = bool(stochastic_control_behavior)
        if prop_lut and prop_poly:
            raise ValueError(
                "prop_lut and prop_poly are alternative propagator modes: "
                "pass one")
        if (prop_lut or prop_poly) and stochastic:
            raise ValueError(
                "prop_lut/prop_poly express the closed-loop midpoint "
                "propagator over speed alone; with stochastic control "
                "behavior Acl depends on per-agent pole features (use "
                "gains_lut/gains_poly for the Ackermann-basis forms "
                "instead)")

        p = dict(bicycle_parameter_dict or whipple.BALANCEASSIST_WITH_RIDER)
        # wheelbase forced to the physical parameter set (reference
        # parameters.py:1290-1295)
        kw["l"] = p["w"]
        kw["l_1"] = p["w"] / 2.0
        kw.pop("l_2", None)
        kw["g"] = p["g"]
        kw["m"] = p["mB"] + p["mF"] + p["mH"] + p["mR"]

        # A(v) from the canonical matrices (Meijaard 2007):
        # A[2:4, 0:2] = -Minv (g K0 + v^2 K2), A[2:4, 2:4] = -Minv C1 v,
        # yaw row A[4, 1] = cos(lam)/w v, A[4, 3] = cos(lam) c/w
        # (reference dynamics.py:511-538)
        M, C1, K0, K2 = whipple.canonical_matrices(p)
        Minv = np.linalg.inv(M)
        cl, w, c = np.cos(p["lam"]), p["w"], p["c"]
        A0 = np.zeros((5, 5))
        A0[0:2, 2:4] = np.eye(2)
        A0[2:4, 0:2] = -Minv @ (p["g"] * K0)
        A0[4, 3] = cl * c / w
        A1 = np.zeros((5, 5))
        A1[2:4, 2:4] = -Minv @ C1
        A1[4, 1] = cl / w
        A2 = np.zeros((5, 5))
        A2[2:4, 0:2] = -Minv @ K2
        B = np.zeros(5)
        B[2:4] = Minv[:, 1]
        B_roll = np.zeros(5)
        B_roll[2:4] = Minv[:, 0]

        # rider control behavior
        pole_lin = gains_fixed = pm_rt = None
        if gains is not None:
            gains_fixed = np.asarray(gains, dtype=float).reshape(-1)
        elif poles is not None:
            # fixed poles in the reference ordering
            # [real, a+jb, a-jb, c+jd, c-jd] -> feature vector
            po = np.asarray(poles, dtype=complex).reshape(-1)
            feats = np.array([po[0].real, po[1].real, abs(po[1].imag),
                              po[3].real, abs(po[3].imag)])
            pole_lin = np.c_[feats, np.zeros(5)]
        else:
            pm = behavior.load_packaged_polemodel(controlparam_filename)
            if stochastic:
                if controlparam_polemodel_component >= pm.gmm.n_components:
                    raise ValueError(
                        f"pole model {controlparam_filename} has only "
                        f"{pm.gmm.n_components} components")
                pm_rt = behavior.PoleModelRT.from_polemodel(pm)
            # the mean functions (in stochastic mode the initial features)
            pole_lin = pm.component_mean_function_params()[
                controlparam_polemodel_component]

        vmr = kw.get("v_max_riding", cls.v_max_riding)
        v_lo_r, v_hi = float(pair_lo(vmr)), float(pair_hi(vmr))
        h_ts = float(np.asarray(kw.get("t_s", cls.t_s)))
        gains_at = cls._gains_sweep(A0, A1, A2, B, pole_lin, gains_fixed)

        def prop_rows(vs, repair):
            """[P | Q | R | K] [len(vs), 40] at speeds vs: with Acl = A(v)
            - B K(v) and M = I - h/2 Acl, P = M^-1 (I + h/2 Acl) [25],
            Q = M^-1 h B [5], R = M^-1 h B_roll [5], K(v) [5] (`repair`:
            K's non-finite rows first, as for a gains table)."""
            gp = len(vs)
            Kg = gains_at(vs)
            if repair:
                Kg = _repair_lut_rows(Kg)
            Av = (A0[None] + vs[:, None, None] * A1[None]
                  + (vs ** 2)[:, None, None] * A2[None])
            Acl = Av - B[None, :, None] * Kg[:, None, :]
            eye = np.eye(5)[None]
            Mi = np.linalg.inv(eye - (h_ts / 2.0) * Acl)
            Pm = Mi @ (eye + (h_ts / 2.0) * Acl)
            return np.concatenate([Pm.reshape(gp, 25), Mi @ (h_ts * B),
                                   Mi @ (h_ts * B_roll), Kg], axis=1)

        def grid(g):
            vs = np.linspace(v_lo_r, v_hi, int(g))
            return vs, float((v_hi - v_lo_r) / (int(g) - 1))

        def band(name):
            v_lo = float(cls.GAINS_POLY_V_LO)
            if v_hi <= v_lo:
                raise ValueError(
                    f"{name} needs v_max_riding > {v_lo} m/s (the K(v) "
                    f"pole at v ~ 1.25 bounds the fit band)")
            return v_lo

        def basis_at(vs):
            """The Ackermann basis M(v) [len(vs), 6, 5] (float64, CPU):
            K = charpoly(features) M(v) for any pole features."""
            from cyclistsocialforce_tpu_torch.ops.control import \
                ackermann_basis

            v = torch.from_numpy(np.asarray(vs, dtype=np.float64))
            vv = v[:, None, None]
            t = [torch.from_numpy(a) for a in (A0, A1, A2, B)]
            return ackermann_basis(t[0] + vv * t[1] + (vv * vv) * t[2],
                                   t[3].expand(len(v), 5)).numpy()

        lut = plut = poly = prop_pl = ack_lut = ack_poly = None
        if gains_lut and gains_fixed is None:
            vs, dv = grid(gains_lut)
            if stochastic:
                ack_lut = (torch.from_numpy(_repair_lut_rows(basis_at(vs))),
                           v_lo_r, dv)
            else:
                lut = (torch.from_numpy(_repair_lut_rows(gains_at(vs))),
                       v_lo_r, dv)
        if prop_lut:
            vs, dv = grid(prop_lut)
            plut = (torch.from_numpy(_repair_lut_rows(prop_rows(vs, True))),
                    v_lo_r, dv)
        if prop_poly:
            from cyclistsocialforce_tpu_torch.ops.piecewise import \
                fit_piecewise_poly

            prop_pl = fit_piecewise_poly(
                lambda vs: prop_rows(np.asarray(vs), False), band("prop_poly"),
                v_hi, int(prop_poly))
        if gains_poly and gains_fixed is None:
            from cyclistsocialforce_tpu_torch.ops.piecewise import \
                fit_piecewise_poly

            if stochastic:
                ack_poly = fit_piecewise_poly(
                    lambda vs: basis_at(vs).reshape(len(vs), 30),
                    band("gains_poly"), v_hi, int(gains_poly))
            else:
                poly = fit_piecewise_poly(gains_at, band("gains_poly"), v_hi,
                                          int(gains_poly))

        p_dist_roll = _chk_range("p_dist_roll", p_dist_roll, 0.0, 1.0)
        p_dist_steer = _chk_range("p_dist_steer", p_dist_steer, 0.0, 1.0)
        out = super().create(
            calib_mode=calib_mode, verbose=verbose,
            br_A0=A0, br_A1=A1, br_A2=A2, br_B=B, br_B_roll=B_roll,
            br_pole_lin=pole_lin, br_gains_fixed=gains_fixed,
            controlparam_resampling_speedthresh=(
                controlparam_resampling_speedthresh),
            p_dist_roll=p_dist_roll, p_dist_steer=p_dist_steer,
            T_dist_roll=T_dist_roll, T_dist_steer=T_dist_steer, **kw)
        return dataclasses.replace(
            out, br_gains_lut=lut, br_prop_lut=plut, br_gains_poly=poly,
            br_prop_poly=prop_pl, br_ackermann_lut=ack_lut,
            br_ackermann_poly=ack_poly,
            stochastic_control_behavior=stochastic, polemodel_rt=pm_rt,
            br_resample_budget=int(resample_budget),
            br_resample_every=int(resample_every),
            br_disturb=bool(np.any(p_dist_roll) or np.any(p_dist_steer)))

    @staticmethod
    def _gains_sweep(A0, A1, A2, B, pole_lin, gains_fixed):
        """``vs [K] -> K(v) [K, 5]`` (numpy): the fixed gains, or the
        Ackermann placement of the pole features pole_lin[:, 0] +
        pole_lin[:, 1] v on A(v), in float64 on the CPU through the port's
        `ops.control`."""
        from cyclistsocialforce_tpu_torch.ops.control import (
            ackermann, charpoly_from_pole_features)

        if gains_fixed is not None:
            return lambda vs: np.broadcast_to(
                gains_fixed, (len(vs), 5)).copy()
        t = {k: torch.from_numpy(np.asarray(a, dtype=np.float64))
             for k, a in dict(A0=A0, A1=A1, A2=A2, B=B, lin=pole_lin).items()}

        def sweep(vs):
            v = torch.from_numpy(np.asarray(vs, dtype=np.float64))
            vv = v[:, None, None]
            A = t["A0"] + vv * t["A1"] + (vv * vv) * t["A2"]
            feats = t["lin"][:, 0] + t["lin"][:, 1] * v[:, None]
            return ackermann(A, t["B"].expand(len(v), 5),
                             charpoly_from_pole_features(feats)).numpy()

        return sweep

    def replace(self, **kw):
        """`dataclasses.replace`, with `br_disturb` kept fresh when a
        disturbance probability changes."""
        out = dataclasses.replace(self, **kw)
        if (("p_dist_roll" in kw or "p_dist_steer" in kw)
                and "br_disturb" not in kw):
            out = dataclasses.replace(out, br_disturb=bool(
                np.any(_host(out.p_dist_roll))
                or np.any(_host(out.p_dist_steer))))
        return out


def _host(value):
    return np.asarray(value.cpu() if isinstance(value, torch.Tensor)
                      else value)


@dataclass(frozen=True)
class HessBikeRiderParams(BalancingRiderParams):
    """BalancingRider physics under the fixed Hess/Moore neuromuscular
    steer-torque control gains (reference dynamics.py:727-739): no pole
    model."""

    k_delta: Any = 43.0
    k_phi: Any = 8.5
    k_dphi: Any = -0.08
    k_psi: Any = 0.173
    omega: Any = 28.0
    zeta: Any = float(np.sqrt(2) / 2)

    @classmethod
    def create(cls, k_delta=43.0, k_phi=8.5, k_dphi=-0.08, k_psi=0.173,
               omega=28.0, zeta=float(np.sqrt(2) / 2), **kw):
        # the gains are fixed: skip the pole model entirely
        kw.setdefault("gains", np.zeros(5))
        return super().create(k_delta=k_delta, k_phi=k_phi, k_dphi=k_dphi,
                              k_psi=k_psi, omega=omega, zeta=zeta, **kw)


@dataclass(frozen=True)
class RoadElementParams:
    """Road-edge repulsion and drawing parameters (reference
    parameters.py:367-418)."""

    F_0: Any = 0.05
    sigma: Any = 3.0
    # drawing style (host-side metadata, reference defaults)
    roadsurface_color: Any = (0.8, 0.8, 0.8)
    roadedge_color: Any = "white"
    roadedge_linewidth: float = 1.0

    @classmethod
    def create(cls, F_0: float = 0.05, sigma: float = 3.0, **kw):
        return cls(F_0=float(_chk_nonneg("F_0", F_0)),
                   sigma=float(_chk_nonneg("sigma", sigma)), **kw)


PARAM_CLASSES = {cls.__name__: cls for cls in (
    VehicleParams, CarParams, BicycleParams, PlanarPointBicycleParams,
    PlanarBicycleParams, InvPendulumBicycleParams, BalancingRiderParams,
    HessBikeRiderParams)}


def pair_lo(pair):
    """Lower element of a (min, max) limit pair (tuple or [..., 2])."""
    if isinstance(pair, (tuple, list)):
        return pair[0]
    return pair[..., 0]


def pair_hi(pair):
    """Upper element of a (min, max) limit pair (tuple or [..., 2])."""
    if isinstance(pair, (tuple, list)):
        return pair[1]
    return pair[..., 1]


def as_population(params, n: int, device="cuda"):
    """Broadcast every numeric field to a tensor of shape [n, ...] on
    `device` (float64; complex128 for poles), so that it can be updated
    agent by agent. A None field stays None, a static field
    (`STATIC_FIELDS`, e.g. `ip_zoh_poly`) stays the same object, and a
    population-shared table (`POPULATION_SHARED`, e.g. `ip_zoh_lut`) keeps
    its shape and moves to `device`."""
    cls = type(params)
    static = getattr(cls, "STATIC_FIELDS", ())
    shared = getattr(cls, "POPULATION_SHARED", ())
    upd = {}
    for f in dataclasses.fields(params):
        val = getattr(params, f.name)
        if val is None or f.name in static or f.name in PARAM_DICT_FIELDS:
            continue
        if f.name in shared:
            upd[f.name] = tuple(v.to(device) if isinstance(v, torch.Tensor)
                                else v for v in val)
            continue
        arr = np.asarray(val.cpu() if isinstance(val, torch.Tensor)
                         else val)
        t = torch.from_numpy(arr.astype(
            np.complex128 if np.iscomplexobj(arr) else np.float64))
        upd[f.name] = t.expand((n,) + tuple(t.shape)).contiguous().to(device)
    return params.replace(**upd)
