"""Parameter dataclasses of the PyTorch port.

Counterpart of `cyclistsocialforce_tpu.params` for the vehicle and
bicycle families. Validation runs once, on the host, in `create()` with
the JAX package's rules (reference parameters.py:421-935), including
`calib_mode` (clamp and warn instead of raise).

Leaf representation: a value shared by the whole population is a Python
float, a (min, max) limit pair is a tuple of two floats, and a per-agent
value (after `as_population`) is a torch tensor whose leading axis is the
agent axis. Python floats take the dtype and device of the tensors they
meet, so shared parameters need no device placement; per-agent tensors
are placed by `as_population(..., device=...)`.
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


def to_leaf(name: str, value):
    """Host value -> the port's leaf form (see the module docstring)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        return float(arr)
    if name in PAIR_FIELDS and arr.shape == (2,):
        return (float(arr[0]), float(arr[1]))
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

    @classmethod
    def create(cls, calib_mode: bool = False, verbose: bool = True, **kw):
        """Validated construction (mirrors the reference's property
        setters)."""
        base = {f: kw.pop(f, getattr(cls, f)) for f in
                ("t_s", "d_arrived_inter", "d_arrived_stop", "v_max_stop",
                 "v_max_harddecel", "hfov", "f_0", "e_0", "e_1",
                 "sigma_0", "sigma_1", "sigma_2", "sigma_3")}
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
        return cls(**{k: to_leaf(k, v) for k, v in fields.items()})

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


PARAM_CLASSES = {"VehicleParams": VehicleParams, "CarParams": CarParams,
                 "BicycleParams": BicycleParams}


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
    """Broadcast every numeric field to a float64 tensor of shape [n, ...]
    on `device`, so that it can be updated agent by agent."""
    upd = {}
    for f in dataclasses.fields(params):
        val = getattr(params, f.name)
        t = torch.as_tensor(np.asarray(val.cpu() if isinstance(
            val, torch.Tensor) else val, dtype=np.float64))
        upd[f.name] = t.expand((n,) + tuple(t.shape)).contiguous().to(device)
    return params.replace(**upd)
