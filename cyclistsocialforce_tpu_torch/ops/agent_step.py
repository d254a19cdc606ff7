"""One step of a model's per-agent chain as two CUDA kernels around the
pair kernel (`csrc/agent_step.cu`), their wrappers, their plain PyTorch
versions and their launch counters.

  agent_pre   the destination force with the destination-queue update and
              the navigation FSM (`engine.dest_force_straight`, or
              `engine.dest_force_spline` in the kernel's spline instance;
              an inactive row's FSM fields held, as `Engine.finish_step`
              holds them), then the pair packs (`Engine.pack_pair_fields`)
  agent_post  the repulsion clamped and added to the destination force
              (`ops.forces.clamp_add_dest`), bicycle2d's step
              (`models.bicycle2d.step`; the twod model's,
              `models.bicycle_twod.step`, with its arrived-freeze, in the
              kernel's twod instance) and the step's bookkeeping
              (`Engine.finish_step`)
  agent_post_whipple
              the same clamp and bookkeeping around the balancing rider's
              step (`models.balancingrider.step`) with its gains a
              piecewise polynomial of speed: the speed control, the gains,
              A(v) - B K, the implicit-midpoint 5x5 solve and the positions

The JAX package compiles this chain with the rest of a chunk into one XLA
program, which fuses it (its `engine.py` :49-102, :901-980, :1118-1198,
`models/bicycle2d.py`, `models/bicycle_twod.py` and
`models/balancingrider.py`). In the port a model module declares the
kernels its step takes (an `AgentKernels` from its `agent_kernels(params)`
hook), the engine decides where a step takes them (`Engine.agent_kernels`)
and `Engine.step_with_forces` runs them; this module only launches them.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors. The plain versions are the engine's own torch
functions, composed as `Engine.calc_forces`, `dynamics` and
`finish_step` compose them, and the kernels are held to them on the card
bit for bit: every operation rounds as PyTorch's CUDA kernel does
(`csrc/agent_step.cu`). The host computes the constants that PyTorch
computes on the host: a Python float cast to float32, the float32
reciprocal by which PyTorch's CUDA kernel multiplies where a tensor is
divided by a Python float, and expressions of Python floats alone in
double (`_nav_constants`, `_model_constants`, `_whipple_constants`).

The navigation parameters and those the post kernel reads are shared
(Python floats and (min, max) pairs of them: `takes_params`); the
pair-field columns may be per rider, [R] float32 or float64 tables on the
state's device read by uid and clamped to the table's last row, as
`Engine.pack_pair_fields` gathers them. The balancing rider's matrices and
its gains' fit are the engine's kept `step_constants` tensors, which the
kernel reads by address.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.ops import forces as F
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.ops.navigation import BRAKE_SAFETY_K
from cyclistsocialforce_tpu_torch.ops.spline import (SPL_N_PNTS,
                                                     SPL_THETA_COMF,
                                                     SPL_V_MIN_STABLE)
from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo

# the shared parameters the kernels take as arguments
NAV_FIELDS = ("d_arrived_inter", "d_arrived_stop", "v_max_stop",
              "v_max_harddecel", "v_desired_default", "a_max",
              "a_desired_default")
# agent_post's and agent_post_whipple's (a model's `AgentKernels.fields`)
MODEL_FIELDS = ("t_s", "k_p_delta", "k_p_v", "a_max", "delta_max",
                "v_max_riding", "l")
WHIPPLE_FIELDS = ("t_s", "k_p_v", "a_max", "v_max_riding")
# the shared parameter the spline instance takes beyond the others (t_s,
# a model field, also sets the lookback: `engine.spline_lookback`)
SPLINE_FIELDS = ("g",)
LIMIT_PAIRS = ("a_max", "a_desired_default", "v_max_riding")
# the pack's field columns, in csrc/agent_step.cu's `Col` order ("v_max"
# is v_max_riding's upper limit, the legacy field's excentricity scale)
PACK_COLUMNS = ("hfov", "p_0", "p_decay", "f_0", "e_0", "e_1", "sigma_0",
                "sigma_1", "sigma_2", "sigma_3", "v_max")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _PairCol(ctypes.Structure):
    _fields_ = [("p", _P), ("rows", ctypes.c_longlong), ("f64", _I),
                ("v", _F)]


def _struct(name, pointers, ints, floats, tail=()):
    return type(name, (ctypes.Structure,), {"_fields_": [
        *((f, _P) for f in pointers), *((f, _I) for f in ints),
        *((f, _F) for f in floats), *tail]})


_PRE_IN = ("s", "dest", "destqueue", "destpointer", "nq", "znav",
           "znavparams", "i", "i_stopsignal", "d_stopsignal", "active", "uid")
_PRE_OUT = ("fdx", "fdy", "dest_out", "ptr_out", "znav_out", "znavp_out",
            "istop_out", "dstop_out", "src_pack", "recv_pack")
_NAV_CONSTANTS = ("d_arrived_inter", "d_arrived_stop", "v_max_stop",
                  "v_max_harddecel", "v_desired_default", "vh2", "inv_a_des",
                  "d1_new", "inv_k")
_AgentPreArgs = _struct(
    "_AgentPreArgs", _PRE_IN + _PRE_OUT, ("n", "npad", "q", "legacy"),
    _NAV_CONSTANTS, [("cols", _PairCol * len(PACK_COLUMNS))])

# agent_pre's spline instance: agent_pre's arguments, the ring and the
# clock, the ring's length and the lookback, and the spline's constants
_SPLINE_CONSTANTS = ("sixth", "third", "q_step", "tc_g", "v_stable")
_AgentPreSplineArgs = type("_AgentPreSplineArgs", (ctypes.Structure,), {
    "_fields_": [("base", _AgentPreArgs), ("pos_hist", _P), ("t_glob", _P),
                 ("hist", _I), ("lookback", _I),
                 *((f, _F) for f in _SPLINE_CONSTANTS)]})

# the destination and FSM fields agent_pre sets
_CHANGED = ("dest", "destpointer", "znav", "znavparams", "i_stopsignal",
            "d_stopsignal")
# the fields no step of the fused form changes: the step's result holds
# the argument's own tensors
UNCHANGED = ("dyn_x", "dyn_v", "dyn_gains", "destqueue", "nq", "zrid",
             "walk_ok_steps", "active", "uid", "key")
# the pre-step state fields agent_post reads, then agent_pre's
# destination and pointer (suffix _a), the forces, then its outputs
_POST_IN = ("s", "pid_e", "pid_i", "i", "t_glob", "pos_hist", "active",
            "nq", "dest_a", "destpointer_a", "fdx", "fdy", "frx", "fry")
_POST_OUT = ("s_out", "pid_e_out", "pid_i_out", "i_out", "t_out",
             "pos_hist_out", "fx", "fy")
_MODEL_CONSTANTS = ("t_s", "inv_t_s", "k_p_delta", "k_p_v", "a_max_lo",
                    "a_max_hi", "delta_max", "neg_delta_max", "v_max_lo",
                    "v_max_hi", "inv_l")
_AgentPostArgs = _struct("_AgentPostArgs", _POST_IN + _POST_OUT,
                         ("n", "hist"), _MODEL_CONSTANTS)
# agent_post's twod instance: agent_post's arguments and agent_pre's FSM
# state
_AgentPostTwodArgs = type("_AgentPostTwodArgs", (ctypes.Structure,), {
    "_fields_": [("base", _AgentPostArgs), ("znav", _P)]})
# agent_post_whipple: the pre-step state fields, the forces and the
# balancing rider's kept constants, then its outputs
_WPOST_IN = ("s", "dyn_x", "dyn_v", "dyn_gains", "i", "t_glob", "pos_hist",
             "active", "fdx", "fdy", "frx", "fry", "A0", "A1", "A2", "B",
             "gains_coeffs")
_WPOST_OUT = ("s_out", "dyn_x_out", "dyn_v_out", "dyn_gains_out", "i_out",
              "t_out", "pos_hist_out", "fx", "fy")
_WHIPPLE_CONSTANTS = ("t_s", "half_t_s", "k_p_v", "a_max_lo", "a_max_hi",
                      "v_max_lo", "v_max_hi", "poly_lo", "inv_seg_dv",
                      "x_max")
_AgentPostWhippleArgs = _struct(
    "_AgentPostWhippleArgs", _WPOST_IN + _WPOST_OUT,
    ("n", "hist", "gains", "deg1", "segs", "coeff_row", "coeff_seg"),
    _WHIPPLE_CONSTANTS)
# the fields agent_post_whipple leaves as they are
UNCHANGED_WHIPPLE = ("pid_e", "pid_i", "destqueue", "nq", "zrid",
                     "walk_ok_steps", "active", "uid", "key")
# the coefficients of the gains' fit agent_post_whipple stages in shared
# memory beside the 80 of A0, A1, A2 and B and each of its 8 warps' 512
# floats of staging: 48 KB in all
WHIPPLE_MAX_COEFFS = 12 * 1024 - 80 - 8 * 512

# each state field's dtype and width per row (0: [n]) as the kernels take it
_FIELD_FORMS = {"s": (torch.float32, 8), "dest": (torch.float32, 3),
                "destpointer": (torch.int32, 0), "nq": (torch.int32, 0),
                "znav": (torch.bool, 3), "znavparams": (torch.float32, 4),
                "i": (torch.int32, 0), "i_stopsignal": (torch.int32, 0),
                "d_stopsignal": (torch.float32, 0),
                "active": (torch.bool, 0), "uid": (torch.int32, 0),
                "pid_e": (torch.float32, 2), "pid_i": (torch.float32, 2),
                "dyn_x": (torch.float32, 7), "dyn_v": (torch.float32, 0)}


class AgentKernels(NamedTuple):
    """The per-agent kernels a model's step takes, as its module declares
    them (its `agent_kernels(params)` hook; `Engine.agent_kernels` decides
    where a step takes them).

      dest      agent_pre's destination force, a name in
                `engine.DEST_FORCES`: "straight" (agent_pre) or "spline"
                (its spline instance)
      post      the post kernel's instance: "agent_post", "agent_post_twod"
                (agent_post's twod instance, with the arrived-freeze) or
                "agent_post_whipple"
      fields    the shared parameters the kernels read beside the
                navigation ones (`takes_params`)
      families  the culled pair families they are admitted for"""

    dest: str
    post: str
    fields: tuple
    families: tuple


class PreStep(NamedTuple):
    """What agent_pre hands on: the destination force (fdx, fdy) [n], the
    state with the destination and FSM fields the step sets (`dest`,
    `destpointer`, `znav`, `znavparams`, `i_stopsignal`,
    `d_stopsignal`: an active row's updated, an inactive row's held; the
    rest are the argument's), and the pair packs src [npad, 16] and recv
    [8, npad] in row order."""

    fdx: torch.Tensor
    fdy: torch.Tensor
    state: object
    src_pack: torch.Tensor
    recv_pack: torch.Tensor


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_shared(params, field) -> bool:
    v = getattr(params, field)
    if field in LIMIT_PAIRS:
        return (isinstance(v, tuple) and len(v) == 2
                and all(map(_is_number, v)))
    return _is_number(v)


def _pack_values(params) -> dict:
    values = {f: getattr(params, f) for f in PACK_COLUMNS[:-1]}
    values["v_max"] = pair_hi(params.v_max_riding)
    return values


def takes_params(params, device, model_fields) -> bool:
    """Do the kernels take `params`: every navigation parameter and each
    of `model_fields` (an `AgentKernels`' fields) shared, every pair-field
    column shared or a 1-D float32 or float64 per-rider table on
    `device`?"""
    if not all(hasattr(params, f) for f in NAV_FIELDS + model_fields
               + PACK_COLUMNS[:-1]):
        return False
    if not all(_is_shared(params, f) for f in NAV_FIELDS + model_fields):
        return False
    for v in _pack_values(params).values():
        if isinstance(v, torch.Tensor):
            if (v.ndim != 1 or v.numel() == 0 or v.device != device
                    or v.dtype not in (torch.float32, torch.float64)
                    or not v.is_contiguous()):
                return False
        elif not _is_number(v):
            return False
    return True


def _require_fused(name, engine, state, posts=None) -> AgentKernels:
    """The kernels a step of `state` takes (`Engine.agent_kernels`); raise
    unless there are any and their post kernel is one of `posts` (None:
    any)."""
    k = engine.agent_kernels(state)
    if k is None or (posts is not None and k.post not in posts):
        raise ValueError(
            f"{name}: the kernel takes a float32 state of more than one row "
            f"on a CUDA device and an engine of the fused form "
            f"(`Engine.agent_kernels`): a model that declares this kernel, "
            f"its destination force, a declared pair family culled, shared "
            f"navigation and model parameters, per-rider pair columns as "
            f"1-D float tables on the state's device, a ring that holds the "
            f"spline's lookback, no road, scripts or hooks")
    return k


def _f32(x) -> float:
    return float(np.float32(x))


def _inv(x) -> float:
    """The float32 reciprocal of a Python float, as PyTorch's CUDA kernel
    takes it where a tensor is divided by that float."""
    return float(np.float32(1.0) / np.float32(x))


def _nav_constants(params) -> dict:
    """ops/navigation.py's shared values, each as PyTorch's CUDA kernels
    apply it: `vh * vh` and `d1_new` are products of Python floats (in
    double), the divisions by a_desired_default[0] and by the braking
    safety factor are multiplications by float32 reciprocals."""
    vh = float(params.v_max_harddecel)
    a_max_lo = float(pair_lo(params.a_max))
    return {"d_arrived_inter": _f32(params.d_arrived_inter),
            "d_arrived_stop": _f32(params.d_arrived_stop),
            "v_max_stop": _f32(params.v_max_stop),
            "v_max_harddecel": _f32(vh),
            "v_desired_default": _f32(params.v_desired_default),
            "vh2": _f32(vh * vh),
            "inv_a_des": _inv(pair_lo(params.a_desired_default)),
            "d1_new": _f32(0.5 * (-(vh * vh)) / a_max_lo),
            "inv_k": _inv(BRAKE_SAFETY_K)}


def _model_constants(params) -> dict:
    """models/bicycle2d.py's shared values, as PyTorch's CUDA kernels apply
    them (the divisions by t_s and by l multiply by float32
    reciprocals)."""
    return {"t_s": _f32(params.t_s), "inv_t_s": _inv(params.t_s),
            "k_p_delta": _f32(params.k_p_delta), "k_p_v": _f32(params.k_p_v),
            "a_max_lo": _f32(pair_lo(params.a_max)),
            "a_max_hi": _f32(pair_hi(params.a_max)),
            "delta_max": _f32(params.delta_max),
            "neg_delta_max": _f32(-params.delta_max),
            "v_max_lo": _f32(pair_lo(params.v_max_riding)),
            "v_max_hi": _f32(pair_hi(params.v_max_riding)),
            "inv_l": _inv(params.l)}


def _whipple_constants(params) -> dict:
    """models/balancingrider.py's and ops/piecewise.py's shared values, as
    PyTorch's CUDA kernels apply them: `t_s / 2.0` is a quotient of Python
    floats (in double), the division by the fit's segment width a
    multiplication by its float32 reciprocal, and the fit's clamp
    `float(segs) - 1e-6` a Python float."""
    coeffs, lo, seg_dv = params.br_gains_poly
    return {"t_s": _f32(params.t_s), "half_t_s": _f32(params.t_s / 2.0),
            "k_p_v": _f32(params.k_p_v),
            "a_max_lo": _f32(pair_lo(params.a_max)),
            "a_max_hi": _f32(pair_hi(params.a_max)),
            "v_max_lo": _f32(pair_lo(params.v_max_riding)),
            "v_max_hi": _f32(pair_hi(params.v_max_riding)),
            "poly_lo": _f32(lo), "inv_seg_dv": _inv(seg_dv),
            "x_max": _f32(float(len(coeffs)) - 1e-6)}


def _spline_constants(params) -> dict:
    """engine.py dest_force_spline's and ops/spline.py's shared values, as
    PyTorch's CUDA kernels apply them: the divisions by 6.0 and 3.0
    multiplications by float32 reciprocals, the nearest-sample grid's
    step the float of 1 / 19 (`spline.uniform_grid`), the comfort lean
    times g the float32 product of the two floats (`SPL_THETA_COMF * g`
    with g a float32 tensor)."""
    return {"sixth": _inv(6.0), "third": _inv(3.0),
            "q_step": _f32(1.0 / (SPL_N_PNTS - 1)),
            "tc_g": float(np.float32(SPL_THETA_COMF) * np.float32(params.g)),
            "v_stable": _f32(SPL_V_MIN_STABLE)}


def _pair_col(v) -> _PairCol:
    if isinstance(v, torch.Tensor):
        return _PairCol(v.data_ptr(), v.shape[0],
                        int(v.dtype == torch.float64), 0.0)
    return _PairCol(None, 0, 0, _f32(v))


def _check_state(name, state, fields):
    """The kernels take contiguous state fields of the forms they read."""
    n = state.n
    for f in fields:
        t = getattr(state, f)
        dtype, width = _FIELD_FORMS[f]
        shape = (n, width) if width else (n,)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name}: state.{f} must be {dtype} of shape "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: state.{f} must be contiguous")


def _check_post_inputs(name, before, pre: PreStep, frx, fry):
    """A post kernel takes contiguous float32 [n] forces, and the ring and
    clock of `_check_ring`."""
    n = before.n
    for label, t in (("fdx", pre.fdx), ("fdy", pre.fdy), ("frx", frx),
                     ("fry", fry)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                or not t.is_contiguous()):
            raise TypeError(f"{name}: {label} must be a contiguous "
                            f"float32 [{n}] tensor")
    _check_ring(name, before)


def _check_ring(name, before):
    """A contiguous float32 [n, H, 2] position ring and a one-element
    int32 clock."""
    n = before.n
    ph = before.pos_hist
    if (ph.dtype != torch.float32 or ph.ndim != 3 or ph.shape[0] != n
            or ph.shape[2] != 2 or not ph.is_contiguous()):
        raise TypeError(f"{name}: state.pos_hist must be a contiguous "
                        f"float32 [n, H, 2] tensor")
    if before.t_glob.dtype != torch.int32 or before.t_glob.numel() != 1:
        raise TypeError(f"{name}: state.t_glob must be a 0-d int32 "
                        f"tensor")


def _launch(name, symbol, args, device):
    from cyclistsocialforce_tpu_torch.ops import _build

    lib = _build.library()
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        # every instance takes a pointer to its argument struct, the
        # device and the stream, and returns an error code
        fn.argtypes, fn.restype = [_P, _I, _P], _I
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ctypes.byref(args), device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"({_build.error_string(lib, rc)})")


def agent_pre_ref(engine, state, npad: int) -> PreStep:
    """Plain version of agent_pre: the engine's destination force (the
    destination-queue update, the navigation FSM, the straight-line or
    the spline force), an inactive row's FSM fields held as
    `Engine.finish_step` holds them, and the pair packs, padded to `npad`
    rows."""
    fdx, fdy, st = engine.destination_forces(state)
    act = state.active
    st = st.replace(**{f: torch.where(
        act.reshape((-1,) + (1,) * (getattr(st, f).ndim - 1)),
        getattr(st, f), getattr(state, f)) for f in _CHANGED})
    src_pack, recv_pack = engine.pack_pair_fields(st, npad)
    return PreStep(fdx, fdy, st, src_pack, recv_pack)


def _post_ref(engine, before, pre: PreStep, frx, fry, unchanged):
    """The pair stage's sums (frx, fry) [n] clamped to the destination
    force's magnitude and added to it, the model's step on the state
    agent_pre set, and the engine's bookkeeping against the pre-step state
    `before`: (state, fx, fy), the fields `unchanged` `before`'s own
    tensors and the destination and FSM fields `pre.state`'s (equal in
    value: agent_pre held the inactive rows')."""
    fx, fy = F.clamp_add_dest(frx, fry, pre.fdx, pre.fdy)
    new = engine.dynamics(pre.state, fx, fy)
    out = engine.finish_step(before, new)
    return out.replace(**{f: getattr(before, f) for f in unchanged},
                       **{f: getattr(pre.state, f) for f in _CHANGED}), fx, fy


def agent_post_ref(engine, before, pre: PreStep, frx, fry):
    """Plain version of agent_post: the clamp, bicycle2d's (or the twod
    model's) step and the bookkeeping (`_post_ref`). Returns (state, fx,
    fy) with the applied forces, as `Engine.step_with_forces`; as the
    kernel returns them, the fields that no step changes (`UNCHANGED`) are
    `before`'s own tensors."""
    return _post_ref(engine, before, pre, frx, fry, UNCHANGED)


def agent_post_whipple_ref(engine, before, pre: PreStep, frx, fry):
    """Plain version of agent_post_whipple: the clamp, the balancing
    rider's step and the bookkeeping (`_post_ref`), the fields that it
    does not change (`UNCHANGED_WHIPPLE`) `before`'s own tensors."""
    return _post_ref(engine, before, pre, frx, fry, UNCHANGED_WHIPPLE)


def agent_pre(engine, state, npad: int) -> PreStep:
    """agent_pre: the CUDA kernel on a CUDA state, the plain version on a
    CPU state. The kernel takes a step that takes the per-agent kernels
    (`Engine.agent_kernels`), the state's fields contiguous as
    `make_state` builds them, and npad >= n rows; for the spline
    destination force its spline instance, which also reads the position
    ring."""
    fields = ("s", "dest", "destqueue", "destpointer", "nq", "znav",
              "znavparams", "i", "i_stopsignal", "d_stopsignal", "active",
              "uid")
    if not PF._on_cuda("agent_pre", *(getattr(state, f) for f in fields)):
        return agent_pre_ref(engine, state, npad)
    n, device = state.n, state.device
    params = engine.params
    kernels = _require_fused("agent_pre", engine, state)
    _check_state("agent_pre", state, [f for f in fields if f != "destqueue"])
    dq = state.destqueue
    if (dq.dtype != torch.float32 or dq.ndim != 3 or dq.shape[0] != n
            or dq.shape[2] != 3 or not dq.is_contiguous()):
        raise TypeError("agent_pre: state.destqueue must be a contiguous "
                        "float32 [n, Q, 3] tensor")
    if npad < n:
        raise ValueError(f"agent_pre: npad ({npad}) must be >= n ({n})")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {"fdx": empty(n), "fdy": empty(n), "dest_out": empty(n, 3),
           "ptr_out": empty(n, dtype=torch.int32),
           "znav_out": empty(n, 3, dtype=torch.bool),
           "znavp_out": empty(n, 4),
           "istop_out": empty(n, dtype=torch.int32),
           "dstop_out": empty(n), "src_pack": empty(npad, PF.SRC_COLS),
           "recv_pack": empty(PF.RECV_ROWS, npad)}
    values = _pack_values(params)
    args = _AgentPreArgs(
        *(getattr(state, f).data_ptr() for f in _PRE_IN),
        *(out[f].data_ptr() for f in _PRE_OUT),
        n, npad, dq.shape[1], int(engine.pair_family == "legacy"),
        *(_nav_constants(params)[f] for f in _NAV_CONSTANTS),
        (_PairCol * len(PACK_COLUMNS))(
            *(_pair_col(values[f]) for f in PACK_COLUMNS)))
    symbol = "csf_agent_pre"
    if kernels.dest == "spline":
        _check_ring("agent_pre", state)
        consts = _spline_constants(params)
        args, symbol = _AgentPreSplineArgs(
            args, state.pos_hist.data_ptr(), state.t_glob.data_ptr(),
            state.hist_len, engine.dest_kw["lookback"],
            *(consts[f] for f in _SPLINE_CONSTANTS)), "csf_agent_pre_spline"
    _launch("agent_pre", symbol, args, device)
    PF._count(agent_pre)
    st = state.replace(
        dest=out["dest_out"], destpointer=out["ptr_out"],
        znav=out["znav_out"], znavparams=out["znavp_out"],
        i_stopsignal=out["istop_out"], d_stopsignal=out["dstop_out"])
    return PreStep(out["fdx"], out["fdy"], st, out["src_pack"],
                   out["recv_pack"])


def agent_post(engine, before, pre: PreStep, frx, fry):
    """agent_post: the CUDA kernel on a CUDA state, the plain version on a
    CPU state; arguments and result as `agent_post_ref`. The kernel (or
    its twod instance, which reads agent_pre's FSM state) takes what
    agent_pre takes and returns fresh tensors for the fields it
    changes (`s`, `pid_e`, `pid_i`, `i`, `t_glob`, `pos_hist`: the ring
    copied and one slot written); the destination and FSM fields are
    `pre.state`'s, the others (`UNCHANGED`) `before`'s own."""
    tensors = [before.s, before.pos_hist, pre.fdx, pre.state.dest, frx, fry]
    if not PF._on_cuda("agent_post", *tensors):
        return agent_post_ref(engine, before, pre, frx, fry)
    n = before.n
    kernels = _require_fused("agent_post", engine, before,
                             ("agent_post", "agent_post_twod"))
    _check_state("agent_post", before,
                 ("s", "pid_e", "pid_i", "i", "active", "nq"))
    _check_state("agent_post", pre.state, ("dest", "destpointer"))
    _check_post_inputs("agent_post", before, pre, frx, fry)

    new = {f: torch.empty_like(getattr(before, f))
           for f in ("s", "pid_e", "pid_i", "i", "t_glob", "pos_hist")}
    fx, fy = torch.empty_like(frx), torch.empty_like(fry)
    inputs = {**{f: getattr(before, f) for f in
                 ("s", "pid_e", "pid_i", "i", "t_glob", "pos_hist",
                  "active", "nq")},
              "dest_a": pre.state.dest,
              "destpointer_a": pre.state.destpointer,
              "fdx": pre.fdx, "fdy": pre.fdy, "frx": frx, "fry": fry}
    outputs = {f + "_out": new[f] for f in new}
    outputs["t_out"] = outputs.pop("t_glob_out")
    outputs.update(fx=fx, fy=fy)
    consts = _model_constants(engine.params)
    args = _AgentPostArgs(
        *(inputs[f].data_ptr() for f in _POST_IN),
        *(outputs[f].data_ptr() for f in _POST_OUT),
        n, before.hist_len, *(consts[f] for f in _MODEL_CONSTANTS))
    if kernels.post == "agent_post_twod":
        _check_state("agent_post", pre.state, ("znav",))
        # the twod instance moves the ring's (x, y) slots as float2
        if before.pos_hist.data_ptr() % 8:
            raise ValueError("agent_post: the twod instance takes a position "
                             "ring aligned to 8 bytes")
        args = _AgentPostTwodArgs(args, pre.state.znav.data_ptr())
    _launch("agent_post", "csf_" + kernels.post, args, before.device)
    PF._count(agent_post)
    return before.replace(**new, **{f: getattr(pre.state, f)
                                    for f in _CHANGED}), fx, fy


def agent_post_whipple(engine, before, pre: PreStep, frx, fry):
    """agent_post_whipple: the CUDA kernel on a CUDA state, the plain
    version on a CPU state; arguments and result as
    `agent_post_whipple_ref`. The kernel takes what agent_pre takes, where
    the model declares it (`models.balancingrider.agent_kernels`), and
    returns fresh tensors for the fields it changes (`s`, `dyn_x`,
    `dyn_v`, `dyn_gains`, `i`, `t_glob`, `pos_hist`: the ring copied and
    one slot written); the destination and FSM fields are `pre.state`'s,
    the others (`UNCHANGED_WHIPPLE`) `before`'s own."""
    tensors = [before.s, before.pos_hist, pre.fdx, frx, fry]
    if not PF._on_cuda("agent_post_whipple", *tensors):
        return agent_post_whipple_ref(engine, before, pre, frx, fry)
    name = "agent_post_whipple"
    _require_fused(name, engine, before, ("agent_post_whipple",))
    _check_state(name, before, ("s", "dyn_x", "dyn_v", "i", "active"))
    _check_post_inputs(name, before, pre, frx, fry)
    dg = before.dyn_gains
    if (dg.dtype != torch.float32 or dg.ndim != 2 or dg.shape[0] != before.n
            or dg.shape[1] < 5 or not dg.is_contiguous()):
        raise TypeError(f"{name}: state.dyn_gains must be a contiguous "
                        f"float32 [n, >= 5] tensor")
    # the kept constants are in the state's dtype on its device
    # (`balancingrider.step_constants`); the fit's matrix is read through
    # its strides
    c = engine.kept_constants(engine.step_constants, engine.params,
                              before)["constants"]
    coeffs = c["gains_coeffs"]
    if any(c[k].shape != shape or not c[k].is_contiguous() for k, shape in
           (("A0", (5, 5)), ("A1", (5, 5)), ("A2", (5, 5)), ("B", (5,)))):
        raise TypeError(f"{name}: A0, A1 and A2 must be contiguous [5, 5] "
                        f"tensors and B a contiguous [5] one")

    new = {f: torch.empty_like(getattr(before, f)) for f in
           ("s", "dyn_x", "dyn_v", "dyn_gains", "i", "t_glob", "pos_hist")}
    fx, fy = torch.empty_like(frx), torch.empty_like(fry)
    inputs = {**{f: getattr(before, f) for f in _WPOST_IN[:8]},
              "fdx": pre.fdx, "fdy": pre.fdy, "frx": frx, "fry": fry,
              **{k: c[k] for k in _WPOST_IN[12:]}}
    outputs = {f + "_out": new[f] for f in new}
    outputs["t_out"] = outputs.pop("t_glob_out")
    outputs.update(fx=fx, fy=fy)
    consts = _whipple_constants(engine.params)
    args = _AgentPostWhippleArgs(
        *(inputs[f].data_ptr() for f in _WPOST_IN),
        *(outputs[f].data_ptr() for f in _WPOST_OUT),
        before.n, before.hist_len, dg.shape[1], coeffs.shape[0] // 5,
        coeffs.shape[1], *coeffs.stride(),
        *(consts[f] for f in _WHIPPLE_CONSTANTS))
    _launch(name, "csf_agent_post_whipple", args, before.device)
    PF._count(agent_post_whipple)
    return before.replace(**new, **{f: getattr(pre.state, f)
                                    for f in _CHANGED}), fx, fy


# the wrapper of each post instance (`AgentKernels.post`)
POST_KERNELS = {"agent_post": agent_post, "agent_post_twod": agent_post,
                "agent_post_whipple": agent_post_whipple}

# launches since the last reset and launches recorded into CUDA-graph
# captures, as `ops.pair_forces` counts its kernels'
KERNELS = (agent_pre, agent_post, agent_post_whipple)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.captured = 0
