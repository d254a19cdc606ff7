"""Conversion between the JAX package's pytrees and the port's dataclasses.

Both directions go through numpy: JAX leaves are read with `np.asarray`,
so this module (like the rest of the package) never imports JAX, and a
test can hand the same inputs to both packages.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.params import (PARAM_CLASSES,
                                                 PARAM_DICT_FIELDS,
                                                 param_dict, to_leaf)
from cyclistsocialforce_tpu_torch.state import AgentState


def state_from_jax(st, device="cuda") -> AgentState:
    """The port's AgentState holding the values of a JAX AgentState; the
    master key's two uint32 words become int64."""
    def leaf(name):
        a = np.array(getattr(st, name))
        return torch.from_numpy(a.astype(np.int64) if name == "key" else a)

    return AgentState(**{f.name: leaf(f.name).to(device)
                         for f in dataclasses.fields(AgentState)})


def state_to_numpy(st: AgentState) -> dict:
    """{field: numpy array} of a port AgentState, for comparisons."""
    return {f.name: getattr(st, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(AgentState)}


def _leaf_from_jax(cls, name, value, device):
    """One JAX params field in the port's leaf form (`params.to_leaf`): None
    stays None, a static tuple or flag (`ip_zoh_poly`, `br_gains_poly`,
    `stochastic_control_behavior`) the same object, a static array (the
    balancing rider's `br_A0`) nested tuples of floats, a
    population-shared table (`ip_zoh_lut`, `br_gains_lut`: table, v_lo,
    dv) a float64 tensor on `device` with its two floats, and a per-rider
    pole set (the JAX population's tuple of [N] arrays) an [N, k]
    tensor, and an external model's parameter dict (`rep_force`,
    `dest_force`, whose values JAX's `as_population` broadcasts per
    agent) a dict of floats."""
    if value is None:
        return value
    if name in PARAM_DICT_FIELDS:
        return param_dict(name, {k: np.asarray(v) for k, v in value.items()})
    if name == "polemodel_rt":
        return polemodel_rt_from_jax(value)
    if name in getattr(cls, "STATIC_FIELDS", ()):
        if isinstance(value, (tuple, bool, int, float)):
            return value
        return to_leaf(name, np.asarray(value))
    if name in getattr(cls, "POPULATION_SHARED", ()):
        tab, v_lo, dv = value
        return (torch.from_numpy(np.array(tab, dtype=np.float64)).to(device),
                float(v_lo), float(dv))
    if isinstance(value, (tuple, list)) and any(np.ndim(v) for v in value):
        value = np.stack([np.asarray(v) for v in value], axis=-1)
    leaf = to_leaf(name, np.asarray(value))
    return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf


def polemodel_rt_from_jax(rt):
    """The port's `behavior.PoleModelRT` (float64, on the CPU; a step
    places it) of a JAX `PoleModelRT`."""
    from cyclistsocialforce_tpu_torch.behavior import PoleModelRT

    return PoleModelRT.from_arrays(
        *(None if getattr(rt, f) is None else np.asarray(getattr(rt, f))
          for f in ("means", "cov_chol", "covariances", "weights", "lambdas",
                    "scaler_mean", "scaler_scale", "log_a", "log_sign")),
        log_features=rt.log_features, idx_given=rt.idx_given,
        n_features=rt.n_features)


def road_from_jax(road, device="cuda"):
    """The port's `engine.RoadElements` (float64 on `device`) of a JAX
    `RoadElements`, a shared F_0 or sigma broadcast per vertex."""
    from cyclistsocialforce_tpu_torch.engine import RoadElements

    def leaf(name, shape):
        a = np.asarray(getattr(road, name), dtype=np.float64)
        return torch.from_numpy(np.broadcast_to(a, shape).copy()).to(device)

    n = np.shape(road.weights)
    return RoadElements(leaf("vertices", n + (2,)), leaf("weights", n),
                        leaf("F_0", n), leaf("sigma", n))


def scripted_from_jax(sc, device="cuda"):
    """The port's `engine.ScriptedTraj` (the trajectories in their dtype)
    on `device` of a JAX `ScriptedTraj`."""
    from cyclistsocialforce_tpu_torch.engine import ScriptedTraj

    return ScriptedTraj(*(torch.from_numpy(np.array(getattr(sc, f))).to(
        device) for f in ("traj", "mask", "length")))


def params_from_jax(p, device="cuda"):
    """The port's params of the same class and values as a JAX
    `VehicleParams` / `CarParams` / `BicycleParams` /
    `PlanarPointBicycleParams` / `PlanarBicycleParams` /
    `InvPendulumBicycleParams` / `BalancingRiderParams` /
    `HessBikeRiderParams` (no re-validation), their tables and fits
    included, and the balancing rider's pole model (`PoleModelRT`). Per-agent leaves become float64 (poles complex128) tensors
    on `device`."""
    name = type(p).__name__
    if name not in PARAM_CLASSES:
        raise NotImplementedError(f"params class {name} is not ported")
    cls = PARAM_CLASSES[name]
    return cls(**{f.name: _leaf_from_jax(cls, f.name, getattr(p, f.name),
                                         device)
                  for f in dataclasses.fields(cls)})


def group_specs_from_jax(mixed_engine, device="cuda") -> list:
    """The port's `MixedEngine.create` group specs, (model module, params,
    n_agents) per group, of a JAX `MixedEngine`: each group's model is the
    port's module of the same name as the module of its step function,
    its params go through `params_from_jax`."""
    from cyclistsocialforce_tpu_torch.models import MODELS

    by_name = {m.__name__.rsplit(".", 1)[-1]: m for m in MODELS.values()}
    specs = []
    for g in mixed_engine.groups:
        name = g.model_step.__module__.rsplit(".", 1)[-1]
        if name not in by_name:
            raise NotImplementedError(f"model module {name} is not ported")
        specs.append((by_name[name], params_from_jax(g.params, device),
                      int(g.hi) - int(g.lo)))
    return specs


def gmm_from_jax(gmm):
    """The port's `behavior.GMMData` of a JAX `GMMData` (numpy on both
    sides)."""
    from cyclistsocialforce_tpu_torch.behavior import GMMData

    return GMMData(np.array(gmm.means), np.array(gmm.covariances),
                   np.array(gmm.weights))


def polemodel_from_jax(pm):
    """The port's `behavior.PoleModel` of a JAX `PoleModel`: its feature
    set, mixture, metadata and `Preprocessing` (every array copied)."""
    from cyclistsocialforce_tpu_torch.behavior import PoleModel, Preprocessing

    src = pm.preprocessing
    pre = Preprocessing(n_features=int(src.n_features))
    for f in ("lambdas", "scaler_mean", "scaler_scale", "log_a", "log_sign",
              "log_features"):
        value = getattr(src, f)
        setattr(pre, f, None if value is None else np.array(value))
    pre.n_samples_seen = int(src.n_samples_seen)
    return PoleModel(feature_set=pm.feature_set, gmm=gmm_from_jax(pm.gmm),
                     preprocessing=pre, metadata=copy.deepcopy(pm.metadata))


def calibration_data_from_jax(data):
    """The port's `calibration.CalibrationData` of a JAX
    `CalibrationData`."""
    from cyclistsocialforce_tpu_torch.calibration import CalibrationData

    return CalibrationData(np.array(data.s0), np.array(data.inputs),
                           np.array(data.objectives), np.array(data.lengths))
