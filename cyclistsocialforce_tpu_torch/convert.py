"""Conversion between the JAX package's pytrees and the port's dataclasses.

Both directions go through numpy: JAX leaves are read with `np.asarray`,
so this module (like the rest of the package) never imports JAX, and a
test can hand the same inputs to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.params import PARAM_CLASSES, to_leaf
from cyclistsocialforce_tpu_torch.state import AgentState


def state_from_jax(st, device="cuda") -> AgentState:
    """The port's AgentState holding the values of a JAX AgentState (the
    JAX-only `key` field is dropped)."""
    return AgentState(**{
        f.name: torch.from_numpy(np.array(getattr(st, f.name))).to(device)
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
    tensor."""
    if value is None:
        return value
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


def params_from_jax(p, device="cuda"):
    """The port's params of the same class and values as a JAX
    `VehicleParams` / `CarParams` / `BicycleParams` /
    `PlanarPointBicycleParams` / `PlanarBicycleParams` /
    `InvPendulumBicycleParams` / `BalancingRiderParams` /
    `HessBikeRiderParams` (no re-validation), their tables and fits
    included. Per-agent leaves become float64 (poles complex128) tensors
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
