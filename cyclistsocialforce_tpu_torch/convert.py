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


def params_from_jax(p, device="cuda"):
    """The port's params of the same class and values as a JAX
    `VehicleParams` / `CarParams` / `BicycleParams` (no re-validation). Per-agent
    leaves become float64 tensors on `device`."""
    name = type(p).__name__
    if name not in PARAM_CLASSES:
        raise NotImplementedError(f"params class {name} is not ported")
    cls = PARAM_CLASSES[name]
    vals = {}
    for f in dataclasses.fields(cls):
        leaf = to_leaf(f.name, np.asarray(getattr(p, f.name)))
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(device)
        vals[f.name] = leaf
    return cls(**vals)
