"""Population builders of the PyTorch port."""

from __future__ import annotations

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.models import bicycle2d
from cyclistsocialforce_tpu_torch.state import AgentState, make_state


def build_population(n_agents: int, density=None, hist_len: int = 128,
                     pad_to_block=None, dtype=torch.float32,
                     device="cuda") -> AgentState:
    """Random bicycle2d crowd, drawn exactly as the JAX package's
    `__graft_entry__._build` draws it (numpy `default_rng(0)`, the same
    draws in the same order: positions, heading, speed, destinations).

    density : agents/m^2, uniform over a square; None gives the legacy
        1.5 sqrt(N) box (an extreme crowd).
    pad_to_block : round the population up to a multiple of this block
        with INACTIVE pad agents (they emit no force and stay frozen).
    """
    n_pad = 0
    if pad_to_block:
        n_pad = -(-n_agents // pad_to_block) * pad_to_block - n_agents
    n = n_agents + n_pad

    rng = np.random.default_rng(0)
    s0 = np.zeros((n, 5))
    if density is not None:
        side = 0.5 * float(np.sqrt(n_agents / density))
    else:
        side = max(10.0, 1.5 * np.sqrt(n_agents))
    s0[:, 0] = rng.uniform(-side, side, n)
    s0[:, 1] = rng.uniform(-side, side, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1.0, 6.0, n)
    state = make_state(s0, dtype=dtype, hist_len=hist_len, model=bicycle2d,
                       device=device)

    dests = np.zeros((n, 3))
    dests[:, 0] = rng.uniform(-side, side, n)
    dests[:, 1] = rng.uniform(-side, side, n)
    dests = torch.as_tensor(dests, dtype=dtype, device=device)
    destqueue = state.destqueue.clone()
    destqueue[:, 0, :] = dests
    active = torch.ones((n,), dtype=torch.bool, device=device)
    active[n_agents:] = False
    return state.replace(destqueue=destqueue, dest=dests,
                         nq=torch.ones((n,), dtype=torch.int32,
                                       device=device),
                         active=active)
