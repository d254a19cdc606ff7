"""Population builders of the PyTorch port."""

from __future__ import annotations

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.models import MODELS
from cyclistsocialforce_tpu_torch.state import AgentState, make_state


def build_population(n_agents: int, density=None, hist_len: int = 128,
                     pad_to_block=None, dtype=torch.float32,
                     device="cuda", model="bicycle2d",
                     seed: int = 0) -> AgentState:
    """Random crowd, drawn exactly as the JAX package's
    `__graft_entry__._build(model_name=...)` draws it (numpy
    `default_rng(0)`, the same draws in the same order: positions,
    heading, speed, destinations), sized for `model` (a `models.MODELS`
    name or module) with `make_state(model=...)`.

    density : agents/m^2, uniform over a square; None gives the legacy
        1.5 sqrt(N) box (an extreme crowd).
    hist_len : the position ring's length; the spline destination force
        (twod) needs >= 1/t_s + 1 (128 at t_s = 0.01).
    pad_to_block : round the population up to a multiple of this block
        with INACTIVE pad agents (they emit no force and stay frozen).
    seed : the master random key's (`make_state(seed=)`), which only the
        stochastic models read; the crowd is drawn from `default_rng(0)`.
    """
    if isinstance(model, str):
        model = MODELS[model]
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
    state = make_state(s0, dtype=dtype, hist_len=hist_len, model=model,
                       device=device, seed=seed)

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


def build_flagship_crowd(n_agents: int, density=None, hist_len: int = 8,
                         pad_to_block=None, dtype=torch.float32,
                         device="cuda", model="balancingrider",
                         seed: int = 11) -> AgentState:
    """A crowd the Whipple-family models ride stably, drawn as the JAX
    package's `__graft_entry__._build_flagship` draws it (numpy
    `default_rng(seed)`: positions, headings within +-0.2 rad of +x,
    speeds in 4-6 m/s; the destination 100 m straight ahead), sized for
    `model`, before the model's `prepare`. The positions are uniform over
    an 80 m square, as there, or over the square of `density` agents/m^2;
    `pad_to_block` as for `build_population`."""
    if isinstance(model, str):
        model = MODELS[model]
    n_pad = 0
    if pad_to_block:
        n_pad = -(-n_agents // pad_to_block) * pad_to_block - n_agents
    n = n_agents + n_pad
    side = 80.0 if density is None else float(np.sqrt(n_agents / density))

    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, side, n)
    s0[:, 1] = rng.uniform(0, side, n)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(4, 6, n)
    state = make_state(s0, dtype=dtype, hist_len=hist_len, model=model,
                       device=device)
    dests = torch.as_tensor(np.c_[s0[:, 0] + 100, s0[:, 1], np.zeros(n)],
                            dtype=dtype, device=device)
    destqueue = state.destqueue.clone()
    destqueue[:, 0, :] = dests
    active = torch.ones((n,), dtype=torch.bool, device=device)
    active[n_agents:] = False
    return state.replace(destqueue=destqueue, dest=dests, active=active)


# `bench.py:main_row`'s two stochastic rows: BalancingRiderParams.create
# keywords
STOCHASTIC_ROWS = {
    # budget-compacted resampling at a 4-step cadence
    "stochastic": dict(stochastic_control_behavior=True, gains_poly=16,
                       resample_budget=4096, resample_every=4),
    # the reference's semantics: every needy rider resamples at once
    "stochastic_exact": dict(stochastic_control_behavior=True,
                             gains_poly=16, resample_budget=0,
                             resample_every=1),
}


def stochastic_row(row: str = "stochastic", n_agents: int = 100_000,
                   density=0.02, dtype=torch.float32, device="cuda",
                   seed: int = 0, **create_kw):
    """(engine, state) of `bench.py:main_row(row)` for the two stochastic
    rows (`STOCHASTIC_ROWS`): the bench crowd sized for the balancing
    rider (`build_population`, position ring 8, padded to blocks of 128,
    master key of `seed`) after `prepare`, and the engine on K1's main
    form (cutoff 50 m, block 128, block_src 64, kb 19, unscreened, a
    rebuild every 20 steps). `create_kw` changes the parameters'
    keywords."""
    from cyclistsocialforce_tpu_torch.engine import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import prepare
    from cyclistsocialforce_tpu_torch.params import BalancingRiderParams

    model = MODELS["balancingrider"]
    params = BalancingRiderParams.create(**{**STOCHASTIC_ROWS[row],
                                            **create_kw})
    state = build_population(n_agents, density, 8, 128, dtype, device,
                             model=model, seed=seed)
    cfg = NeighborConfig(cutoff=50.0, block=128, block_src=64, kb=19,
                         rebuild_every=20, screen=False)
    return (Engine.create(params, model, neighbors=cfg),
            prepare(model, params, state))
