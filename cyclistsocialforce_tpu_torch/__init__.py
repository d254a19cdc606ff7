"""PyTorch and CUDA port of the cyclist social-force simulation.

Counterpart of `cyclistsocialforce_tpu` (JAX, Pallas, TPU) for one NVIDIA
H100. This slice covers the culled main path: the bicycle2d model with
the straight-line destination force and navigation FSM, and the BMD2023
"twod" repulsive field summed over a block-sparse neighbor table by a
hand-written CUDA kernel (`ops/pair_forces.py`, `csrc/pair_forces.cu`).
The package imports torch and never JAX.
"""

from cyclistsocialforce_tpu_torch import engine, params, state
from cyclistsocialforce_tpu_torch.engine import Engine, NeighborConfig
from cyclistsocialforce_tpu_torch.state import AgentState, make_state

__all__ = [
    "AgentState",
    "Engine",
    "NeighborConfig",
    "engine",
    "make_state",
    "params",
    "state",
]
