"""PyTorch and CUDA port of the cyclist social-force simulation.

Counterpart of `cyclistsocialforce_tpu` (JAX, Pallas, TPU) for one NVIDIA
H100: the seven models (the balancing rider's stochastic behavior
included, on JAX's random streams), `MixedEngine`, the road, scripted
agents (`engine.ScriptedTraj`), and both repulsive fields summed densely
or over a block-sparse neighbor table by hand-written CUDA kernels
(`ops/pair_forces.py`, `csrc/`); the Kaths external model through the
engine's force hooks (`external.py`), the scenario runner with its
checkpoints (`scenario.py`) and the runtime checks (`diagnostics.py`);
the SUMO co-simulation (`sumo`), GMM fitting (`gmm_fit.py`) and the pole
models (`behavior.py`), calibration against observed tracks
(`calibration.py`) and the drawings and field plots (`viz.py`). The
package imports torch and never JAX; matplotlib, PyYAML and OpenCV are
imported only by the functions that draw, read YAML or write video.
"""

from cyclistsocialforce_tpu_torch import (calibration, engine, gmm_fit,
                                          params, state, sumo, viz)
from cyclistsocialforce_tpu_torch.engine import Engine, NeighborConfig
from cyclistsocialforce_tpu_torch.state import AgentState, make_state

__all__ = [
    "AgentState",
    "Engine",
    "NeighborConfig",
    "calibration",
    "engine",
    "gmm_fit",
    "make_state",
    "params",
    "state",
    "sumo",
    "viz",
]
