from cyclistsocialforce_tpu_torch.ops import (control, forces, navigation,
                                             neighbors, pair_forces)

__all__ = ["control", "forces", "navigation", "neighbors", "pair_forces"]
