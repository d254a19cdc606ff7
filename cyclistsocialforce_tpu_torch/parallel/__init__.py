"""Agent-axis sharding of one crowd over a mesh of shards (counterpart of
`cyclistsocialforce_tpu.parallel`); the dry runs are in `dryrun`."""

from cyclistsocialforce_tpu_torch.parallel.sharding import (
    AGENT_AXIS,
    Mesh,
    gather_state,
    make_mesh,
    required_halo,
    shard_state,
    sharded_simulate_fn,
    sharded_step_fn,
    state_pspecs,
)

__all__ = [
    "AGENT_AXIS",
    "Mesh",
    "gather_state",
    "make_mesh",
    "required_halo",
    "shard_state",
    "sharded_simulate_fn",
    "sharded_step_fn",
    "state_pspecs",
]
