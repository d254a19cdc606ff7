"""The least the per-agent kernels (`agent_pre`, `agent_post`,
`csrc/agent_step.cu`) move in the profiled steps: the bytes each needs,
every input read once and every output written once (a copy of the
arithmetic of `chip_smoke.agent_step_bytes`). Their float32 operations
bound them about 25 times lower, so bytes set the bound.

agent_pre reads the state fields of the destination update and the FSM
(the queue entry at each row's pointer and, where the queue has one, the
next) and the uid, and writes the FSM fields, the force and the pair
packs (16 + 8 floats a row). agent_post reads the pre-step state, its pid
memories and step counter, the activity flag, both forces and the
position ring but the slot it writes; for an active row also agent_pre's
destination, pointer and the queue length; and writes the new state, the
ring, the counter and the applied force.
"""

from benchmark.peaks import HBM_BYTES_PER_S


def bytes_per_step(rows: int, n_active: int, n_next: int, hist: int) -> int:
    pre = rows * (16 + 12 + 4 + 4 + 3 + 16 + 4 + 4 + 4 + 1
                  + 8 + 12 + 4 + 3 + 16 + 4 + 4)
    pre += 12 * (rows + n_next) + rows * (16 + 8) * 4
    post = (rows * (32 + 8 + 8 + 4 + 1 + 16 + 8 * (hist - 1))
            + n_active * (8 + 4 + 4)
            + rows * (32 + 8 + 8 + 4 + 8 * hist + 8) + 8)
    return pre + post


def bound_seconds(ctx):
    """Least seconds of the profiled steps' two kernels on one H100."""
    return (ctx["steps"] * bytes_per_step(ctx["rows"], ctx["n_active"],
                                          ctx["n_next"], ctx["hist_len"])
            / HBM_BYTES_PER_S)
