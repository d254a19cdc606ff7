"""Share of the profiled sub-window, from its first host call to its last
event, in which nothing runs on the device."""

UNIT = "%"
LAYER = "device"
MOVES = "agent_steps_per_s"


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_us"] / ctx["window_us"])
