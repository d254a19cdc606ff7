"""Controller primitives of the PyTorch port (counterpart of
`cyclistsocialforce_tpu.ops.control`; only the PID step is ported so far)."""

from __future__ import annotations


def pid_step(e, e_prev, i_prev, kp, ki, kd, dt):
    """One PID step (reference dynamics.py:33-54), with its derivative
    sign convention d = kd * (e_prev - e) / dt and the integral using the
    NEW error. Returns (out, e, i_new)."""
    d = kd * (e_prev - e) / dt
    i_new = i_prev + ki * e * dt
    out = kp * e + i_new + d
    return out, e, i_new
