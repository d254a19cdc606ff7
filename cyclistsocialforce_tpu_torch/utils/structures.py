"""Small numerical structures: difference equations, complex angles, FIFO
ring buffers.

Counterpart of `cyclistsocialforce_tpu.utils.structures` (reference
utils.py:292-614): pure functions over explicit state tuples, the pattern
of `ops.control.pid_step`. The functions that make tensors from host
values (`diffeq_init`, `angle_from_euler`, `fifo_init`) take `dtype` and
`device` and, like the package's other entry points, default to the card;
every other function computes where its inputs lie.
"""

from __future__ import annotations

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.utils.angles import limit_angle, thresh

# ---- difference equation y(k) = (1/a0)(b.u_hist - a[1:].y_hist)
# (reference DiffEquation, utils.py:292-441)


def diffeq_init(a, b, y0=None, u0=None, dtype=torch.float64,
                device="cuda"):
    """State for `diffeq_step`: (a, b, y_hist [m], u_hist [n])."""
    def vec(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=device)

    a, b = vec(a), vec(b)
    m = a.shape[0] - 1
    n = b.shape[0]
    y = torch.zeros(m, dtype=dtype, device=device) if y0 is None else vec(y0)
    u = torch.zeros(n, dtype=dtype, device=device)
    if u0 is not None:
        u[1:] = vec(u0)[:n - 1]
    return a, b, y, u


def diffeq_step(state, u_k, th=None):
    """One step of the LTI difference equation; returns (state, y_k).

    y(k) = (1/a0) (b0 u(k) + ... + bn u(k-n) - a1 y(k-1) - ... - am y(k-m))
    with optional symmetric output saturation `th` (reference
    utils.py:292-340)."""
    a, b, y_hist, u_hist = state
    u_k = torch.as_tensor(u_k, dtype=a.dtype, device=a.device)
    u_hist = torch.cat([u_k.reshape(1), u_hist[:-1]])
    y_k = (torch.dot(b, u_hist) - torch.dot(a[1:], y_hist)) / a[0]
    if th is not None:
        y_k = thresh(y_k, (-th, th))
    y_hist = torch.cat([y_k.reshape(1), y_hist[:-1]])
    return (a, b, y_hist, u_hist), y_k


# ---- complex-number angle representation (reference Angle,
# utils.py:443-578)


def angle_from_euler(theta, deg=False, dtype=torch.float64, device="cuda"):
    """Angle as a complex unit vector cos + j sin (elementwise)."""
    theta = torch.as_tensor(theta, dtype=dtype, device=device)
    if deg:
        theta = torch.deg2rad(theta)
    return torch.complex(torch.cos(theta), torch.sin(theta))


def angle_to_euler(z, deg=False):
    """Complex unit vector to its angle in (-pi, pi] (elementwise)."""
    theta = limit_angle(torch.angle(z))
    return torch.rad2deg(theta) if deg else theta


def angle_add(z1, z2):
    """Compose rotations: the product of the unit vectors."""
    return z1 * z2


def angle_difference_complex(z1, z2):
    """Signed difference angle(z2) - angle(z1), from conj(z1) z2."""
    return torch.angle(torch.conj(z1) * z2)


# ---- fixed-length FIFO ring buffer (reference FIFOBuffer,
# utils.py:580-614)


def fifo_init(initial_values, dtype=torch.float64, device="cuda"):
    """State for `fifo_next`: (buffer [L, ...], head index)."""
    buf = torch.as_tensor(np.asarray(initial_values), dtype=dtype,
                          device=device)
    return buf, torch.zeros((), dtype=torch.int32, device=device)


def fifo_next(state, value_in):
    """Push `value_in`; returns ((buffer, head), oldest value). The O(1)
    ring form of the reference's deque (`AgentState.pos_hist` is the
    same pattern at population scale). Out of place, and the head indexes
    on the device: nothing is read back to the host."""
    buf, head = state
    idx = head.reshape(1).long()
    value_out = buf.index_select(0, idx)[0]
    value_in = torch.as_tensor(value_in, dtype=buf.dtype, device=buf.device)
    buf = buf.index_copy(0, idx, value_in.reshape((1,) + buf.shape[1:]))
    head = (head + 1) % buf.shape[0]
    return (buf, head), value_out


def validate_boolean_indicators(features, indicator_name, data_name,
                                n_features):
    """Validate a feature selector: a bool mask of length `n_features` or
    int indices within [0, n_features) (reference
    utils.validate_boolean_indicators, utils.py:230-292). Returns the
    selector as a numpy bool mask; raises ValueError naming
    `indicator_name` and `data_name` otherwise."""
    arr = np.asarray(features)
    if arr.dtype == bool:
        if arr.ndim == 1 and arr.size == n_features:
            return arr
        raise ValueError(
            f"Boolean indicator '{indicator_name}' must have the same "
            f"number of elements as {data_name} has features "
            f"({n_features}); got {arr.size}.")
    if np.issubdtype(arr.dtype, np.integer):
        if arr.ndim == 1 and arr.size and np.all(
                (arr >= 0) & (arr < n_features)):
            mask = np.zeros(n_features, dtype=bool)
            mask[arr] = True
            return mask
        raise ValueError(
            f"Integer indicator '{indicator_name}' for {data_name} must "
            f"hold indices in [0, {n_features}); got {arr!r}.")
    raise ValueError(
        f"Indicator '{indicator_name}' must be bool (length "
        f"{n_features}) or int indices in [0, {n_features}); got dtype "
        f"{arr.dtype}.")
