"""Unrolled small linear systems, batched over leading axes.

Counterpart of `cyclistsocialforce_tpu.ops.smallmat.solve_small`: Gaussian
elimination written out over the static matrix size, each step one
elementwise operation over the batch. It is branchless: a singular or
degenerate system gives non-finite values and never raises (so the spline
fits can route such agents to their straight-line fallback), which is why
it is not `torch.linalg.solve` (that raises on a singular matrix on the
CPU). The matrix exponential of the JAX module comes with the model that
needs it.
"""

from __future__ import annotations

import torch

__all__ = ["solve_small"]


def solve_small(A, b, pivot: bool = True):
    """Solve A x = b by unrolled Gaussian elimination. A: [..., n, n];
    b: [..., n] or [..., n, m]; returns x shaped like b.

    pivot=True selects the pivot branchlessly (the largest |A[i, k]| for
    i >= k, the first of equals, as `jnp.argmax` takes it) and swaps rows
    through one-hot selects; pivot=False eliminates in order, for systems
    that eliminate stably so (the spline moment systems). The operations
    are those of the JAX function, in its order."""
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    bb = b[..., None] if vec else b
    M = torch.cat([A, bb], dim=-1)                        # [..., n, n + m]
    rows = torch.arange(n, device=A.device)

    for k in range(n):
        if pivot:
            col = torch.where(rows >= k, torch.abs(M[..., :, k]), -1.0)
            p = torch.argmax(col, dim=-1)
            oh_p = (rows == p[..., None])[..., None]
            oh_k = (rows == k)[:, None]
            row_p = torch.sum(torch.where(oh_p, M, 0.0), dim=-2)
            row_k = torch.sum(torch.where(oh_k, M, 0.0), dim=-2)
            M = torch.where(oh_k, row_p[..., None, :],
                            torch.where(oh_p, row_k[..., None, :], M))
        # eliminate below the pivot (static row index k)
        factors = torch.where(rows > k, M[..., :, k] / M[..., k:k + 1, k],
                              0.0)
        M = M - factors[..., None] * M[..., k:k + 1, :]

    # back substitution over static indices
    xs = [None] * n
    for i in reversed(range(n)):
        acc = M[..., i, n:]
        for j in range(i + 1, n):
            acc = acc - M[..., i, j:j + 1] * xs[j]
        xs[i] = acc / M[..., i, i:i + 1]
    x = torch.stack(xs, dim=-2)                           # [..., n, m]
    return x[..., 0] if vec else x
