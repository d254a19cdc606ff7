"""Unrolled small-matrix linear algebra, batched over leading axes.

Counterpart of `cyclistsocialforce_tpu.ops.smallmat`: products, Gaussian
elimination and the matrix exponential written out over the static matrix
size, each step one elementwise operation over the batch. Everything is
branchless: a singular or degenerate system gives non-finite values and
never raises (so the spline fits can route such agents to their
straight-line fallback), and nothing reads a value back to the host (so a
CUDA graph can capture it). That is why it is not `torch.linalg.solve`
(which checks its result on the host, and raises on a singular matrix on
the CPU), nor a batched `torch.matmul` (which TF32 may round on the card).
"""

from __future__ import annotations

import torch

__all__ = ["matmul_small", "matvec_small", "solve_small", "expm_small"]


def matmul_small(A, B):
    """[..., n, k] @ [..., k, m] as a broadcast multiply and a sum over k
    (elementwise work: no TF32 on the card, whatever the caller set)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def matvec_small(A, x):
    """[..., n, k] @ [..., k] as a broadcast multiply and a sum over k."""
    return torch.sum(A * x[..., None, :], dim=-1)


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


# Pade-13 coefficients (the scipy/jax expm numerator/denominator split)
_PADE13_B = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0)

# Pade-13 accuracy threshold theta_13 (Higham 2005, double precision)
_THETA13 = 5.371920351148152


def expm_small(A, max_squarings: int = 12):
    """Matrix exponential of small [..., n, n] matrices: norm-adaptive
    scaling, the Pade-13 approximant and `solve_small`.

    Each matrix takes its own squaring count s = clip(ceil(log2(||A||_1 /
    theta_13)), 0, max_squarings), and all `max_squarings` squarings run,
    each masked to the matrices whose count it is within: the operations
    are the same whatever the data (no host read, a fixed shape), and a
    small-norm matrix (the ZOH matrices, ||A t_s|| ~ 0.05-0.5) takes no
    squaring, which would amplify float32 rounding."""
    n = A.shape[-1]
    b = _PADE13_B
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    norm1 = torch.amax(torch.sum(torch.abs(A), dim=-2), dim=-1)
    # norm <= theta -> log2 <= 0 -> s = 0; norm = 0 -> -inf -> s = 0
    s = torch.clamp(torch.ceil(torch.log2(norm1 / _THETA13)), 0,
                    max_squarings)
    As = A * torch.exp2(-s)[..., None, None]
    A2 = matmul_small(As, As)
    A4 = matmul_small(A2, A2)
    A6 = matmul_small(A2, A4)
    U = matmul_small(
        As, matmul_small(A6, b[13] * A6 + b[11] * A4 + b[9] * A2)
        + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (matmul_small(A6, b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    E = solve_small(V - U, V + U)
    for i in range(max_squarings):
        E = torch.where((i < s)[..., None, None], matmul_small(E, E), E)
    return E
