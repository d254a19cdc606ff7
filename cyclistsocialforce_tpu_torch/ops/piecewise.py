"""Piecewise-polynomial tabulation of smooth speed schedules
(counterpart of `cyclistsocialforce_tpu.ops.piecewise`).

A schedule (the inverted-pendulum ZOH propagator's 30 entries, a gain
polynomial) is fitted once, on the host, as a piecewise polynomial over a
uniform speed-segment grid, and evaluated per step without a table gather:
a segment one-hot and a Horner chain. Out-of-band speeds clamp to the band
edge.

Layout (the JAX package's): the fit returns ``(coeffs, lo, seg_dv)``,
``coeffs[s][(deg+1)*m + d]`` the degree-``d`` coefficient of output ``m``
on segment ``s`` in the local coordinate u = (v - lo)/seg_dv - s in
[0, 1], ascending degree. It is a tuple of Python floats: a static
parameter, never a tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def fit_piecewise_poly(sample_fn, lo, hi, n_seg, deg=5, per_seg=129):
    """Per-segment least-squares polynomial fit of a vector-valued map.

    ``sample_fn(vs: np.ndarray [K]) -> np.ndarray [K, M]`` is evaluated on
    ``n_seg * per_seg`` points tiling [lo, hi]; each segment gets an
    independent degree-``deg`` fit in its local coordinate. Raises if the
    sweep contains non-finite values (callers must choose a band clear of
    the schedule's poles). Returns ``(coeffs, lo, seg_dv)`` in the layout
    of the module docstring. numpy only, as the JAX package's."""
    lo, hi = float(lo), float(hi)
    if not hi > lo:
        raise ValueError(f"piecewise fit needs hi > lo (got [{lo}, {hi}])")
    seg_dv = (hi - lo) / n_seg
    u = np.linspace(0.0, 1.0, per_seg)
    A = np.vander(u, deg + 1, increasing=True)
    vs = (lo + seg_dv * (np.arange(n_seg)[:, None] + u[None, :])).reshape(-1)
    Y = np.asarray(sample_fn(vs))
    if not np.isfinite(Y).all():
        raise ValueError(
            "piecewise fit sweep hit non-finite values inside the band "
            f"[{lo}, {hi}] -- raise the lower band edge clear of the "
            "schedule's poles")
    M = Y.shape[-1]
    Y = Y.reshape(n_seg, per_seg, M)
    coeffs = []
    for s in range(n_seg):
        c, *_ = np.linalg.lstsq(A, Y[s], rcond=None)   # [deg+1, M]
        coeffs.append(tuple(float(c[d, m])
                            for m in range(M) for d in range(deg + 1)))
    return (tuple(coeffs), lo, float(seg_dv))


def fit_error(poly, sample_fn, n_probe=1024, band=None):
    """Max relative L2 error of the fit against ``sample_fn`` on a dense
    probe grid (a diagnostic; float64 on the CPU)."""
    C, lo, seg_dv = poly
    lo_p, hi_p = band if band is not None else (lo, lo + len(C) * seg_dv)
    vs = np.linspace(lo_p, hi_p - 1e-9, n_probe)
    Y = np.asarray(sample_fn(vs))
    cols = eval_piecewise_poly(poly, torch.from_numpy(vs), Y.shape[-1])
    Yp = torch.stack(cols, dim=1).numpy()
    num = np.linalg.norm(Yp - Y, axis=1)
    den = np.maximum(np.linalg.norm(Y, axis=1), 1e-30)
    return float((num / den).max())


def coeff_matrix(poly, dtype, device):
    """[n_out * (deg + 1), S] matrix of the fit's coefficients in `dtype`
    on `device`: what `eval_piecewise_poly` selects each speed's column
    from. A copy from the host, which a CUDA-graph capture refuses: a
    caller that steps a fit many times builds it once and passes it in
    (the invpendulum model's `step_constants`, kept by its engine)."""
    cm = torch.tensor(np.asarray(poly[0], dtype=np.float64).T, dtype=dtype)
    return cm.to(device)


def eval_piecewise_poly(poly, v, n_out, coeffs=None):
    """Evaluate the fit at speeds ``v`` [N]; returns a list of ``n_out``
    [N] tensors. ``coeffs``: the fit's `coeff_matrix` (built here when
    None).

    The JAX package's ``"matmul"`` form: the [n_out*(deg+1), S] x [S, N]
    product of the coefficient matrix with the segment one-hot, which
    selects every agent's coefficients (rows of the result are contiguous
    [N] vectors), then a Horner chain. The product is computed as what it
    equals exactly, the selection of each agent's column: no
    `torch.matmul`, so TF32 (which would round the coefficients to a
    10-bit mantissa on the card, if the caller allowed it) cannot touch
    it. (The JAX package's ``"select"`` form waits for a caller.)

    A speed at the band's top edge takes the last segment at u = 1. (The
    JAX function clamps x to S - 1e-6, which float32 rounds to S itself
    once S >= 64: its one-hot is then empty and every output 0 there,
    ROADMAP Queue 3. Here the segment index is clamped as an integer.)"""
    C, lo, seg_dv = poly
    S = len(C)
    D = len(C[0]) // n_out                     # deg + 1
    x = torch.clamp((v - lo) / seg_dv, 0.0, float(S) - 1e-6)
    # an index in range whatever x holds (a NaN speed included)
    seg = torch.clamp(torch.floor(x).long(), 0, S - 1)
    u = x - seg.to(x.dtype)

    if coeffs is None:
        coeffs = coeff_matrix(poly, v.dtype, v.device)
    rows = coeffs.to(v.dtype).index_select(1, seg)   # [n_out * D, N]
    cols = []
    for m in range(n_out):
        acc = rows[D * m + D - 1]
        for d in range(D - 2, -1, -1):
            acc = acc * u + rows[D * m + d]
        cols.append(acc)
    return cols
