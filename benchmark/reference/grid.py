"""Ordered pairs of riders within a radius, found through a uniform grid of
cells one radius wide: each rider's candidates are the riders of the 3 x 3
cells around its own. Plain PyTorch; the reference's pair stage and the
roofline's pair count both use it."""

from __future__ import annotations

import torch

# receivers whose candidates are gathered at a time (bounds memory)
RECEIVER_BLOCK = 8192


def _cells(x, y, size):
    """Each point's cell (cx, cy), the grid's shape, and a [cells + 1, cmax]
    table of the points in each cell (-1 padded; the last row, empty,
    stands for the cells outside the grid)."""
    cx = torch.floor((x - x.min()) / size).long()
    cy = torch.floor((y - y.min()) / size).long()
    ncx, ncy = int(cx.max()) + 1, int(cy.max()) + 1
    cell = cx * ncy + cy
    order = torch.argsort(cell)
    counts = torch.bincount(cell, minlength=ncx * ncy)
    start = torch.cumsum(counts, 0) - counts
    cs = cell[order]
    slot = torch.arange(cell.numel(), device=x.device) - start[cs]
    table = torch.full((ncx * ncy + 1, int(counts.max())), -1,
                       dtype=torch.long, device=x.device)
    table[cs, slot] = order
    return cx, cy, ncx, ncy, table


def pairs_within(x, y, radius: float, mask):
    """Yield (receiver, source) index tensors of every ordered pair of
    distinct riders of `mask` whose distance is below `radius`, in blocks
    of receivers. Distances are taken in float64 whatever the positions'
    dtype. A rider whose position is not finite is in no pair (a state
    that a reference in a low precision, the control, has blown up)."""
    finite = torch.isfinite(x) & torch.isfinite(y)
    idx = torch.nonzero(mask & finite).squeeze(1)
    if idx.numel() == 0:
        return
    xa, ya = x[idx].double(), y[idx].double()
    cx, cy, ncx, ncy, table = _cells(xa, ya, float(radius))
    offsets = [(ox, oy) for ox in (-1, 0, 1) for oy in (-1, 0, 1)]
    r2 = float(radius) ** 2
    m = idx.numel()
    for lo in range(0, m, RECEIVER_BLOCK):
        r = torch.arange(lo, min(lo + RECEIVER_BLOCK, m), device=x.device)
        cells = []
        for ox, oy in offsets:
            gx, gy = cx[r] + ox, cy[r] + oy
            inside = (gx >= 0) & (gx < ncx) & (gy >= 0) & (gy < ncy)
            cells.append(torch.where(inside, gx * ncy + gy, ncx * ncy))
        cand = table[torch.stack(cells, dim=1)].reshape(r.numel(), -1)
        recv = r[:, None].expand_as(cand)
        src = cand.clamp(min=0)
        dx, dy = xa[src] - xa[recv], ya[src] - ya[recv]
        keep = (cand >= 0) & (cand != recv) & (dx * dx + dy * dy < r2)
        yield idx[recv[keep]], idx[src[keep]]


def count_pairs_within(x, y, radius: float, mask) -> int:
    """The number of ordered pairs `pairs_within` yields."""
    return sum(int(r.numel()) for r, _ in pairs_within(x, y, radius, mask))
