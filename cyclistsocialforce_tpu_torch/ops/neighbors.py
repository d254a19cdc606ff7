"""Spatial culling for the pairwise force stage (PyTorch port of
`cyclistsocialforce_tpu.ops.neighbors`).

Agents are sorted by a serpentine spatial cell key, the sorted population
is cut into contiguous blocks with axis-aligned bounding boxes, and each
receiver block gets a fixed-width table of the source blocks whose boxes
lie within the cutoff, closest first. The table feeds the pair kernel
(`ops.pair_forces`). Overflow (more in-range blocks than the capacity
`kb`) drops the farthest blocks and is flagged per receiver block.
"""

from __future__ import annotations

import torch

BIG = 3.4e38


def cell_keys(x, y, cell_size):
    """int32 serpentine cell key per agent: column-major over columns of
    width cell_size snapped up so an integer number of columns tiles the
    x-span, with odd columns' y-order reversed and y resolved to 2^15
    levels within a column (see the JAX counterpart for the measurements
    behind each choice)."""
    xmin = torch.min(x)
    ymin = torch.min(y)
    xspan = torch.clamp(torch.max(x) - xmin, min=1e-9)
    yspan = torch.clamp(torch.max(y) - ymin, min=1e-9)
    ncols = torch.clamp(torch.floor(xspan / cell_size), min=1.0)
    eff = xspan / ncols
    m = 1 << 15
    ix = torch.clamp(torch.floor((x - xmin) / eff).to(torch.int32),
                     min=0)
    ix = torch.minimum(ix, ncols.to(torch.int32) - 1)
    iy = torch.clamp(((y - ymin) / yspan * m).to(torch.int32), 0, m - 1)
    iy = torch.where(ix % 2 == 0, iy, m - 1 - iy)
    return ix * m + iy


def sort_by_cell(x, y, cell_size):
    """Stable permutation sorting agents by cell key; [N] int64."""
    return torch.argsort(cell_keys(x, y, cell_size), stable=True)


def block_bboxes(xs, ys, block: int):
    """[B, 4] (xmin, ymin, xmax, ymax) of contiguous blocks of `block`
    SORTED agents (N divisible by block)."""
    b = xs.shape[0] // block
    xb = xs.reshape(b, block)
    yb = ys.reshape(b, block)
    return torch.stack([xb.amin(1), yb.amin(1), xb.amax(1), yb.amax(1)],
                       dim=1)


def bbox_distance2(boxes_a, boxes_b):
    """[A, B] squared distances between box perimeters (0 if they
    overlap)."""
    dx = torch.clamp(torch.maximum(
        boxes_b[None, :, 0] - boxes_a[:, None, 2],
        boxes_a[:, None, 0] - boxes_b[None, :, 2]), min=0.0)
    dy = torch.clamp(torch.maximum(
        boxes_b[None, :, 1] - boxes_a[:, None, 3],
        boxes_a[:, None, 1] - boxes_b[None, :, 3]), min=0.0)
    return dx * dx + dy * dy


def neighbor_block_table(bboxes, cutoff, kb: int, src_bboxes=None,
                         chunk: int = 0):
    """Fixed-width neighbor-block table.

    Returns (nbr [B, KB] int32, valid [B, KB] bool, overflow [B] bool):
    for each receiver block the up-to-KB source blocks within `cutoff`
    (box to box), CLOSEST FIRST, so the valid entries of a row are a
    prefix; invalid entries hold source block 0. Among blocks at equal
    distance (overlapping boxes, d2 = 0) the order is unspecified.

    chunk : receiver rows built at a time (0: all at once). The dense form
        holds the [B, B_src] box-distance matrix, ~8 GB at N = 4e6;
        chunking bounds it to [chunk, B_src] with the same test and the
        same closest-first selection per row, so the same table."""
    if src_bboxes is None:
        src_bboxes = bboxes

    def per_rows(boxes_r):
        d2 = bbox_distance2(boxes_r, src_bboxes)
        within = d2 <= cutoff * cutoff
        neg = torch.where(within, -d2, -BIG)
        k_eff = min(kb, neg.shape[1])
        dneg, order = torch.topk(neg, k_eff, dim=1, largest=True,
                                 sorted=True)
        order = order.to(torch.int32)
        valid = dneg > -BIG
        if k_eff < kb:
            pad = (neg.shape[0], kb - k_eff)
            order = torch.cat([order, order.new_zeros(pad)], dim=1)
            valid = torch.cat([valid, valid.new_zeros(pad)], dim=1)
        overflow = torch.sum(within, dim=1) > kb
        return torch.where(valid, order, 0), valid, overflow

    b = bboxes.shape[0]
    if not chunk or chunk >= b:
        return per_rows(bboxes)
    parts = [per_rows(bboxes[lo:lo + chunk]) for lo in range(0, b, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def build(x, y, cutoff, block: int, kb: int, cell_size=None,
          block_src: int = 0, table_chunk: int = 0):
    """One-call neighbor structure (perm, nbr, valid, overflow).

    perm sorts agents by cell; nbr/valid index SORTED blocks: receiver
    blocks of `block` agents, source blocks of `block_src` (0: same as
    `block`; must divide it). N must be divisible by `block`.
    `table_chunk` bounds the table build's memory
    (`neighbor_block_table`)."""
    if cell_size is None:
        cell_size = cutoff
    block_src = block_src or block
    perm = sort_by_cell(x, y, cell_size)
    xs, ys = x[perm], y[perm]
    boxes = block_bboxes(xs, ys, block)
    src_boxes = (boxes if block_src == block
                 else block_bboxes(xs, ys, block_src))
    nbr, valid, overflow = neighbor_block_table(boxes, cutoff, kb,
                                                src_bboxes=src_boxes,
                                                chunk=table_chunk)
    return perm, nbr, valid, overflow
