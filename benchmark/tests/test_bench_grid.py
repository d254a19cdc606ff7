import pytest
import torch

from benchmark.reference import grid


@pytest.mark.parametrize("seed", [0, 1])
def test_pairs_within_match_brute_force(seed, monkeypatch):
    g = torch.Generator().manual_seed(seed)
    n = 700
    x = torch.rand(n, generator=g, dtype=torch.float64) * 300
    y = torch.rand(n, generator=g, dtype=torch.float64) * 200
    mask = torch.rand(n, generator=g) > 0.1
    # small receiver blocks, so that several blocks are joined
    monkeypatch.setattr(grid, "RECEIVER_BLOCK", 97)
    got = set()
    for r, c in grid.pairs_within(x, y, 25.0, mask):
        got.update(zip(r.tolist(), c.tolist()))
    d2 = (x[:, None] - x[None, :]) ** 2 + (y[:, None] - y[None, :]) ** 2
    want = (d2 < 25.0 ** 2) & mask[:, None] & mask[None, :]
    want.fill_diagonal_(False)
    assert got == set(map(tuple, torch.nonzero(want).tolist()))
    assert grid.count_pairs_within(x, y, 25.0, mask) == int(want.sum())
