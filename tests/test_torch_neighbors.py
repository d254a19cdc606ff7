"""PyTorch port: the cell sort, block boxes and neighbor-block table held
to the JAX package (`ops/neighbors.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu.ops import neighbors as JNB  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import neighbors as TNB  # noqa: E402

torch.set_num_threads(1)


def positions(n, side, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-side, side, n).astype(dtype)
    y = rng.uniform(-side, side, n).astype(dtype)
    return x, y


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cell_keys_and_perm_match_jax(dtype):
    x, y = positions(4096, 220.0, 1, dtype)
    # ties: duplicated agents share a key; the stable sort keeps order
    x[100:110] = x[7]
    y[100:110] = y[7]
    for cell in (54.0, 20.0):
        jk = np.asarray(JNB.cell_keys(jnp.asarray(x), jnp.asarray(y), cell))
        tk = TNB.cell_keys(torch.from_numpy(x), torch.from_numpy(y),
                           cell).numpy()
        np.testing.assert_array_equal(tk, jk)
        jp = np.asarray(JNB.sort_by_cell(jnp.asarray(x), jnp.asarray(y),
                                         cell))
        tp = TNB.sort_by_cell(torch.from_numpy(x), torch.from_numpy(y),
                              cell).numpy()
        np.testing.assert_array_equal(tp, jp)


def test_block_bboxes_and_distances_match_jax():
    x, y = positions(1024, 150.0, 2)
    for block in (128, 64):
        jb = JNB.block_bboxes(jnp.asarray(x), jnp.asarray(y), block)
        tb = TNB.block_bboxes(torch.from_numpy(x), torch.from_numpy(y),
                              block)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(
            TNB.bbox_distance2(tb, tb).numpy(),
            np.asarray(JNB.bbox_distance2(jb, jb)))


def _build_both(x, y, cutoff, block, kb, block_src):
    jr = [np.asarray(a) for a in JNB.build(
        jnp.asarray(x), jnp.asarray(y), cutoff, block, kb,
        block_src=block_src)]
    tr = [a.numpy() for a in TNB.build(
        torch.from_numpy(x), torch.from_numpy(y), cutoff, block, kb,
        block_src=block_src)]
    return jr, tr


def assert_tables_match(jr, tr):
    """perm and overflow equal; per receiver row the VALID source blocks
    equal as sets (the order among blocks at equal box distance, e.g.
    overlapping boxes at d2 = 0, is unspecified across frameworks), and
    the valid entries a prefix of the row."""
    np.testing.assert_array_equal(tr[0], jr[0])
    np.testing.assert_array_equal(tr[3], jr[3])
    np.testing.assert_array_equal(tr[2], jr[2])
    assert tr[1].dtype == np.int32
    for row in range(tr[1].shape[0]):
        v = tr[2][row]
        assert set(tr[1][row][v]) == set(jr[1][row][jr[2][row]]), row
        k = int(v.sum())
        assert v[:k].all() and not v[k:].any(), row


@pytest.mark.parametrize("block,block_src,kb,cutoff", [
    (128, 64, 19, 54.0),       # the main path's table (cutoff + skin)
    (128, 128, 12, 54.0),
    (64, 32, 80, 80.0),
    (128, 64, 200, 1e4),       # capacity above the block count
])
def test_neighbor_table_matches_jax_as_sets(block, block_src, kb, cutoff):
    x, y = positions(1024 * 3, 190.0, 4)
    jr, tr = _build_both(x, y, cutoff, block, kb, block_src)
    assert not jr[3].any()
    assert_tables_match(jr, tr)


def test_overflow_flag_raised_with_small_kb():
    x, y = positions(2048, 120.0, 6)
    jr, tr = _build_both(x, y, 54.0, 128, 4, 64)
    assert tr[3].any() and tr[2].all()
    assert_tables_match(jr, tr)
    # the kept blocks are the closest ones
    jb = TNB.block_bboxes(*(torch.from_numpy(a)[torch.from_numpy(tr[0])]
                            for a in (x, y)), 128)
    sb = TNB.block_bboxes(*(torch.from_numpy(a)[torch.from_numpy(tr[0])]
                            for a in (x, y)), 64)
    d2 = TNB.bbox_distance2(jb, sb).numpy()
    for row in np.nonzero(tr[3])[0]:
        kept = d2[row, tr[1][row]]
        dropped = np.delete(d2[row], tr[1][row])
        assert kept.max() <= dropped.min()


def test_padded_population_table_matches_jax():
    """A population padded up to the block with rows parked at agent 0
    (as the engine pads it) clumps those rows in one cell."""
    x, y = positions(1000, 112.0, 7)
    x = np.concatenate([x, np.full(24, x[0])])
    y = np.concatenate([y, np.full(24, y[0])])
    jr, tr = _build_both(x, y, 54.0, 128, 16, 64)
    assert_tables_match(jr, tr)
