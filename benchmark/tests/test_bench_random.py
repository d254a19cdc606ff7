"""The reference's random streams (`reference/random.py`) against the
published known answers of Threefry-2x32 and against the program's draws
(`cyclistsocialforce_tpu_torch.ops.random`, which follows JAX's) on the
CPU: the keys, the bits and the uniforms bit for bit, the normals within
a stated bound. The reference itself imports nothing of the program."""

import numpy as np
import pytest
import torch

from benchmark.reference import random as R
from cyclistsocialforce_tpu_torch.ops import random as P
from cyclistsocialforce_tpu_torch.state import agent_streams

# Random123's known answers for threefry2x32 with 20 rounds:
# (key words, counter words, output words)
KNOWN = [((0x0, 0x0), (0x0, 0x0), (0x6B200159, 0x99BA4EFE)),
         ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
          (0x1CB996FC, 0xBB002BE7)),
         ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
          (0xC4923A9C, 0x483DF7A0))]
SEEDS = [0, 12345, 2 ** 33 + 7]
# float32 normals: the reference's erfinv is Giles' polynomial as
# published, the program's XLA's writing of the same polynomial. Both
# round every operation in float32 in the same order here, but a
# compiler may fuse a multiply and an add on either side, which moves
# the last bit of a Horner step; four ulps leave room for that.
NORMAL32_ULPS = 4
# float64 normals: `torch.erfinv` against XLA's own float64 polynomial,
# which differ by about 1e-12 of the value in the tails
NORMAL64_REL = 1e-11


@pytest.mark.parametrize("known", KNOWN)
def test_threefry_known_answers(known):
    key, ctr, out = known
    got = R.threefry2x32(torch.tensor(key, dtype=torch.int64), *ctr)
    assert tuple(int(w) for w in got) == out


def streams(seed, n=20000, t=917, salt=2):
    uid = torch.arange(n, dtype=torch.int32)
    tg = torch.tensor(t, dtype=torch.int32)
    return (R.stream(R.prng_key(seed), tg, uid, salt),
            agent_streams(P.key(seed, "cpu"), tg, uid, salt))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_bit_for_bit(seed):
    assert torch.equal(R.prng_key(seed), P.key(seed, "cpu"))
    ours, theirs = streams(seed)
    assert torch.equal(ours, theirs)
    assert torch.equal(R.split(ours), P.split(theirs))
    assert torch.equal(R.fold_in(ours, 77), P.fold_in(theirs, 77))
    assert torch.equal(R.bits32(ours, (8,)), P.bits32(theirs, (8,)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_for_bit(seed, dtype):
    ours, theirs = streams(seed)
    assert torch.equal(R.uniform(ours, (8,), dtype),
                       P.uniform(theirs, (8,), dtype))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    assert torch.equal(R.uniform(ours, (3, 5), dtype, lo, 1.0),
                       P.uniform(theirs, (3, 5), dtype, lo, 1.0))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_float32_within_ulps(seed):
    ours, theirs = streams(seed)
    a = R.normal(ours, (8, 5), torch.float32)
    b = P.normal(theirs, (8, 5), torch.float32)
    ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= NORMAL32_ULPS
    # the tails are drawn too: the bound holds past 4 sigma
    assert float(b.abs().max()) > 4.0


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_float64_within_bound(seed):
    ours, theirs = streams(seed)
    a = R.normal(ours, (8, 5), torch.float64)
    b = P.normal(theirs, (8, 5), torch.float64)
    assert float(((a - b).abs() / b.abs()).max()) < NORMAL64_REL


def test_float64_draw_of_the_same_bits_differs():
    """What the reference's docstring says: the dtype of a draw is part
    of it (a float32 draw takes the two words XORed, a float64 one the
    words joined), so the reference draws in the configuration's."""
    ours, _ = streams(0, n=1000)
    u32 = R.uniform(ours, (8,), torch.float32).double()
    u64 = R.uniform(ours, (8,), torch.float64)
    assert float((u32 - u64).abs().mean()) > 0.1
