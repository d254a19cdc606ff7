"""The riders' random streams, written from the published algorithms in
plain PyTorch on int64 words (each holding an unsigned 32-bit value),
for any batch of keys at once. Nothing here imports the program or JAX.

- Threefry-2x32 with 20 rounds (Salmon, Moraes, Dror and Shaw,
  "Parallel random numbers: as easy as 1, 2, 3", SC 2011): a 64-bit
  counter block encrypted under a 64-bit key, its key schedule the two
  key words and their XOR with 0x1BD11BDA, injected before the first
  round and after every fourth.
- On top of it, JAX's key derivation in its partitionable form: the key
  of seed s is the words (s >> 32, s & 0xFFFFFFFF); `fold_in(k, d)` is
  the block (0, d) under k; `split(k)[i]` is `fold_in(k, i)`; the bits of
  a draw of some shape are, at each row-major flat index c, the block
  (c >> 32, c & 0xFFFFFFFF) under the key, its two words XORed for 32
  bits or joined high word first for 64.
- A rider's stream: `fold_in(fold_in(fold_in(key, salt), t_glob), uid)`,
  so that its draws depend on the global step and on its identity, not
  on its row.
- The uniform on [lo, hi): the top mantissa bits of the draw (32 bits
  >> 9 for float32, 64 >> 12 for float64) under the exponent of 1.0,
  minus 1, then scaled, shifted and clamped below at lo, in the draw's
  dtype.
- The normal: sqrt(2) erfinv(u), u uniform on (nextafter(-1, 0), 1). In
  float32 erfinv is Giles' single-precision polynomial as published
  (M. Giles, "Approximating the erfinv function", GPU Computing Gems
  Jade Edition, 2011), its w = -log((1 - x)(1 + x)) taken as
  -log1p(-x^2): the paper's product loses up to ~130 float32 ulps of the
  result near |x| = 1. In float64 erfinv is `torch.erfinv`, where XLA
  evaluates a polynomial of its own: a float64 normal differs from JAX's
  by about 1e-12 of itself, a float32 one at most in its last bits.

The draws are made in the dtype the caller names, which is the
configuration's (float32 in the cells): a float64 draw of the same bits
is another number. The reference promotes a float32 draw to its own
dtype afterwards, where JAX would keep computing in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
# the rotation of each of the eight rounds that repeat (Threefry-2x32)
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
ROUNDS = 20
KEY_PARITY = 0x1BD11BDA
# the exponent bits of 1.0 and the mantissa width, per float dtype
_ONE = {torch.float32: (0x3F800000, 23), torch.float64:
        (0x3FF0000000000000, 52)}
_NP = {torch.float32: np.float32, torch.float64: np.float64}
# Giles' single-precision erfinv: the polynomials in w - 2.5 (w < 5) and
# in sqrt(w) - 3, highest degree first
_GILES32_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_GILES32_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key, c0, c1):
    """The two output words of the counter block (c0, c1) under the keys
    `key` [..., 2], broadcast against each other (int64 tensors of 32-bit
    words, or Python ints for the counter)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ KEY_PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for r in range(ROUNDS):
        rot = ROTATIONS[r % 8]
        x0 = (x0 + x1) & MASK
        x1 = (((x1 << rot) & MASK) | (x1 >> (32 - rot))) ^ x0
        if r % 4 == 3:
            j = r // 4 + 1
            x0 = (x0 + ks[j % 3]) & MASK
            x1 = (x1 + ks[(j + 1) % 3] + j) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """JAX's `PRNGKey(seed)`: [2] int64."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key, data) -> torch.Tensor:
    """The keys [..., 2] with `data` (an int or an integer tensor,
    broadcast) folded in."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    y0, y1 = threefry2x32(key, 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """`num` keys from each key [..., 2]: [..., num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], i)


def stream(key, t_glob, uid, salt: int) -> torch.Tensor:
    """The riders' keys [len(uid), 2] at global step `t_glob` (a 0-d
    tensor or an int) under the call site's `salt`."""
    return fold_in(fold_in(fold_in(key, salt), t_glob), uid)


def _blocks(key, shape):
    """The two words at every flat index of `shape` under each key of the
    batch [..., 2]: two [..., *shape] tensors."""
    shape = tuple(int(s) for s in shape)
    c = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key.device)
    w0, w1 = threefry2x32(key[..., None, :], c >> 32, c & MASK)
    return (w0.reshape(key.shape[:-1] + shape),
            w1.reshape(key.shape[:-1] + shape))


def bits32(key, shape) -> torch.Tensor:
    """32 random bits per element of `shape`, per key: [..., *shape]."""
    w0, w1 = _blocks(key, shape)
    return w0 ^ w1


def uniform(key, shape, dtype=torch.float32, lo=0.0,
            hi=1.0) -> torch.Tensor:
    """Uniform draws on [lo, hi) of `dtype` (float32 or float64) per key
    of the batch [..., 2]: [..., *shape]. lo and hi are rounded to
    `dtype` first."""
    one, nmant = _ONE[dtype]
    if dtype == torch.float64:
        w0, w1 = _blocks(key, shape)
        # the top 52 bits of the 64-bit draw w0 << 32 | w1
        mant = (w0 << (nmant - 32)) | (w1 >> (64 - nmant))
        x = (mant | one).view(torch.float64) - 1.0
    else:
        mant = bits32(key, shape) >> (32 - nmant)
        x = (mant | one).to(torch.int32).view(torch.float32) - 1.0
    lo_d, hi_d = _NP[dtype](lo), _NP[dtype](hi)
    return torch.clamp_min(x * float(hi_d - lo_d) + float(lo_d), float(lo_d))


def _horner(coeffs, w):
    p = torch.full_like(w, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        p = p * w + float(np.float32(c))
    return p


def erfinv32(x) -> torch.Tensor:
    """Giles' single-precision erfinv of float32 x in (-1, 1)."""
    w = -torch.log1p(-(x * x))
    low = w < 5.0
    p = torch.where(low, _horner(_GILES32_LOW, w - 2.5),
                    _horner(_GILES32_HIGH, torch.sqrt(w) - 3.0))
    return p * x


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of `dtype` per key of the batch [..., 2]:
    [..., *shape]."""
    npd = _NP[dtype]
    u = uniform(key, shape, dtype, np.nextafter(npd(-1.0), npd(0.0)), 1.0)
    e = erfinv32(u) if dtype == torch.float32 else torch.erfinv(u)
    return e * float(npd(math.sqrt(2.0)))
