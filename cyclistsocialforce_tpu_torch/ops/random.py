"""Counter-based random numbers: the `jax.random` calls of the JAX package,
drawn bit for bit as JAX draws them.

JAX's default generator is threefry-2x32 in its "partitionable" form: a
key is a pair of 32-bit words, and every draw is one threefry-2x32 of the
key and a 64-bit counter split into (hi, lo) words:

- `fold_in(k, d)` is threefry(k, (0, d));
- `split(k)[i]` is the same as `fold_in(k, i)`;
- `uniform` over a shape takes, at each row-major flat index c, the two
  words of threefry(k, (c >> 32, c & 0xFFFFFFFF)): `w0 ^ w1` for 32-bit
  floats, `w0 << 32 | w1` for 64-bit ones, through the mantissa
  construction (the top mantissa bits of the word under the exponent of
  1.0, minus 1, scaled and clamped to `minval`);
- `normal` is sqrt(2) erfinv(uniform(nextafter(-1, 0), 1)).

Words are int64 tensors holding uint32 values (every operation masked
with 0xFFFFFFFF), not `torch.uint32`, whose op coverage on CUDA is
partial. A key is a [..., 2] tensor: every function takes a batch of
keys, so a per-agent `vmap` of the JAX package becomes one broadcast
pass. Plain PyTorch, the same on the CPU and the card. Nothing here reads
a value back to the host or copies one to the device (scalars enter as
Python numbers), so a CUDA graph captures it.

`normal` takes XLA's erfinv (`erfinv`, its polynomials and, in float64,
its log1p written out): `torch.special.erfinv` is the more accurate one,
and differs from XLA's by up to ~90 float32 ulps and ~1.5e-12 relative
in float64 in the tails of 200,000 draws, more than the streams may
differ. What is left is XLA's fused multiply-adds: the port's normals
are within 3 float32 ulps and 1e-15 in float64 of JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the exponent of 1.0 and the mantissa bits under it, per float type
_FLOAT_BITS = {torch.float32: (0x3F800000, 23), torch.float64:
               (0x3FF0000000000000, 52)}
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of key words (k0, k1) and counter words
    (x0, x1), broadcast against each other: int64 tensors holding uint32
    words, or Python ints for the counter. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device="cuda") -> torch.Tensor:
    """The key `jax.random.PRNGKey(seed)`: [seed >> 32, seed & 0xFFFFFFFF]
    as a [2] int64 tensor."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def _word(data):
    """A 32-bit word: a Python int, or an integer tensor as int64."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & MASK
    return int(data) & MASK


def fold_in(key, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for keys [..., 2] and data an int
    or an integer tensor, broadcast: [..., 2]."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, _word(data))
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for keys [..., 2]: [..., num, 2]."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], idx)


def _words(key, shape):
    """The two threefry words at every flat index of `shape` under each
    key of the batch [..., 2]: two [..., *shape] tensors."""
    shape = tuple(int(s) for s in shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=key.device)
    w0, w1 = threefry2x32(key[..., 0, None], key[..., 1, None], count >> 32,
                          count & MASK)
    batch = key.shape[:-1]
    return w0.reshape(batch + shape), w1.reshape(batch + shape)


def bits32(key, shape) -> torch.Tensor:
    """JAX's 32 random bits per element of `shape` (int64 tensor holding
    uint32 values), per key of the batch [..., 2]."""
    w0, w1 = _words(key, shape)
    return w0 ^ w1


def bits64(key, shape) -> torch.Tensor:
    """JAX's 64 random bits per element, as the two int64 words (hi, lo)
    of each (a 64-bit unsigned value does not fit torch.int64)."""
    return _words(key, shape)


def uniform(key, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)` per key of
    the batch [..., 2]: [..., *shape] of float32 or float64, bit for bit
    (minval and maxval numbers, rounded to `dtype` first as JAX does)."""
    one, nmant = _FLOAT_BITS[dtype]
    if dtype == torch.float64:
        hi, lo = bits64(key, shape)
        # the top 52 bits of hi << 32 | lo
        mant = (hi << (nmant - 32)) | (lo >> (64 - nmant))
        floats = (mant | one).view(torch.float64) - 1.0
    else:
        mant = bits32(key, shape) >> (32 - nmant)
        floats = (mant | one).to(torch.int32).view(torch.float32) - 1.0
    npt = _NUMPY[dtype]
    lo_v, hi_v = npt(minval), npt(maxval)
    scaled = floats * float(hi_v - lo_v) + float(lo_v)
    return torch.clamp_min(scaled, float(lo_v))


# XLA's erfinv (its CHLO legalization; M. Giles, "Approximating the
# erfinv function"): a polynomial in w = -log1p(-x^2) shifted, one set of
# coefficients per range of w, highest degree first
_ERFINV32 = (5.0, 2.5, 3.0, (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682)))
_ERFINV64_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


# XLA's float64 log1p (Cephes): below |x| = sqrt(2) - 1 a rational
# approximation, x - x^2 / 2 + x^3 P(x) / Q(x), highest degree first;
# above it log(1 + x)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p64(x):
    """log1p as XLA computes it in float64 (`torch.log1p` differs from it
    by up to 1.4e-14 on [-1, 0], which erfinv's w carries)."""
    xx = x * x
    small = _horner(_LOG1P_P, x, x.dtype) / _horner(_LOG1P_Q, x, x.dtype)
    small = x + (-0.5 * xx + (x * xx) * small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def _horner(coeffs, w, dtype):
    npt = _NUMPY[dtype]
    p = torch.full_like(w, float(npt(coeffs[0])))
    for c in coeffs[1:]:
        p = p * w + float(npt(c))
    return p


def erfinv(x) -> torch.Tensor:
    """erfinv as XLA computes it (float32 or float64 `x` in [-1, 1]), the
    same operations in the same order: every range's polynomial is
    evaluated and the range of each element selects one. In float64 its
    log1p is XLA's too (`_log1p64`)."""
    if x.dtype == torch.float32:
        w = -torch.log1p(x * -x)
        edge, shift_lo, shift_hi, (c_lo, c_hi) = _ERFINV32
        lo = w < edge
        p = torch.where(lo, _horner(c_lo, w - shift_lo, x.dtype),
                        _horner(c_hi, torch.sqrt(w) - shift_hi, x.dtype))
    else:
        w = -_log1p64(x * -x)
        root = torch.sqrt(w)
        p = torch.where(
            w < 6.25, _horner(_ERFINV64_LT_6_25, w - 3.125, x.dtype),
            torch.where(w < 16.0,
                        _horner(_ERFINV64_LT_16, root - 3.25, x.dtype),
                        _horner(_ERFINV64_GE_16, root - 5.0, x.dtype)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` per key of the batch
    [..., 2]: sqrt(2) erfinv of a uniform draw on (nextafter(-1, 0), 1),
    through XLA's erfinv (`erfinv`)."""
    npt = _NUMPY[dtype]
    lo = np.nextafter(npt(-1.0), npt(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    return erfinv(u) * float(npt(np.sqrt(2)))


def choice_index(key, p_cumsum) -> torch.Tensor:
    """`jax.random.choice(key, K, p=p)` per key of the batch [..., 2] from
    the cumulative weights `p_cumsum` [..., K]: the first index whose
    cumulative weight reaches total (1 - u), u a uniform draw."""
    u = uniform(key, (), p_cumsum.dtype)
    r = p_cumsum[..., -1] * (1.0 - u)
    return torch.searchsorted(p_cumsum.contiguous(),
                              r[..., None].contiguous())[..., 0]


def randint(key, shape, minval, maxval, dtype=torch.int64) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, dtype)` per key of
    the batch [..., 2], bit for bit, for int32 and int64 (`minval`,
    `maxval` ints or integer tensors broadcast against the batch and
    `shape`): two draws of nbits random bits from `split(key)`, higher
    and lower, and minval + ((higher % span) * (2^nbits % span) + lower %
    span) % span, span = maxval - minval (1 where maxval <= minval), in
    unsigned nbits arithmetic. int64 spans must stay below 2^31, where
    that arithmetic fits an int64 exactly."""
    if dtype not in (torch.int32, torch.int64):
        raise TypeError(f"randint takes int32 or int64, got {dtype}")
    shape = tuple(int(s) for s in shape)
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    info = torch.iinfo(dtype)
    # the bounds converted to dtype by clipping, maxval's excess noted
    # (JAX's _convert_and_clip_integer)
    over = hi > info.max
    lo = lo.clamp(info.min, info.max)
    hi = hi.clamp(info.min, info.max)
    span = torch.where(hi <= lo, 1, hi - lo)
    span = torch.where(over & (hi > lo), span + 1, span)
    k1, k2 = split(key).unbind(-2)
    if dtype == torch.int32:
        if bool((span >= 1 << 32).any()):
            raise ValueError("randint in int32 takes spans below 2^32")
        higher, lower = bits32(k1, shape), bits32(k2, shape)
        half = 65536 % span
        mult = ((half * half) & MASK) % span
        off = ((higher % span) * mult) & MASK
        off = ((off + lower % span) & MASK) % span
        return (lo + off).to(dtype)
    if bool((span >= 1 << 31).any()):
        raise ValueError("randint in int64 takes spans below 2^31")
    two32 = (1 << 32) % span

    def rem64(words):
        # (hi << 32 | lo) % span of the two 32-bit words of a 64-bit draw
        return ((words[0] % span) * two32 + words[1] % span) % span

    mult = two32 * two32 % span
    off = (rem64(bits64(k1, shape)) * mult + rem64(bits64(k2, shape))) \
        % span
    return lo + off


def gumbel(key, shape, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, dtype)` in its default "low" mode
    per key of the batch [..., 2]: -log(-log(u)), u the uniform draw on
    [tiny, 1) (bit for bit in float64, where 1 - tiny rounds to 1)."""
    tiny = float(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0)))


def categorical(key, logits) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis, per key
    of the batch [..., 2] (broadcast against logits [..., K]): the
    argmax of a Gumbel draw of the logits' shape plus the logits (the
    first index of a tie, as JAX's argmax; -inf logits are never taken
    while one is finite). Returns int64 indices [...]."""
    k = logits.shape[-1]
    g = gumbel(key, (k,), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


__all__ = ["MASK", "bits32", "bits64", "categorical", "choice_index",
           "fold_in", "gumbel", "key", "erfinv", "normal", "randint",
           "split", "threefry2x32", "uniform"]
