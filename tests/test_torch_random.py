"""PyTorch port: the counter-based random streams (`ops.random`) held to
`jax.random` and to the JAX package's `state.agent_streams`.

The threefry-2x32 words, `fold_in`, `split`, `agent_streams` over uids and
salts, and `uniform` in float32 and float64 are bit-equal to JAX's, on
shapes [8] and [8, 5] and on per-agent key batches (with other bounds than
[0, 1) within an ulp of the range: XLA fuses the scale and the shift into
one multiply-add, which the bounds of `normal` leave exact). `normal` goes through
the port's copy of XLA's erfinv (and, in float64, of XLA's log1p): in
float32 within 4 ulps of JAX's draw, in float64 within 1e-15 (what is
left is XLA's fused multiply-adds). `jax.random.choice` with weights
(`choice_index`) picks the same indices. `randint` (int32 and int64) is
bit-equal over 10,000 keys; `gumbel`'s uniform on [tiny, 1) is bit-equal
in both float types, and `categorical` (the argmax of Gumbel draws plus
the logits, -inf entries included) picks the same indices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package's pytrees

import jax.numpy as jnp  # noqa: E402

from cyclistsocialforce_tpu.state import \
    agent_streams as jax_agent_streams  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import random as R  # noqa: E402
from cyclistsocialforce_tpu_torch.state import agent_streams  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 7, 123, 2**32 + 5)
SHAPES = ((8,), (8, 5))
DTYPES = ((jnp.float32, torch.float32), (jnp.float64, torch.float64))


def port_keys(keys):
    """JAX keys (uint32 [..., 2]) as the port's int64 words."""
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def words(t):
    return np.asarray(t).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    """`key(seed)` is `PRNGKey(seed)`; `fold_in` of ints and of int32
    tensors (one key, and a batch of keys) and `split` into 2 and 5 are
    JAX's bit for bit."""
    jk, tk = jax.random.PRNGKey(seed), R.key(seed, "cpu")
    np.testing.assert_array_equal(tk.numpy(), words(jk))
    for d in (0, 1, 3, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(R.fold_in(tk, d).numpy(),
                                      words(jax.random.fold_in(jk, d)))
    data = np.arange(-3, 40, dtype=np.int32)
    want = jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.asarray(data))
    np.testing.assert_array_equal(
        R.fold_in(tk, torch.from_numpy(data)).numpy(), words(want))
    batch = jax.random.split(jk, 6)
    want = jax.vmap(jax.random.fold_in)(batch, jnp.arange(6))
    np.testing.assert_array_equal(
        R.fold_in(port_keys(batch), torch.arange(6)).numpy(), words(want))
    for num in (2, 5):
        np.testing.assert_array_equal(R.split(tk, num).numpy(),
                                      words(jax.random.split(jk, num)))
    np.testing.assert_array_equal(
        R.split(port_keys(batch)).numpy(),
        words(jax.vmap(jax.random.split)(batch)))


def test_threefry_words_match_jax():
    """The raw threefry-2x32 of key and counter words, JAX's primitive."""
    from jax._src import prng

    rng = np.random.default_rng(3)
    k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    t = torch.from_numpy(x.astype(np.int64))
    y0, y1 = R.threefry2x32(int(k[0]), int(k[1]), t[:32], t[32:])
    got = torch.cat([y0, y1]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("salt", [1, 2, 3])
def test_agent_streams_match_jax(salt):
    """`state.agent_streams` of a key, a 0-d int32 clock and int32 uids
    (in any order) is the JAX package's, bit for bit, for each salt."""
    uid = np.random.default_rng(salt).permutation(300).astype(np.int32)
    for seed, t in ((0, 0), (5, 17), (2**32 + 5, 2**31 - 7)):
        want = jax_agent_streams(jax.random.PRNGKey(seed),
                                 jnp.asarray(t, jnp.int32), jnp.asarray(uid),
                                 salt)
        got = agent_streams(R.key(seed, "cpu"),
                            torch.tensor(t, dtype=torch.int32),
                            torch.from_numpy(uid), salt)
        np.testing.assert_array_equal(got.numpy(), words(want))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_uniform_matches_jax(dtypes):
    """`uniform` on [8], [8, 5] and per agent (a vmap over a key batch in
    JAX): bit-equal; on [-2.5, 7) within one ulp of the range (the
    unfused multiply-add)."""
    jd, td = dtypes
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), R.key(seed, "cpu")
        for shape in SHAPES:
            np.testing.assert_array_equal(
                R.uniform(tk, shape, td).numpy(),
                np.asarray(jax.random.uniform(jk, shape, jd)))
            got = R.uniform(tk, shape, td, -2.5, 7.0).numpy()
            want = np.asarray(jax.random.uniform(jk, shape, jd, -2.5, 7.0))
            assert (np.abs(got - want) <= np.spacing(jd(9.5))).all()
        keys = jax.random.split(jk, 40)
        want = jax.vmap(lambda k: jax.random.uniform(k, (8,), jd))(keys)
        np.testing.assert_array_equal(
            R.uniform(port_keys(keys), (8,), td).numpy(), np.asarray(want))
    assert R.uniform(R.key(1, "cpu"), (1000,), td).min() >= 0.0


@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_normal_matches_jax(dtypes):
    """`normal` on [8], [8, 5] and per agent ([40] keys x [8, 5]): float32
    within 4 ulps of JAX's draw, float64 within 1e-15 (module docstring)."""
    jd, td = dtypes
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), R.key(seed, "cpu")
        keys = jax.random.split(jk, 40)
        pairs = [(R.normal(tk, shape, td), jax.random.normal(jk, shape, jd))
                 for shape in SHAPES]
        pairs.append((R.normal(port_keys(keys), (8, 5), td), jax.vmap(
            lambda k: jax.random.normal(k, (8, 5), jd))(keys)))
        for got, want in pairs:
            got, want = got.numpy(), np.asarray(want)
            assert got.shape == want.shape
            if td == torch.float32:
                ulps = np.abs(got - want) / np.spacing(np.abs(want))
                assert ulps.max() <= 4, ulps.max()
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_erfinv_matches_xla(dtypes):
    """The port's erfinv against `jax.scipy.special.erfinv` on [-1, 1]:
    the same infinities at +-1, float32 within 2 ulps, float64 within
    1e-15 relative."""
    jd, td = dtypes
    x = np.linspace(-1.0, 1.0, 20001).astype(jd)
    x = np.concatenate([x, 1 - np.logspace(-7 if jd == jnp.float32 else -16,
                                           -1, 200).astype(jd)])
    got = R.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if td == torch.float32:
        ulps = np.abs(got[fin] - want[fin]) / np.spacing(np.abs(want[fin]))
        assert ulps.max() <= 2, ulps.max()
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-15, atol=0)


def test_choice_index_matches_jax():
    """`choice_index` from cumulative weights draws `jax.random.choice(k,
    K, p=w)`'s index for each key of a batch (weights per key)."""
    keys = jax.random.split(jax.random.PRNGKey(9), 500)
    w = np.random.default_rng(2).dirichlet(np.ones(4), 500)
    want = jax.vmap(lambda k, p: jax.random.choice(k, 4, p=p))(
        keys, jnp.asarray(w))
    got = R.choice_index(port_keys(keys),
                         torch.cumsum(torch.from_numpy(w), dim=-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


N_KEYS = 10_000
RANGES = ((0, 10), (0, 154), (-7, 3), (5, 5), (3, -2), (0, 2**20 + 3),
          (-(2**30), 2**30 - 5))
INT_DTYPES = ((jnp.int32, torch.int32), (jnp.int64, torch.int64))


@pytest.mark.parametrize("dtypes", INT_DTYPES, ids=["int32", "int64"])
def test_randint_matches_jax(dtypes):
    """`randint` over 10,000 keys (scalar draws, the k-means++ seed's
    form) and on shape [8, 5], for spans of 1 to 2^31 and empty ranges
    (maxval <= minval gives minval; int64 spans below 2^31, int32 up to
    2^32 - 1): bit-equal to `jax.random.randint`."""
    jd, td = dtypes
    keys = jax.random.split(jax.random.PRNGKey(11), N_KEYS)
    tk = port_keys(keys)
    for lo, hi in RANGES:
        want = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi, jd))(
            keys)
        got = R.randint(tk, (), lo, hi, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jk = jax.random.PRNGKey(lo & 0xFFFF)
        np.testing.assert_array_equal(
            R.randint(R.key(lo & 0xFFFF, "cpu"), (8, 5), lo, hi, td).numpy(),
            np.asarray(jax.random.randint(jk, (8, 5), lo, hi, jd)))
    if td == torch.int64:
        return
    # int32 spans up to 2^32 - 1, and a maxval past int32's range (the
    # span one larger, as JAX has it)
    want = jax.vmap(lambda k: jax.random.randint(
        k, (), -(2**31), 2**31 - 1, jnp.int32))(keys)
    np.testing.assert_array_equal(
        R.randint(tk, (), -(2**31), 2**31 - 1, torch.int32).numpy(),
        np.asarray(want))
    want = jax.vmap(lambda k: jax.random.randint(k, (), 2**31 - 9, 2**31,
                                                 jnp.int32))(keys)
    np.testing.assert_array_equal(
        R.randint(tk, (), 2**31 - 9, 2**31, torch.int32).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
def test_gumbel_and_categorical_match_jax(dtypes):
    """`gumbel` ("low" mode: -log(-log(u)), u on [tiny, 1)) and
    `categorical` over 10,000 keys, on random logits and on logits with
    -inf entries (k-means++'s log of a zero distance is finite; a row of
    -inf but one entry always takes that entry): the uniforms bit for
    bit, the Gumbel draws within 2 ulps and the indices equal."""
    jd, td = dtypes
    keys = jax.random.split(jax.random.PRNGKey(5), N_KEYS)
    tk = port_keys(keys)
    tiny = float(jnp.finfo(jd).tiny)
    np.testing.assert_array_equal(
        R.uniform(tk, (4,), td, tiny, 1.0).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (4,), jd, tiny, 1.0))(keys)))
    g = R.gumbel(tk, (4,), td).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (4,), jd))(
        keys))
    eps = np.finfo(want.dtype).eps
    np.testing.assert_array_less(np.abs(g - want),
                                 2 * eps * np.maximum(np.abs(want), 1.0))
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (N_KEYS, 5)).astype(want.dtype)
    logits[rng.random((N_KEYS, 5)) < 0.3] = -np.inf
    logits[::7] = -np.inf
    logits[::7, 3] = 0.5
    for lg in (logits, logits[:1].repeat(N_KEYS, 0)):
        want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(lg))
        got = R.categorical(tk, torch.from_numpy(lg))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[::7] == 3).all()
