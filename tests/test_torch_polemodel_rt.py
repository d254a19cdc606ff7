"""PyTorch port: the runtime pole-model sampler (`behavior.PoleModelRT`)
held to the JAX package's `behavior.PoleModelRT` on the packaged
balancing-rider pole model, in float64 on the CPU.

The Cholesky constants, the transforms (`transform_given`,
`inverse_transform_rest`), `conditional` and `_ok` within 1e-12;
`sample_features_batch` from per-agent keys and from one key, and
`sample_features_info` from a batch of keys (JAX: a vmap), within 1e-9
relative with the same fallback flags (the draws are JAX's: the port's
threefry streams); and tests/test_behavior.py's fallback rate and
distribution checks (two-sample KS against the JAX host sampler, and the
batch sampler against the per-key one), mirrored.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package's pytrees

import jax.numpy as jnp  # noqa: E402

from cyclistsocialforce_tpu import behavior as JB  # noqa: E402
from cyclistsocialforce_tpu_torch import behavior as TB  # noqa: E402
from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import random as R  # noqa: E402

torch.set_num_threads(1)

MODEL = "BR1_ImRe5GivenV_pole-model-params.yaml"
TOL = 1e-12


@pytest.fixture(scope="module")
def rts():
    jpm = JB.load_packaged_polemodel(MODEL)
    return (JB.PoleModelRT.from_polemodel(jpm),
            TB.PoleModelRT.from_polemodel(TB.load_packaged_polemodel(MODEL)),
            jpm)


def keys_of(jkeys):
    return torch.from_numpy(np.asarray(jkeys).astype(np.int64))


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_from_polemodel_matches_jax(rts):
    """Every array and static of `from_polemodel`, and the JAX model
    converted (`convert.polemodel_rt_from_jax`) samples the same."""
    jrt, trt, _ = rts
    for f in ("means", "cov_chol", "covariances", "weights", "lambdas",
              "scaler_mean", "scaler_scale", "log_a", "log_sign"):
        close(getattr(trt, f), getattr(jrt, f))
    assert trt.log_features == jrt.log_features
    assert (trt.idx_given, trt.n_features) == (jrt.idx_given,
                                               jrt.n_features)
    conv = convert.polemodel_rt_from_jax(jrt)
    keys = R.split(R.key(4, "cpu"), 50)
    v = torch.linspace(1.0, 8.0, 50, dtype=torch.float64)
    for a, b in zip(conv.sample_features_batch(keys, v),
                    trt.sample_features_batch(keys, v)):
        assert torch.equal(a, b)


def test_transforms_conditional_ok_match_jax(rts):
    """transform_given over 0.5-9 m/s, inverse_transform_rest of normal
    draws (out-of-domain values NaN in both), conditional's means,
    factors and weights, and _ok: JAX's within 1e-12."""
    jrt, trt, _ = rts
    v = np.linspace(0.5, 9.0, 61)
    close(trt.transform_given(torch.from_numpy(v)),
          jax.vmap(jrt.transform_given)(jnp.asarray(v)))
    x = np.random.default_rng(0).normal(0, 2, (200, 5))
    got = trt.inverse_transform_rest(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.vmap(jrt.inverse_transform_rest)(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin])
    mu, chol, w = trt.conditional(torch.from_numpy(v))
    jmu, jchol, jw = jax.vmap(jrt.conditional)(jnp.asarray(v))
    close(mu, jmu)
    close(chol.expand(jchol.shape), jchol)
    close(w, jw)
    np.testing.assert_array_equal(
        trt._ok(torch.from_numpy(got)).numpy(),
        np.asarray(jax.vmap(jrt._ok)(jnp.asarray(want))))


@pytest.mark.parametrize("per_agent", [True, False])
def test_sample_features_batch_matches_jax(rts, per_agent):
    """`sample_features_batch` at 400 speeds from per-agent keys ([N, 2])
    and from one key: the features within 1e-9 relative, the same
    fallback flags (including riders below the fit band, 0.3-1 m/s)."""
    jrt, trt, _ = rts
    v = np.concatenate([np.linspace(0.3, 1.0, 40),
                        np.random.default_rng(1).uniform(1, 8, 360)])
    jkey = jax.random.PRNGKey(3)
    if per_agent:
        jkey = jax.random.split(jkey, v.size)
        tkey = keys_of(jkey)
    else:
        tkey = R.key(3, "cpu")
    want, wgood = jrt.sample_features_batch(jkey, jnp.asarray(v))
    got, good = trt.sample_features_batch(tkey, torch.from_numpy(v))
    np.testing.assert_array_equal(good.numpy(), np.asarray(wgood))
    close(got, want, 1e-9)


def test_sample_features_info_matches_jax(rts):
    """`sample_features_info` per key of a batch at fixed speeds (JAX: a
    vmap of the single-key call; its component choice is
    `jax.random.choice` with the weights): within 1e-9, the same flags."""
    jrt, trt, _ = rts
    jkeys = jax.random.split(jax.random.PRNGKey(11), 300)
    for v in (0.8, 3.0, 5.0):
        want, wgood = jax.vmap(
            lambda k: jrt.sample_features_info(k, jnp.asarray(v)))(jkeys)
        got, good = trt.sample_features_info(
            keys_of(jkeys), torch.tensor(v, dtype=torch.float64))
        np.testing.assert_array_equal(good.numpy(), np.asarray(wgood))
        close(got, want, 1e-9)
        close(trt.sample_features(keys_of(jkeys),
                                  torch.tensor(v, dtype=torch.float64)),
              want, 1e-9)


def test_polemodel_rt_fallback_rate(rts):
    """tests/test_behavior.py's bar: at 2, 3 and 5 m/s the fallback to the
    conditional mean stays under 2% of 2,000 draws, every draw finite."""
    _, trt, _ = rts
    keys = R.split(R.key(11, "cpu"), 2000)
    for v in (2.0, 3.0, 5.0):
        feats, good = trt.sample_features_info(
            keys, torch.tensor(v, dtype=torch.float64))
        assert torch.isfinite(feats).all()
        rate = 1.0 - good.double().mean().item()
        assert rate < 0.02, f"fallback rate {rate:.3f} at v={v}"


def test_rt_sampler_matches_host_distribution(rts):
    """tests/test_behavior.py's distribution contract: 4,000 draws at
    3 m/s, real parts stable, each feature's marginal indistinguishable
    (two-sample KS, p > 1e-4) from the JAX host sampler's draws under the
    same stability rejection."""
    from scipy import stats

    _, trt, jpm = rts
    feats = trt.sample_features(R.split(R.key(3, "cpu"), 4000),
                                torch.tensor(3.0, dtype=torch.float64))
    feats = feats.numpy()
    assert np.all(np.isfinite(feats))
    assert np.all(feats[:, [0, 1, 3]] < 0)
    host, _ = jpm.sample_pole_features(12000, v=3.0,
                                       rng=np.random.default_rng(0))
    host = host[np.all(host[:, [0, 1, 3]] < 0, axis=1)]
    for col in range(feats.shape[1]):
        d, p = stats.ks_2samp(feats[:, col], host[:, col])
        assert p > 1e-4, f"feature {col}: KS {d:.4f}, p={p:.2e}"


def test_batch_sampler_matches_per_key_distribution(rts):
    """tests/test_behavior.py's batch check: the population sampler from
    one key and the per-key sampler agree in distribution at 4 m/s."""
    from scipy import stats

    _, trt, _ = rts
    n = 4000
    v = torch.full((n,), 4.0, dtype=torch.float64)
    batch, _ = trt.sample_features_batch(R.key(5, "cpu"), v)
    per_key = trt.sample_features(R.split(R.key(6, "cpu"), n), v[0])
    for col in range(batch.shape[1]):
        d, p = stats.ks_2samp(batch[:, col].numpy(), per_key[:, col].numpy())
        assert p > 1e-4, f"feature {col}: KS {d:.4f}, p={p:.2e}"


def test_to_keeps_the_model(rts):
    """`to(float32)` rounds every tensor and keeps the statics; float32
    draws (their own uniform words: JAX's float32 and float64 draws of
    one key differ) are finite and mostly rejection-sampled."""
    _, trt, _ = rts
    t32 = trt.to(torch.float32)
    assert t32.means.dtype == torch.float32
    assert t32._ratio.dtype == torch.float32
    assert t32.log_features == trt.log_features
    keys = R.split(R.key(8, "cpu"), 2000)
    f32, g32 = t32.sample_features_batch(
        keys, torch.linspace(2.0, 7.0, 2000, dtype=torch.float32))
    assert f32.dtype == torch.float32 and torch.isfinite(f32).all()
    assert g32.float().mean() > 0.98
