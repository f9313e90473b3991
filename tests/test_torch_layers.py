"""PyTorch port: every function of ``models/layers.py`` against the JAX
reference on the same numpy inputs (fp32, atol 1e-6)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

RNG = np.random.default_rng(0)
TOL = dict(atol=1e-6, rtol=1e-6)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 16)])
def test_rms_norm(shape):
    x = RNG.normal(size=shape).astype(np.float32)
    w = (RNG.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x), _both(w)
    np.testing.assert_allclose(TL.rms_norm(tx, tw, 1e-6).numpy(),
                               np.asarray(JL.rms_norm(jx, jw, 1e-6)), **TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = (RNG.normal(size=(4, 33)) * 40).astype(np.float32)
    jx, tx = _both(x)
    np.testing.assert_allclose(TL.softcap(tx, cap).numpy(),
                               np.asarray(JL.softcap(jx, cap)), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn(name):
    x = (RNG.normal(size=(5, 40)) * 3).astype(np.float32)
    jx, tx = _both(x)
    np.testing.assert_allclose(TL.act_fn(name)(tx).numpy(),
                               np.asarray(JL.act_fn(name)(jx)), **TOL)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_frequencies(head_dim):
    np.testing.assert_allclose(
        TL.rope_frequencies(head_dim, 500_000.0).numpy(),
        np.asarray(JL.rope_frequencies(head_dim, 500_000.0)), **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    """Half-split layout at ragged per-row positions [B, T]."""
    x = RNG.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = RNG.integers(0, 200, size=(2, 6)).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    np.testing.assert_allclose(TL.apply_rope(tx, tp, theta).numpy(),
                               np.asarray(JL.apply_rope(jx, jp, theta)),
                               atol=2e-6, rtol=1e-6)


def test_mlp():
    d, f = 64, 128
    x = RNG.normal(size=(3, 5, d)).astype(np.float32)
    p = {k: (RNG.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(TL.mlp(tp, torch.from_numpy(x), "silu").numpy(),
                               np.asarray(JL.mlp(jp, jnp.asarray(x), "silu")),
                               atol=1e-5, rtol=1e-5)


def test_init_distributions():
    """dense_init / embed_init draw the reference's distributions (the
    numbers differ: the generators differ)."""
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (2, 512, 256), 512, torch.float32, "cpu")
    e = TL.embed_init(gen, 1000, 64, torch.float32, "cpu")
    jw = JL.dense_init(jax.random.PRNGKey(0), 512, 256, jnp.float32)
    assert w.shape == (2, 512, 256) and e.shape == (1000, 64)
    assert abs(float(w.std()) - float(np.std(np.asarray(jw)))) < 2e-3
    assert abs(float(w.std()) - 512 ** -0.5) < 2e-3
    assert abs(float(e.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 2e-3
