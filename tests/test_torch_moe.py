"""PyTorch port, MoE channel mixer: routing (softmax top-k, and the sigmoid
aux-loss-free variant with a correction bias) and the masked-dense
``moe_ffn`` with the shared expert, against the JAX ones on the smoke
shapes of jamba-1.5-large-398b (4 experts padded to 16, top-2, no shared
expert) and qwen2-moe-a2.7b (the same, with a shared expert), on the same
parameters (fp32). The padded expert slots are masked at -1e30 in both.
``torch.topk`` and ``lax.top_k`` may order exact ties differently; with
random router weights there are none, and the test asserts the chosen
experts are equal, not only the outputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.model import _moe_pad  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402

ARCHS = ["jamba-1.5-large-398b", "qwen2-moe-a2.7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(arch, aux_free=False, seed=0):
    cfg = jget_config(arch).smoke()
    E = JMoE.pad_experts(cfg.num_experts, 16)
    jp = JMoE.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe_d_ff,
                       cfg.num_experts, E, cfg.shared_expert_d_ff,
                       jnp.float32, aux_free=aux_free)
    if aux_free:      # a bias that changes the choice for some tokens
        jp["router_bias"] = jnp.asarray(
            np.random.default_rng(seed).normal(size=(E,)) * 0.3, jnp.float32)
    return cfg, jp, from_jax_numpy(None, jax.tree.map(np.asarray, jp))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("aux_free", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch, aux_free):
    cfg, jp, tp = _setup(arch, aux_free)
    t = _tokens(cfg, (40,))
    k = cfg.num_experts_per_tok
    jids, jw, jaux = JMoE._route(jp, jnp.asarray(t), cfg.num_experts, k,
                                 aux_free)
    ids, w, aux = TMoE._route(tp, torch.from_numpy(t), cfg.num_experts, k,
                              aux_free)
    assert ids.tolist() == np.asarray(jids).tolist()
    assert int(ids.max()) < cfg.num_experts      # padded slots never chosen
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("aux_free", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, aux_free):
    """[B, S, d] through routed experts (and qwen2-moe's shared expert)."""
    cfg, jp, tp = _setup(arch, aux_free, seed=2)
    x = _tokens(cfg, (3, 7), seed=3)
    kw = dict(num_real=cfg.num_experts, top_k=cfg.num_experts_per_tok,
              activation=cfg.activation, aux_free=aux_free)
    jy, jaux = JMoE.moe_ffn(jp, jnp.asarray(x), ctx=JMoE.MoEContext(), **kw)
    y, aux = TMoE.moe_ffn(tp, torch.from_numpy(x), **kw)
    assert ("shared" in tp) == bool(cfg.shared_expert_d_ff)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches_jax(arch):
    """Leaves, shapes (after the port's leading [reps] axis) and dtypes of
    the port's init_moe equal the reference's; the router stays fp32 and
    the experts are drawn at 1/sqrt(fan_in)."""
    cfg, jp, _ = _setup(arch, aux_free=True)
    tcfg = get_config(arch).smoke()
    E = _moe_pad(tcfg)
    got = TMoE.init_moe(torch.Generator().manual_seed(0), 2, tcfg.d_model,
                        tcfg.moe_d_ff, tcfg.num_experts, E,
                        tcfg.shared_expert_d_ff, torch.float32, "cpu",
                        aux_free=True)

    def flat(tree, path=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{path}/{k}"))
            else:
                out[f"{path}/{k}"] = v
        return out
    g, w = flat(got), flat(jax.tree.map(np.asarray, jp))
    assert sorted(g) == sorted(w)
    for k in g:
        assert tuple(g[k].shape) == (2,) + w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
    assert E == 16 and g["/router"].dtype == torch.float32
    std = float(g["/w_down"].std()) * np.sqrt(tcfg.moe_d_ff)
    assert 0.9 < std < 1.1
