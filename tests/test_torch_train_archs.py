"""PyTorch port: the training loss and its gradients against JAX for every
arch's smoke config (fp32): ``loss_fn`` and ``jax.value_and_grad`` of the
reference against the port's ``loss_fn`` and ``torch.autograd.grad`` on
the same parameters (JAX ``init_params`` through ``from_jax_numpy``) and
the same batch from a numpy seed, with internvl2's patch embeddings,
seamless-m4t's encoder frames and deepseek-v3's ``mtp`` module. On the
CPU the kernels of the path (#5 attention, #6 Mamba, #7 mLSTM) run their
plain versions through their ``autograd.Function``. Limits: the loss to
1e-5 relative, each gradient leaf to ``2e-4 * max|g_jax|``; every leaf of
the reference's tree gets a gradient, by the same path."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

B, S, ENC = 2, 32, 16
# the reference test's tiling (tests/test_smoke_archs.py), S a multiple
JRCTX = JM.RunCtx(block_q=16, block_k=16, mlstm_block=16)


def batch_of(cfg, seed=0):
    """tokens [B, S] and the arch's frontend inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.num_patch_tokens:
        batch["extra_embeds"] = (rng.normal(size=(
            B, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.enc_dec:
        batch["enc_embeds"] = (rng.normal(size=(B, ENC, cfg.d_model))
                               * 0.02).astype(np.float32)
    return batch


def port_value_and_grad(cfg, params, batch, rctx):
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    loss = TM.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, rctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    return float(loss.detach()), dict(zip(paths, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg = jget_config(arch).smoke()
    tcfg = get_config(arch).smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TP.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    batch = batch_of(tcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, JRCTX))(
        jparams)
    tloss, tgrads = port_value_and_grad(tcfg, tparams, batch, TM.RunCtx())
    assert np.isfinite(tloss)
    assert abs(tloss - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(tgrads) == set(want)
    if tcfg.mtp_depth:
        assert any(k.startswith("['mtp']") for k in tgrads)
    for k, w in want.items():
        g = tgrads[k]
        lim = 2e-4 * float(np.abs(w).max())
        if g is None:       # not reached by the loss (a router bias)
            assert float(np.abs(w).max()) == 0.0, k
            continue
        assert g.shape == w.shape, k
        err = float(np.abs(g.numpy() - w).max())
        assert err <= lim, f"{arch} {k}: {err:.3e} > {lim:.3e}"
