"""PyTorch port: the gradients of the three kernels on the training path,
and rematerialization.

Each kernel's ``autograd.Function`` (#5 ``ChunkedPrefillAttention``, #6
``MambaScanFresh``, #7 ``MlstmChunkwiseFresh``) on the CPU against
autograd through its plain version directly: #5 with GQA, a window,
softcap, non-causal, a query offset with lengths and values narrower than
keys; #6 and #7 from a fresh state at ragged lengths. On the CPU the
Function's forward is the plain version too, so the outputs and gradients
must be equal; what this tests is the saved-tensor and recompute plumbing
that the card runs. Then: grad mode off or inputs without grad take the
wrapper directly; a fresh state's outputs stay out of the graph; remat
"full" and "dots" give "none"'s gradients for every arch; and under
"full" each kernel's plain version runs once per call in the forward and
once more for the recompute plus once for the gradient in the backward."""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import params as TP  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, MLA, MLSTM  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import kernel as CK  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import ops as CO  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention.ref import (  # noqa: E402
    chunked_prefill_attention_ref)
from repro_torch.kernels.mamba_scan import kernel as MK  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as MO  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunkwise import kernel as LK  # noqa: E402
from repro_torch.kernels.mlstm_chunkwise import ops as LO  # noqa: E402
from repro_torch.kernels.mlstm_chunkwise.ref import (  # noqa: E402
    NEG_INF, mlstm_chunkwise_ref)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import build_stacks  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

from test_torch_train_archs import B, ENC, S, batch_of  # noqa: E402


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).requires_grad_()


def _same_grads(op, plain, inputs, seed):
    """op(*inputs) and plain(*inputs): equal outputs, equal gradients of a
    random projection of the output."""
    out = op(*inputs)
    want = plain(*inputs)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(out.shape)).astype(np.float32))
    got = torch.autograd.grad((out * w).sum(), inputs)
    ref = torch.autograd.grad((want * w).sum(), inputs)
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    return out


@pytest.mark.parametrize("H,Hkv,Sq,Sk,D,Dv,causal,window,cap,q_offset,lens", [
    (4, 2, 16, 16, 16, 16, True, 0, 0.0, 0, None),     # GQA, causal
    (4, 4, 24, 24, 16, 16, True, 8, 0.0, 0, None),     # window
    (2, 1, 12, 12, 8, 8, True, 0, 20.0, 0, None),      # softcap
    (4, 2, 8, 40, 16, 16, False, 0, 0.0, 0, None),     # not causal, Sk > Sq
    (4, 2, 10, 30, 24, 16, True, 6, 30.0, 20, [27, 22]),  # offset, lengths,
])                                                      # Dv < D
def test_attention_function_matches_autograd_of_plain(
        H, Hkv, Sq, Sk, D, Dv, causal, window, cap, q_offset, lens):
    rng = np.random.default_rng(H * 100 + Sq)
    q, k, v = (_rand(rng, 2, H, Sq, D), _rand(rng, 2, Hkv, Sk, D),
               _rand(rng, 2, Hkv, Sk, Dv))
    lengths = torch.tensor(lens or [Sk, Sk], dtype=torch.int32)
    opts = dict(scale=0.3, q_offset=q_offset, causal=causal, window=window,
                softcap=cap)
    out = _same_grads(
        lambda q, k, v: CO.chunked_prefill_attention_op(q, k, v, lengths,
                                                        **opts),
        lambda q, k, v: chunked_prefill_attention_ref(q, k, v, lengths,
                                                      **opts),
        (q, k, v), seed=1)
    assert type(out.grad_fn).__name__ == "ChunkedPrefillAttentionBackward"


@pytest.mark.parametrize("S", [1, 5, 37])
def test_mamba_function_matches_autograd_of_plain(S):
    rng = np.random.default_rng(S)
    Bn, d, n = 2, 8, 4
    x = _rand(rng, Bn, S, d)
    dt = torch.nn.functional.softplus(_rand(rng, Bn, S, d))
    Bc, Cc = _rand(rng, Bn, S, n), _rand(rng, Bn, S, n)
    A = -torch.exp(_rand(rng, d, n, scale=0.5))
    D = _rand(rng, d)
    ins = (x, dt, Bc, Cc, A, D)

    def fresh_plain(*a):
        h = torch.zeros((Bn, d, n))
        return mamba_scan_ref(*a, h), h
    out = _same_grads(lambda *a: MO.mamba_scan_fresh_op(*a)[0],
                      lambda *a: fresh_plain(*a)[0], ins, seed=2)
    assert type(out.grad_fn).__name__ == "MambaScanFreshBackward"
    y, h = MO.mamba_scan_fresh_op(*ins)
    torch.testing.assert_close(h, fresh_plain(*ins)[1].detach(), rtol=0,
                               atol=0)
    assert not h.requires_grad          # the state stays out of the graph


@pytest.mark.parametrize("S", [1, 64, 100])
def test_mlstm_function_matches_autograd_of_plain(S):
    rng = np.random.default_rng(S + 7)
    Bn, H, D = 2, 2, 8
    q, k, v = (_rand(rng, Bn, S, H, D), _rand(rng, Bn, S, H, D, scale=0.3),
               _rand(rng, Bn, S, H, D))
    log_i = _rand(rng, Bn, S, H)
    log_f = torch.nn.functional.logsigmoid(_rand(rng, Bn, S, H) + 3.0)
    ins = (q, k, v, log_i, log_f)

    def fresh():
        return (torch.zeros((Bn, H, D, D)), torch.zeros((Bn, H, D)),
                torch.full((Bn, H), NEG_INF))
    out = _same_grads(lambda *a: LO.mlstm_chunkwise_fresh_op(*a)[0],
                      lambda *a: mlstm_chunkwise_ref(*a, *fresh())[0], ins,
                      seed=3)
    assert type(out.grad_fn).__name__ == "MlstmChunkwiseFreshBackward"
    _, C, n, m = LO.mlstm_chunkwise_fresh_op(*ins)
    C0, _, _ = state = fresh()
    _, n0, m0 = mlstm_chunkwise_ref(*(t.detach() for t in ins), *state)
    for got, want in ((C, C0), (n, n0), (m, m0)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert not got.requires_grad


def test_without_grad_the_wrappers_run_directly():
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 1, 2, 4, 8) for _ in range(3))
    lengths = torch.tensor([4], dtype=torch.int32)
    with torch.no_grad():
        out = CO.chunked_prefill_attention_op(q, k, v, lengths, scale=0.5)
    assert out.grad_fn is None
    out = CO.chunked_prefill_attention_op(q.detach(), k.detach(), v.detach(),
                                          lengths, scale=0.5)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# remat and the plain-version calls of a training step
# ---------------------------------------------------------------------------
def _loss_and_grads(cfg, params, batch, remat):
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    loss = TM.loss_fn(cfg, params, batch, TM.RunCtx(remat=remat))
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              allow_unused=True)


# jamba's smoke config holds 14 Mamba layers, whose plain backward is a
# Python loop over time: three passes at the shared batch took 284 s of a
# tier-1 run. Its batch is cut to one row of REMAT_S tokens: whether remat
# changes a gradient depends on neither.
REMAT_S = {"jamba-1.5-large-398b": 4}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    cfg = get_config(arch).smoke()
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 5).items()}
    if arch in REMAT_S:
        batch["tokens"] = batch["tokens"][:1, :REMAT_S[arch]].contiguous()
    params = TP.init_params(cfg, seed=0, device="cpu")
    loss0, g0 = _loss_and_grads(cfg, params, batch, "none")
    for remat in ("full", "dots"):
        loss, g = _loss_and_grads(cfg, params, batch, remat)
        assert float(loss) == float(loss0)
        for a, b in zip(g, g0):
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _attention_calls(cfg, enc):
    """#5 calls in one forward: every attention or MLA layer, each decoder
    layer's cross attention and the encoder's layers (with encoder frames),
    the MTP block's mixer."""
    n = sum(reps * sum(m in (ATTN, LOCAL_ATTN, MLA) for m, _ in period)
            for period, reps in build_stacks(cfg))
    if cfg.enc_dec and enc:
        n += cfg.num_layers + cfg.num_encoder_layers
    if cfg.mtp_depth:
        n += int(cfg.layer_pattern[0] in (ATTN, LOCAL_ATTN, MLA))
    return n


def _mixers(cfg, kind):
    return sum(reps * [m for m, _ in period].count(kind)
               for period, reps in build_stacks(cfg))


@contextlib.contextmanager
def plain_counts(monkeypatch):
    """Count the plain versions' calls, by caller: the wrappers (the
    kernels' forward on the CPU) and the Functions' backward."""
    counts = {}

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name, key in (
            (CK, "chunked_prefill_attention_ref", "attn fwd"),
            (CO, "chunked_prefill_attention_ref", "attn bwd"),
            (MK, "mamba_scan_ref", "mamba fwd"),
            (MO, "mamba_scan_ref", "mamba bwd"),
            (LK, "mlstm_chunkwise_ref", "mlstm fwd"),
            (LO, "mlstm_chunkwise_ref", "mlstm bwd")):
        counting(mod, name, key)
    yield counts


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "deepseek-v3-671b",
                                  "seamless-m4t-large-v2"])
def test_full_remat_runs_each_kernel_twice(arch, monkeypatch):
    """remat "full": the forward calls each kernel once per layer; the
    backward recomputes each (once more) and differentiates its plain
    version (once)."""
    cfg = get_config(arch).smoke()
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 6).items()}
    params = TP.init_params(cfg, seed=0, device="cpu")
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    want = {"attn": _attention_calls(cfg, "enc_embeds" in batch),
            "mamba": _mixers(cfg, MAMBA), "mlstm": _mixers(cfg, MLSTM)}
    with plain_counts(monkeypatch) as counts:
        loss = TM.loss_fn(cfg, params, batch, TM.RunCtx(remat="full"))
        fwd = dict(counts)
        torch.autograd.grad(loss, leaves, allow_unused=True)
    for k, n in want.items():
        assert fwd.get(f"{k} fwd", 0) == n, (k, fwd)
        assert fwd.get(f"{k} bwd", 0) == 0
        assert counts.get(f"{k} fwd", 0) == 2 * n, (k, counts)
        assert counts.get(f"{k} bwd", 0) == n, (k, counts)
    assert want["attn"] + want["mamba"] + want["mlstm"] > 0
