"""PyTorch port: the reference's serving examples against the port's, in
process on the CPU, on the same weights.

Each reference example (``examples/serve_streaming.py``,
``examples/serve_slo_engine.py``) is loaded from its file and run with its
output captured; the port's (``examples/*_torch.py``) runs its scenario
functions on ``from_jax_numpy`` of the weights the JAX
``EngineCore(seed=0)`` draws, in fp32. The printed token streams, cancel
and stop lines, prefix-cache and speculation counters are equal for the
streaming demo (paged and slot), ``--shared-prefix`` and ``--spec-k 4``
greedy; the SLO engine driver gives each request the reference's tokens
(its round counts follow the learned predictor). Sampled speculation
(``--temperature 0.7 --top-k 20 --sample-seed 9``) is deterministic within
the port. Each port example takes the reference's flags plus ``--device``
and, without ``--device cpu``, raises here where there is no card. An id
past the vocabulary embeds as the reference's clamped gather does (the
router smoke's prompts hold such ids).
"""
import argparse
import contextlib
import io
import re
import sys
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _examples_ranks import load_example  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.params import from_jax_numpy  # noqa: E402

ARCH = "llama3.2-3b"
KV = 4096                  # the examples' default --kv-tokens
SAMPLED = dict(temperature=0.7, top_k=20, sample_seed=9)   # the CI job's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke runs are small: one intra-op thread keeps them from
    contending with the other test processes for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def captured(fn, *args, argv=None, **kw):
    """(what ``fn`` returns, the lines it printed), with ``sys.argv`` set
    to ``argv`` for a reference ``main()``."""
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        if argv is not None:
            stack.enter_context(mock.patch.object(sys, "argv",
                                                  ["example"] + argv))
        stack.enter_context(contextlib.redirect_stdout(buf))
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def examples():
    return {"streaming": load_example("serve_streaming_torch"),
            "slo": load_example("serve_slo_engine_torch"),
            "router": load_example("router_smoke_torch")}


@pytest.fixture(scope="module")
def reference():
    """Every reference scenario's printed lines, in one process."""
    ex = load_example("serve_streaming")
    slo = load_example("serve_slo_engine")
    ns = dict(arch=ARCH, kv_tokens=KV, mesh=None)
    greedy = dict(temperature=0.0, top_k=0, sample_seed=0)
    return {
        "paged": captured(ex.main, argv=["--cache-mode", "paged"])[1],
        "slot": captured(ex.main, argv=["--cache-mode", "slot"])[1],
        "prefix": captured(ex.shared_prefix_smoke,
                           argparse.Namespace(**ns))[1],
        "spec": captured(ex.spec_smoke,
                         argparse.Namespace(**ns, spec_k=4, **greedy))[1],
        "slo": captured(slo.main, argv=[])[1]}


@pytest.fixture(scope="module")
def port_kw():
    """The port's engine keywords: the CPU and the JAX engine's seed-0
    weights."""
    cfg = get_config(ARCH).smoke()
    jparams = jmodel.init_params(jget_config(ARCH).smoke(),
                                 jax.random.PRNGKey(0))
    params = from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return cfg, dict(kv_capacity_tokens=KV, device="cpu", params=params)


@pytest.mark.parametrize("mode", ["paged", "slot"])
def test_streaming_demo_prints_the_reference_lines(examples, reference,
                                                   port_kw, mode):
    """Every line of the demo: the streamed interactive tokens, the cancel
    after 3 tokens, the stop-token request, the batch tenant, the
    counters and (paged) the whole pool."""
    ex = examples["streaming"]
    cfg, kw = port_kw
    rec, lines = captured(ex.streaming_demo, cfg, cache_mode=mode, **kw)
    _, more = captured(ex.check_demo, rec)
    lines += more
    assert lines == reference[mode]
    assert any("reason=aborted" in line for line in lines)
    assert any("(reason=stop)" in line for line in lines)


def test_shared_prefix_prints_the_reference_counters(examples, reference,
                                                     port_kw):
    """Hit and prompt tokens, hit rate and computed prefill tokens, cache
    on and off, and the parity line."""
    ex = examples["streaming"]
    cfg, kw = port_kw
    rec, lines = captured(ex.shared_prefix_smoke, cfg, **kw)
    _, more = captured(ex.check_shared_prefix, rec)
    assert lines + more == reference["prefix"]
    assert rec["runs"][True]["cache_info"]["hit_tokens"] > 0


def test_spec_greedy_prints_the_reference_counters(examples, reference,
                                                   port_kw):
    """spec_k 4 against 0: acceptance, drafts, tokens a verify row, rounds
    and the parity line."""
    ex = examples["streaming"]
    cfg, kw = port_kw
    rec, lines = captured(ex.spec_smoke, cfg, spec_k=4, **kw)
    _, more = captured(ex.check_spec, rec)
    assert lines + more == reference["spec"]
    assert rec["runs"][0]["tokens"] == rec["runs"][1]["tokens"]


def test_spec_sampled_is_deterministic(examples, port_kw):
    """The sampled CI job's flags: both spec runs give one stream (the
    check), again in a second call, and it is not the greedy stream."""
    ex = examples["streaming"]
    cfg, kw = port_kw
    recs = [captured(ex.spec_smoke, cfg, spec_k=4, **SAMPLED, **kw)[0]
            for _ in range(2)]
    for rec in recs:
        _, lines = captured(ex.check_spec, rec)
        assert lines == ["temperature=0.7 determinism OK across 4 streams"]
    assert recs[0]["runs"][0]["tokens"] == recs[1]["runs"][0]["tokens"]
    greedy = captured(ex.spec_smoke, cfg, spec_k=4, **kw)[0]
    assert recs[0]["runs"][0]["tokens"] != greedy["runs"][0]["tokens"]


_REQ = re.compile(r"^  req (\d+): prompt=(\d+) ttft=\S+ tokens=(\[.*\])$")


def _slo_tokens(lines):
    return {int(m[1]): (int(m[2]), m[3]) for m in map(_REQ.match, lines)
            if m}


def test_slo_engine_driver_gives_the_reference_tokens(examples, reference,
                                                      port_kw):
    """Six requests 0.3 s apart: every one finishes with the reference's
    prompt length and tokens."""
    cfg, kw = port_kw
    rec, lines = captured(examples["slo"].serve_requests, cfg, **kw)
    want = _slo_tokens(reference["slo"])
    assert len(want) == 6
    assert _slo_tokens(lines) == want
    assert {rid: str(t) for rid, t in rec["tokens"].items()} == \
        {rid: t for rid, (_, t) in want.items()}
    assert lines[0] == reference["slo"][0].replace(", CPU)", ", cpu)")


def _flags(main):
    """The option strings an example's ``main`` lists in its ``--help``
    (read from ``sys.argv``, as the reference's ``main`` reads them)."""
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", ["example", "--help"]), \
            contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main()
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", buf.getvalue()))


@pytest.mark.parametrize("name", ["serve_streaming", "serve_slo_engine"])
def test_port_takes_the_reference_flags_and_device(examples, name):
    port = {"serve_streaming": "streaming", "serve_slo_engine": "slo"}[name]
    want = _flags(load_example(name).main)
    assert _flags(examples[port].main) == want | {"--device", "--help"}


def test_router_smoke_takes_only_device(examples):
    """The reference's router smoke has no flags."""
    assert _flags(examples["router"].main) == {"--device", "--help"}


@pytest.mark.parametrize("port,argv", [
    ("streaming", []), ("streaming", ["--shared-prefix"]),
    ("streaming", ["--spec-k", "4"]), ("streaming", ["--cache-mode", "slot"]),
    ("slo", []), ("router", [])])
def test_examples_default_to_the_card(examples, port, argv):
    """Without ``--device cpu`` every example asks for the card and raises
    here, before any server process starts."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples[port].main(argv)


def test_embed_clamps_ids_past_the_vocabulary_as_the_reference(port_kw):
    """The reference's gather clamps an id past the table to its last row
    (the router smoke's prompts draw ids up to 1000 on a 256-token smoke
    vocabulary); the port's embedding does the same."""
    cfg, kw = port_kw
    jcfg = jget_config(ARCH).smoke()
    ids = np.asarray([[0, 5, cfg.vocab_size - 1, cfg.vocab_size, 999]],
                     np.int32)
    want = np.asarray(jmodel._embed(
        jcfg, {"embed": jax.numpy.asarray(kw["params"]["embed"].numpy())},
        jax.numpy.asarray(ids)))
    got = tmodel._embed(cfg, kw["params"], torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[0, 3], got[0, 2])
