"""Network front door smoke of the PyTorch port: HTTP/SSE server + 2-replica
prefix-affine router (the port's counterpart of
``examples/router_smoke.py``), on the GPU unless ``--device cpu``.

1. launches ``python -m repro_torch.launch.serve --serve-http --replicas
   2`` as a real subprocess (its own process, own engines on ``--device``,
   SIGINT-driven lifecycle);
2. replays a shared-prefix workload through the HTTP client and checks the
   SSE token streams are **bit-identical** to an in-process single-engine
   run of the same prompts on the same device (replicas share seed-0
   params, so routing must never change greedy tokens);
3. cancels a request mid-stream over HTTP and checks it aborts server-side;
4. reads ``GET /v1/stats`` and checks the router's prefix directory took
   hits (the shared stream landed on its holder) and that every replica
   kept the one-readback-per-round zero-sync invariant;
5. sends SIGINT and checks the server drains gracefully and exits 0.

    PYTHONPATH=src python examples/router_smoke_torch.py
    PYTHONPATH=src python examples/router_smoke_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.frontend.client import EngineHttpClient  # noqa: E402
from repro_torch.frontend.http_server import build_backend  # noqa: E402


def launch_server(replicas: int = 2, device: str = "cuda"
                  ) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    env["PYTHONUNBUFFERED"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-http",
         "--device", device, "--port", "0", "--replicas", str(replicas),
         "--kv-tokens", "2048", "--max-budget", "256"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def wait_banner(proc: subprocess.Popen, deadline_s: float = 120.0) -> int:
    """Parse the 'listening on http://host:port' banner; returns the port."""
    t_end = time.perf_counter() + deadline_s
    while time.perf_counter() < t_end:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"server exited early: {proc.poll()}")
        sys.stdout.write(f"[server] {line}")
        m = re.search(r"listening on http://[^:]+:(\d+)", line)
        if m:
            return int(m.group(1))
    raise TimeoutError("no listening banner")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server's and the in-process "
                         "engines; the default GPU raises when absent")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    system = rng.integers(1, 1000, 48).tolist()
    prompts = [system + rng.integers(1, 1000, 16).tolist() for _ in range(5)]

    # in-process single-engine reference (same prompts, same seed-0 params):
    # the parity bar every HTTP/SSE stream must hit bit-for-bit
    ref_backend = build_backend(replicas=1, kv_tokens=2048, max_budget=256,
                                device=args.device)
    reference = [ref_backend.submit(np.asarray(p, np.int32),
                                    max_output=5).result() for p in prompts]
    ref_backend.close()

    proc = launch_server(replicas=2, device=args.device)
    try:
        port = wait_banner(proc)
        cli = EngineHttpClient(port=port, timeout=180.0)
        cli.wait_ready(60.0)

        # --- SSE parity: sequential shared-prefix stream ---------------------
        # (sequential so each request's pages are committed — and in the
        # directory — before the next one routes)
        for i, p in enumerate(prompts):
            h = cli.generate(p, slo_class="interactive", max_output=5)
            toks = h.result()
            assert toks == reference[i], \
                f"prompt {i}: HTTP {toks} != in-process {reference[i]}"
            assert h.finish_reason == "length", h.finish_reason
        print(f"parity OK: {len(prompts)} SSE streams bit-identical "
              f"to the in-process engine")

        # --- mid-stream cancel over HTTP -------------------------------------
        h = cli.generate(rng.integers(1, 1000, 64).tolist(), max_output=256)
        got = []
        for tok in h.tokens():
            got.append(tok)
            if len(got) == 1:
                assert h.cancel(), "cancel reported not-live"
        assert h.aborted, f"finish_reason={h.finish_reason}"
        assert len(got) < 256, "cancel did not stop the stream"
        print(f"cancel OK: aborted mid-stream after {len(got)} tokens")

        # --- router + invariant checks over /v1/stats ------------------------
        st = cli.stats()
        routing = st["routing"]
        assert routing["policy"] == "prefix-affine"
        hit_rate = routing["directory"]["hit_rate"]
        assert hit_rate > 0, f"directory never hit: {routing['directory']}"
        assert routing["affine_hits"] >= len(prompts) - 1, routing
        for i, rep in enumerate(st["replicas"]):
            eng = rep["engine"]
            assert eng["token_readbacks"] == eng["iterations"], \
                f"replica {i}: zero-sync broken ({eng['token_readbacks']} " \
                f"readbacks / {eng['iterations']} rounds)"
        print(f"router OK: directory hit rate {hit_rate:.2f}, "
              f"routed={routing['routed']}, one readback/round per replica")

        # --- graceful drain on SIGINT ----------------------------------------
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        sys.stdout.write("".join(f"[server] {l}\n"
                                 for l in out.splitlines() if l))
        assert proc.returncode == 0, f"exit code {proc.returncode}"
        assert "drained" in out, "no drain report in server output"
        print("shutdown OK: SIGINT drained and exited 0")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    print("ROUTER SMOKE PASSED")


if __name__ == "__main__":
    main()
