"""Asyncio HTTP/SSE front door over the streaming serving stack (stdlib-only).

Network transport for :class:`InferenceServer` / :class:`EngineRouter` with
**zero engine changes**: the engine is already single-stepped, so one asyncio
task pumps ``backend.step()`` while request handlers await per-rid event
queues fed by the server's event-subscription tap. Everything — pump, HTTP
parsing, SSE writers — runs on one event loop thread, so no locks guard the
(non-thread-safe) engine.

Endpoints::

    POST   /v1/generate        {"prompt": [ids], "slo_class": "...",
                                "max_output": N, "eos_id": id|null,
                                "stop_ids": [ids]}
        -> text/event-stream; one SSE event per engine event:
           `accepted` (carries the rid for mid-stream cancel), `queued`,
           `admitted`, `first_token` / `token` (token ids; a `token` frame
           carries the round's whole burst as `tokens: [ids]` — speculative
           verify rows emit several ids per round — with `token` kept as the
           first id for pre-batch consumers), `evicted`, and a terminal
           `finished` / `aborted`.
    DELETE /v1/requests/{rid}  -> {"cancelled": bool}  (frees KV pages
                                  mid-prefill or mid-decode)
    GET    /v1/stats           -> EngineStats + cache_info + per-class
                                  metrics (InferenceServer.stats_snapshot /
                                  EngineRouter.stats_snapshot)
    GET    /v1/healthz         -> {"ok": true, "draining": bool}
    GET    /v1/load            -> outstanding-token / class-depth gauges
                                  (the remote router's placement signal)
    GET    /v1/prefix_feed?since=K
                               -> this engine's commit/reclaim chain-hash
                                  stream from K (the remote router mirrors
                                  it into its PrefixDirectory)

SIGINT/SIGTERM triggers graceful drain: stop admitting (503 on generate),
finish in-flight requests up to the drain deadline, abort stragglers with
pages verifiably reclaimed (``backend.close()`` asserts the pools refill),
then exit 0.

    python -m repro_torch.frontend.http_server --port 8763 --replicas 2
"""
from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import EventKind

SSE_HEADERS = (b"HTTP/1.1 200 OK\r\n"
               b"Content-Type: text/event-stream\r\n"
               b"Cache-Control: no-cache\r\n"
               b"Connection: close\r\n\r\n")


class _PrefixFeed:
    """Append-only export of one engine's commit/reclaim chain-hash stream
    (the ``BlockAllocator.listener`` protocol). A remote router polls
    ``/v1/prefix_feed`` and replays this log into its own
    :class:`PrefixDirectory` — the same events an in-process replica would
    deliver synchronously, just batched and late (staleness costs a missed
    routing hit, never correctness)."""

    def __init__(self):
        self.events: List[Tuple[str, str]] = []   # ("c"|"r", hash hex)

    def on_commit(self, chain_hash: bytes, depth: int) -> None:
        self.events.append(("c", chain_hash.hex()))

    def on_reclaim(self, chain_hash: bytes) -> None:
        self.events.append(("r", chain_hash.hex()))

    def since(self, k: int) -> Dict:
        k = max(0, min(k, len(self.events)))
        return {"events": self.events[k:], "next": len(self.events)}


class HttpFrontend:
    """One listening socket over one backend (an :class:`InferenceServer`
    or an :class:`EngineRouter` — both speak submit/cancel/subscribe/step/
    has_work/close/stats_snapshot)."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 8763,
                 drain_s: float = 30.0):
        self.backend = backend
        self.host, self.port = host, port
        self.drain_s = drain_s
        self._rid = 0
        self._queues: Dict[int, asyncio.Queue] = {}
        self._stopping = False
        self._stop_event: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        backend.subscribe(self._on_event)
        # single-engine backends export their commit/reclaim stream so a
        # remote router can mirror it; a router backend keeps its own
        # directory and exports nothing.
        self.feed: Optional[_PrefixFeed] = None
        core = getattr(backend, "core", None)
        if core is not None and core.cache_mode == "paged":
            self.feed = _PrefixFeed()
            core.alloc.listener = self.feed

    # ---- engine event fan-in (runs inside backend.step on the loop) ---------
    def _on_event(self, ev) -> None:
        q = self._queues.get(ev.rid)
        if q is not None:
            q.put_nowait(ev)

    # ---- engine pump ---------------------------------------------------------
    async def _pump(self) -> None:
        """The one place the engine advances: alternate ``step()`` with a
        zero-sleep so SSE writers interleave between rounds."""
        while True:
            if self.backend.has_work():
                self.backend.step()
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(0.002)

    # ---- HTTP plumbing -------------------------------------------------------
    @staticmethod
    async def _respond(writer: asyncio.StreamWriter, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        reason = {200: "OK", 404: "Not Found", 400: "Bad Request",
                  503: "Service Unavailable"}.get(code, "OK")
        writer.write(
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
        writer.close()

    @staticmethod
    def _sse(event: str, data: Dict) -> bytes:
        return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10.0)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError):
            writer.close()
            return
        try:
            lines = head.decode("latin1").split("\r\n")
            method, target, _ = lines[0].split(" ", 2)
            headers = {k.strip().lower(): v.strip() for k, v in
                       (l.split(":", 1) for l in lines[1:] if ":" in l)}
            clen = int(headers.get("content-length", "0"))
            body = await reader.readexactly(clen) if clen else b""
            path, _, query = target.partition("?")
            await self._route(method, path, query, body, writer)
        except ConnectionError:
            writer.close()
        except Exception as e:           # malformed request, bad JSON, ...
            try:
                await self._respond(writer, 400, {"error": str(e)})
            except ConnectionError:
                writer.close()

    async def _route(self, method: str, path: str, query: str,
                     body: bytes, writer: asyncio.StreamWriter) -> None:
        if method == "POST" and path == "/v1/generate":
            await self._generate(json.loads(body or b"{}"), writer)
        elif method == "DELETE" and path.startswith("/v1/requests/"):
            rid = int(path.rsplit("/", 1)[1])
            await self._respond(writer, 200,
                                {"rid": rid,
                                 "cancelled": bool(self.backend.cancel(rid))})
        elif method == "GET" and path == "/v1/stats":
            await self._respond(writer, 200, self.backend.stats_snapshot())
        elif method == "GET" and path == "/v1/healthz":
            await self._respond(writer, 200,
                                {"ok": True, "draining": self._stopping})
        elif method == "GET" and path == "/v1/load":
            await self._respond(writer, 200, self._load_info())
        elif method == "GET" and path == "/v1/prefix_feed":
            if self.feed is None:
                await self._respond(writer, 404,
                                    {"error": "no prefix feed (slot mode or "
                                              "router backend)"})
                return
            since = 0
            for kv in query.split("&"):
                if kv.startswith("since="):
                    since = int(kv[6:] or 0)
            await self._respond(writer, 200, self.feed.since(since))
        else:
            await self._respond(writer, 404, {"error": f"{method} {path}"})

    def _load_info(self) -> Dict:
        core = getattr(self.backend, "core", None)
        if core is None:                # router backend: aggregate
            reps = self.backend.replicas
            return {"outstanding_tokens": sum(r.outstanding_tokens()
                                              for r in reps),
                    "replicas": len(reps)}
        return {
            "outstanding_tokens": core.outstanding_tokens(),
            "queue_depth": core.queue_depth,
            "class_depth": [core.class_queue_depth(r) for r in (0, 1, 2)],
            "page_size": getattr(core, "page_size", 0),
        }

    # ---- generate (SSE) ------------------------------------------------------
    async def _generate(self, req: Dict, writer: asyncio.StreamWriter) -> None:
        if self._stopping:
            await self._respond(writer, 503, {"error": "draining"})
            return
        prompt = np.asarray(req["prompt"], np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            await self._respond(writer, 400, {"error": "prompt must be a "
                                                       "non-empty id list"})
            return
        rid = self._rid
        self._rid += 1
        # queue registered BEFORE submit: QUEUED fires synchronously inside
        # submit and must not be lost (single loop thread -> no race)
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q
        try:
            self.backend.submit(
                prompt,
                slo_class=req.get("slo_class", "standard"),
                max_output=int(req.get("max_output", 64)),
                eos_id=req.get("eos_id"),
                stop_ids=tuple(req.get("stop_ids", ())),
                rid=rid)
        except Exception as e:
            del self._queues[rid]
            await self._respond(writer, 503, {"error": str(e)})
            return
        writer.write(SSE_HEADERS)
        writer.write(self._sse("accepted", {"rid": rid}))
        n_tokens = 0
        pending = None
        try:
            await writer.drain()
            while True:
                if pending is not None:
                    ev, pending = pending, None
                else:
                    ev = await asyncio.wait_for(
                        q.get(), timeout=float(req.get("max_wall_s", 600.0)))
                data: Dict = {"rid": rid, "t": round(ev.t, 6)}
                if ev.kind in (EventKind.FIRST_TOKEN, EventKind.TOKEN):
                    # coalesce the round's burst: a speculative verify row
                    # emits several TOKEN events per engine round, and one
                    # SSE frame should carry the whole burst. `token` stays
                    # the first id for pre-batch consumers.
                    toks = [int(ev.token)]
                    if ev.kind is EventKind.TOKEN:
                        while True:
                            try:
                                nxt = q.get_nowait()
                            except asyncio.QueueEmpty:
                                break
                            if nxt.kind is EventKind.TOKEN:
                                toks.append(int(nxt.token))
                            else:
                                pending = nxt
                                break
                    data["token"] = toks[0]
                    data["tokens"] = toks
                    n_tokens += len(toks)
                if ev.kind in (EventKind.FINISHED, EventKind.ABORTED):
                    data["reason"] = (ev.reason or "length"
                                      if ev.kind is EventKind.FINISHED
                                      else "aborted")
                    data["n_tokens"] = n_tokens
                writer.write(self._sse(ev.kind.name.lower(), data))
                await writer.drain()
                if ev.kind in (EventKind.FINISHED, EventKind.ABORTED):
                    break
        except asyncio.TimeoutError:
            writer.write(self._sse("error", {"rid": rid,
                                             "error": "timeout"}))
            self.backend.cancel(rid)
        except (ConnectionError, asyncio.CancelledError):
            # client went away mid-stream: free its KV pages now
            self.backend.cancel(rid)
            raise
        finally:
            self._queues.pop(rid, None)
            writer.close()

    # ---- lifecycle -----------------------------------------------------------
    async def serve_forever(self) -> Dict:
        """Listen, pump, and block until SIGINT/SIGTERM (or ``request_stop``);
        then drain gracefully and return the backend's drain report."""
        self._stop_event = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()
        self._loop = loop
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._stop_event.set)
            except (NotImplementedError, RuntimeError):
                pass      # non-unix, or loop not on the main thread (tests)
        pump = asyncio.create_task(self._pump())
        print(f"listening on http://{self.host}:{self.port}", flush=True)
        await self._stop_event.wait()

        # graceful drain: no new admissions, let the pump finish in-flight
        # work to the deadline, then abort stragglers with pages reclaimed.
        self._stopping = True
        server.close()
        await server.wait_closed()
        deadline = loop.time() + self.drain_s
        while self.backend.has_work() and loop.time() < deadline:
            await asyncio.sleep(0.01)
        pump.cancel()
        report = self.backend.close(
            drain_s=max(deadline - loop.time(), 0.0))
        # let straggler ABORTED events reach any SSE writer still attached
        await asyncio.sleep(0.05)
        print(f"drained: {json.dumps(report, default=str)}", flush=True)
        return report

    def request_stop(self) -> None:
        """Trigger the same graceful drain as SIGINT (thread-safe: tests
        drive the server from a sibling thread)."""
        if self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)


def build_backend(arch: str = "llama3.2-3b", smoke: bool = True,
                  replicas: int = 1, policy: str = "prefix-affine",
                  cache_mode: str = "paged", kv_tokens: int = 4096,
                  page_size: int = 16, max_budget: int = 256,
                  prefix_cache: bool = True, max_output_default: int = 64,
                  **engine_kw):
    """An :class:`InferenceServer` (1 replica) or :class:`EngineRouter`
    (N replicas) ready to sit behind :class:`HttpFrontend`. Replicas share
    ``seed=0`` params, so greedy tokens depend only on the prompt and any
    placement yields bit-identical streams."""
    from repro_torch.configs import get_config
    from repro_torch.core import SlidingServeScheduler
    from repro_torch.frontend.router import EngineRouter, LocalReplica
    from repro_torch.serving.server import InferenceServer

    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()

    def mk_server():
        return InferenceServer.build(
            cfg,
            scheduler=SlidingServeScheduler(max_budget=max_budget,
                                            max_iter_time=5.0),
            cache_mode=cache_mode, max_slots=4, max_len=512,
            kv_capacity_tokens=kv_tokens, page_size=page_size,
            prefix_cache=prefix_cache, **engine_kw)

    if replicas <= 1:
        return mk_server()
    return EngineRouter([LocalReplica(i, mk_server())
                         for i in range(replicas)], policy=policy)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="stdlib HTTP/SSE front door over the serving stack")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8763,
                    help="0 picks a free port (printed on the banner line)")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 runs an in-process prefix-affine router")
    ap.add_argument("--policy", default="prefix-affine",
                    choices=["prefix-affine", "round-robin"])
    ap.add_argument("--cache-mode", default="paged",
                    choices=["auto", "slot", "paged"])
    ap.add_argument("--kv-tokens", type=int, default=4096)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-budget", type=int, default=256)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative drafts per decode round (0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--drain-s", type=float, default=30.0,
                    help="graceful-shutdown drain deadline on SIGINT")
    args = ap.parse_args(argv)

    backend = build_backend(
        arch=args.arch, smoke=args.smoke, replicas=args.replicas,
        policy=args.policy, cache_mode=args.cache_mode,
        kv_tokens=args.kv_tokens, page_size=args.page_size,
        max_budget=args.max_budget, prefix_cache=args.prefix_cache,
        spec_k=args.spec_k, temperature=args.temperature, top_k=args.top_k,
        sample_seed=args.sample_seed)
    frontend = HttpFrontend(backend, host=args.host, port=args.port,
                            drain_s=args.drain_s)
    asyncio.run(frontend.serve_forever())
    return 0


if __name__ == "__main__":
    sys.exit(main())
