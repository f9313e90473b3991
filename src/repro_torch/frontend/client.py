"""Thin blocking HTTP client for the front door (stdlib ``http.client``).

Two layers:

* :class:`EngineHttpClient` + :class:`HttpStreamHandle` — the caller-facing
  client: ``generate()`` POSTs a prompt and returns a handle whose
  ``tokens()`` iterator parses the SSE stream incrementally (the server
  closes the connection after the terminal event, so EOF == end of stream);
  ``cancel()`` DELETEs mid-stream on a second connection, freeing the
  request's KV pages remotely.

* :class:`HttpReplica` — the router-facing adapter: the same protocol
  :class:`LocalReplica` speaks (submit_request / cancel / load gauges /
  directory hookup), but over HTTP, so one ``EngineRouter`` fronts N remote
  backends. The remote engine pumps itself (the HTTP server owns its pump
  task), so ``step()`` here only mirrors the backend's prefix feed into the
  router's directory; load gauges come from ``GET /v1/load`` with a short
  cache so placement doesn't issue one HTTP round-trip per gauge read.
"""
from __future__ import annotations

import http.client
import json
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class HttpStreamHandle:
    """One in-flight ``/v1/generate`` stream. Mirrors the in-process
    :class:`StreamHandle` surface the drivers consume: ``tokens()`` /
    ``result()`` / ``cancel()`` / ``collected`` / ``finished`` /
    ``finish_reason`` / ``aborted``."""

    def __init__(self, client: "EngineHttpClient",
                 resp: http.client.HTTPResponse):
        self._client = client
        self._resp = resp
        self.rid: int = -1
        self.collected: List[int] = []
        self.finished = False
        self.finish_reason = ""
        self.first_token_t: Optional[float] = None
        self.events: List[Tuple[str, Dict]] = []
        # the `accepted` preamble carries the rid (needed for cancel before
        # any token arrives)
        name, data = self._read_event()
        assert name == "accepted", f"expected accepted, got {name}"
        self.rid = int(data["rid"])

    # ---- SSE parsing ---------------------------------------------------------
    def _read_event(self) -> Tuple[Optional[str], Dict]:
        """Next SSE event (blocking); ``(None, {})`` at EOF."""
        name, payload = None, ""
        while True:
            raw = self._resp.readline()
            if not raw:                       # server closed: stream over
                return None, {}
            line = raw.decode().rstrip("\n").rstrip("\r")
            if not line:                      # blank line ends one event
                if name is not None:
                    return name, json.loads(payload or "{}")
                continue
            if line.startswith("event:"):
                name = line[6:].strip()
            elif line.startswith("data:"):
                payload += line[5:].strip()

    def _apply(self, name: str, data: Dict) -> List[int]:
        self.events.append((name, data))
        if name in ("first_token", "token"):
            if name == "first_token":
                self.first_token_t = data.get("t")
            # a `token` frame carries the round's burst as `tokens: [ids]`
            # (speculative rounds emit several); older servers send only the
            # single `token` field.
            toks = [int(t) for t in data.get("tokens", [data["token"]])]
            self.collected.extend(toks)
            return toks
        if name in ("finished", "aborted", "error"):
            self.finished = True
            self.finish_reason = ("aborted" if name != "finished"
                                  else data.get("reason", "length"))
        return []

    # ---- client surface ------------------------------------------------------
    @property
    def aborted(self) -> bool:
        return self.finish_reason == "aborted"

    def tokens(self) -> Iterator[int]:
        """Yield output ids as SSE events arrive; returns at the terminal
        event (finished / aborted / connection close)."""
        while not self.finished:
            name, data = self._read_event()
            if name is None:
                self.finished = True
                self.finish_reason = self.finish_reason or "aborted"
                break
            for tok in self._apply(name, data):
                yield tok
        self._resp.close()

    def result(self) -> List[int]:
        for _ in self.tokens():
            pass
        return list(self.collected)

    def cancel(self) -> bool:
        """Cancel server-side (second connection; this stream then receives
        its terminal `aborted` event)."""
        return self._client.cancel(self.rid)


class EngineHttpClient:
    """Blocking JSON/SSE client for one front-door address."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8763,
                 timeout: float = 120.0):
        self.host, self.port, self.timeout = host, port, timeout

    def _conn(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _json(self, method: str, path: str, body: Optional[Dict] = None
              ) -> Dict:
        conn = self._conn()
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read() or b"{}")
            if resp.status >= 400:
                raise RuntimeError(f"{method} {path} -> {resp.status}: "
                                   f"{out.get('error', out)}")
            return out
        finally:
            conn.close()

    # ---- API -----------------------------------------------------------------
    def generate(self, prompt: Sequence[int], slo_class: str = "standard",
                 max_output: int = 64, eos_id: Optional[int] = None,
                 stop_ids: Sequence[int] = ()) -> HttpStreamHandle:
        conn = self._conn()
        conn.request("POST", "/v1/generate", body=json.dumps({
            "prompt": [int(t) for t in prompt],
            "slo_class": slo_class, "max_output": int(max_output),
            "eos_id": eos_id, "stop_ids": [int(t) for t in stop_ids],
        }), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            err = json.loads(resp.read() or b"{}")
            conn.close()
            raise RuntimeError(f"generate -> {resp.status}: "
                               f"{err.get('error', err)}")
        return HttpStreamHandle(self, resp)

    def cancel(self, rid: int) -> bool:
        return bool(self._json("DELETE", f"/v1/requests/{rid}")["cancelled"])

    def stats(self) -> Dict:
        return self._json("GET", "/v1/stats")

    def healthz(self) -> Dict:
        return self._json("GET", "/v1/healthz")

    def load(self) -> Dict:
        return self._json("GET", "/v1/load")

    def prefix_feed(self, since: int = 0) -> Dict:
        return self._json("GET", f"/v1/prefix_feed?since={since}")

    def wait_ready(self, deadline_s: float = 30.0) -> None:
        t_end = time.perf_counter() + deadline_s
        while time.perf_counter() < t_end:
            try:
                if self.healthz().get("ok"):
                    return
            except (OSError, RuntimeError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"server {self.host}:{self.port} not ready")


class HttpReplica:
    """Router-facing adapter over one remote front door — the same protocol
    as :class:`LocalReplica`, minus local pumping (the remote server pumps
    itself). The router's rid space and the remote's are independent:
    ``submit_request`` records the router-rid -> remote-rid mapping and
    cancels translate through it."""

    LOAD_TTL_S = 0.05      # gauge cache: at most one /v1/load per placement

    def __init__(self, index: int, client: EngineHttpClient):
        self.index = index
        self.client = client
        self.cost_per_token = 2e-4       # prior; no local step timing
        self._directory = None
        self._feed_pos = 0
        self._load: Optional[Dict] = None
        self._load_t = -1.0
        self._remote_rid: Dict[int, int] = {}
        self._page_size: Optional[int] = None

    # ---- directory hookup ----------------------------------------------------
    @property
    def page_size(self) -> int:
        if self._page_size is None:
            self._page_size = int(self._load_info().get("page_size", 0))
        return self._page_size

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    def attach_directory(self, directory) -> None:
        self._directory = directory

    def poll_feed(self) -> int:
        """Mirror the backend's commit/reclaim stream into the router's
        directory; returns how many events were applied."""
        if self._directory is None or not self.paged:
            return 0
        try:
            feed = self.client.prefix_feed(since=self._feed_pos)
        except (OSError, RuntimeError):
            return 0
        for op, hex_hash in feed["events"]:
            h = bytes.fromhex(hex_hash)
            if op == "c":
                self._directory.on_commit(self.index, h)
            else:
                self._directory.on_reclaim(self.index, h)
        applied = feed["next"] - self._feed_pos
        self._feed_pos = feed["next"]
        return applied

    # ---- submit / cancel -----------------------------------------------------
    def submit_request(self, req, prompt: Sequence[int]) -> HttpStreamHandle:
        h = self.client.generate(
            np.asarray(prompt, np.int32).tolist(),
            slo_class=req.slo_class, max_output=req.max_output,
            eos_id=req.eos_id, stop_ids=req.stop_ids)
        self._remote_rid[req.rid] = h.rid
        return h

    def cancel(self, rid: int) -> bool:
        remote = self._remote_rid.get(rid)
        if remote is None:
            return False
        try:
            return self.client.cancel(remote)
        except (OSError, RuntimeError):
            return False

    # ---- pumping (remote pumps itself) ---------------------------------------
    def has_work(self) -> bool:
        return self._load_info().get("outstanding_tokens", 0) > 0

    def step(self) -> List:
        self.poll_feed()
        return []

    def progress(self) -> str:
        return "executed" if self.has_work() else "idle"

    def stalled(self) -> bool:
        return False

    def flush(self) -> None:
        self.poll_feed()

    # ---- router gauges -------------------------------------------------------
    def _load_info(self) -> Dict:
        now = time.perf_counter()
        if self._load is None or now - self._load_t > self.LOAD_TTL_S:
            try:
                self._load = self.client.load()
                self._load_t = now
            except (OSError, RuntimeError):
                self._load = self._load or {}
        return self._load

    def outstanding_tokens(self) -> int:
        return int(self._load_info().get("outstanding_tokens", 0))

    def load_cost(self) -> float:
        return self.outstanding_tokens() * self.cost_per_token

    def class_ahead(self, max_rank: int) -> int:
        depth = self._load_info().get("class_depth")
        if not depth:
            return 0
        return int(depth[min(max_rank, len(depth) - 1)])

    def now(self) -> float:
        return time.perf_counter()

    # ---- lifecycle / reporting -----------------------------------------------
    def close(self, drain_s: float = 30.0) -> Dict:
        """The remote server owns its own drain (SIGINT); nothing to do from
        the client side but report what finished through this adapter."""
        self.poll_feed()
        return {"drained": True, "finished": 0, "aborted": 0}

    def stats_snapshot(self) -> Dict:
        return self.client.stats()
