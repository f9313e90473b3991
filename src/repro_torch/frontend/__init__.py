"""Network front door: HTTP/SSE transport + prefix-affine multi-engine router.

The serving stack below this package is a single engine behind an in-process
streaming API. This package is the production edge on top of it:

* ``http_server`` — asyncio HTTP/SSE transport (stdlib-only) over the
  ``submit / tokens / cancel`` API; the engine needs no changes because
  ``EngineCore.step()`` is already single-stepped.
* ``router`` — N engine replicas behind one submit surface, with
  prefix-affine, load-aware, SLO-class-aware dispatch.
* ``prefix_directory`` — the cross-engine generalisation of the per-engine
  radix index: which replica holds which frozen page chain, keyed on hashed
  page-granular token chains and updated from each replica's commit/reclaim
  events.
* ``client`` — thin blocking HTTP client (SSE streaming, cancel, stats);
  also the ``HttpReplica`` adapter so the same router class can front N
  remote HTTP backends instead of in-process engines.
"""
from repro_torch.frontend.prefix_directory import PrefixDirectory  # noqa: F401
from repro_torch.frontend.router import EngineRouter, LocalReplica  # noqa: F401

_LAZY = {
    # http_server must not be imported eagerly: `python -m
    # repro_torch.frontend.http_server` imports this package first, and an eager
    # import would shadow the module runpy is about to execute
    "HttpFrontend": "repro_torch.frontend.http_server",
    "build_backend": "repro_torch.frontend.http_server",
    "EngineHttpClient": "repro_torch.frontend.client",
    "HttpReplica": "repro_torch.frontend.client",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
