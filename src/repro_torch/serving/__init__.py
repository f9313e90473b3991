"""Serving substrate: requests, queues, KV allocation, engine, simulator.

Online API surface (see README "Online API"):

* :class:`repro_torch.serving.engine.EngineCore` — step-based core
  (``add_request`` / ``abort`` / ``step`` / ``has_work``), emitting
  :class:`repro_torch.serving.engine.EngineEvent` per round.
* :class:`repro_torch.serving.server.InferenceServer` — streaming submit/cancel
  frontend with named SLO classes (``interactive``/``standard``/``batch``).
* ``EngineCore.serve()`` — offline compatibility wrapper (full request list
  in, blocking, identical greedy tokens and readback count).

(Import from the submodules directly — ``repro_torch.core.scheduler`` imports
``repro_torch.serving.request``, so re-exporting the engine here would close an
import cycle.)
"""
