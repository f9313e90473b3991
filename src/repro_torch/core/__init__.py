"""SlidingServe core: the paper's contribution.

- ``features`` / ``predictor`` — §3.2 batch latency predictor (per-scene
  linear experts over the 7-dim feature vector of Table 1, offline init +
  online incremental refit with hot-swap).
- ``sorter`` — §3.3 Multi-Level Priority Sorter (Eq. 6-13).
- ``forwarder`` — the BatchForwarder F of Alg. 1/2 (Forward / Pred /
  TimeToBudget).
- ``sliding_chunker`` — §3.4 Alg. 1 (two-iteration sliding-window budget
  split via discrete ternary search).
- ``batch_constructor`` — §3.5 Alg. 2 (anchor + 0/1-knapsack request
  selection under TTFT risk).
- ``scheduler`` — the closed loop (Fig. 3) + the Violation Checker routing.
- ``baselines`` — Sarathi-EDF, QoServe-like, vLLM-FCFS, single-step greedy.
"""
from repro_torch.core.scheduler import KVPressure, SlidingServeScheduler  # noqa: F401
from repro_torch.core.baselines import (  # noqa: F401
    FCFSStaticScheduler, QoServeLikeScheduler, SarathiEDFScheduler,
    SingleStepGreedyScheduler,
)
