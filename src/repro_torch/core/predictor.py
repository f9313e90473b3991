"""Batch Latency Predictor (paper §3.2).

Per-scene linear experts + a global fallback model (Eq. 5):

    T_hat = b^(m) + sum_j w_j^(m) x_j

Training combines offline initialization with online incremental updates:
sufficient statistics (X^T X, X^T y) are accumulated per scene with
exponential decay; every ``refit_interval`` observations the ridge solution is
recomputed and *hot-swapped* (the live coefficient set is replaced atomically,
mirroring the paper's background-thread calibration). A scene expert is only
activated once its sample count reaches ``expert_threshold``; otherwise the
global model answers (paper §3.2 "Model training").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.features import (NUM_FEATURES, SCENES, batch_features,
                                 features_many, scene_of)


@dataclasses.dataclass
class _LinModel:
    w: np.ndarray            # [NUM_FEATURES]
    b: float

    def predict(self, x: np.ndarray) -> float:
        return float(x @ self.w + self.b)


class _SceneStats:
    """Decayed sufficient statistics for ridge regression with intercept."""

    def __init__(self, dim: int, decay: float = 0.999):
        d = dim + 1
        self.xtx = np.zeros((d, d))
        self.xty = np.zeros(d)
        self.count = 0
        self.decay = decay
        self._xa = np.ones(d)               # reused augmented-feature buffer

    def add(self, x: np.ndarray, y: float) -> None:
        xa = self._xa
        xa[:-1] = x
        # in-place decay + rank-1 update: no per-observation allocations in
        # the serve loop's observe() path
        self.xtx *= self.decay
        self.xtx += xa[:, None] * xa[None, :]
        self.xty *= self.decay
        self.xty += xa * y
        self.count += 1

    def add_many(self, X: np.ndarray, y: np.ndarray) -> None:
        """Batched accumulation, equivalent to ``add`` in sample order:
        one decayed outer-product GEMM instead of n rank-1 updates."""
        n = len(y)
        if n == 0:
            return
        Xa = np.concatenate([X, np.ones((n, 1))], axis=1)
        w = self.decay ** np.arange(n - 1, -1, -1.0)
        self.xtx = (self.decay ** n) * self.xtx + (Xa * w[:, None]).T @ Xa
        self.xty = (self.decay ** n) * self.xty + (Xa * w[:, None]).T @ y
        self.count += n

    def solve(self, ridge: float) -> Optional[_LinModel]:
        if self.count == 0:
            return None
        d = self.xtx.shape[0]
        reg = ridge * np.eye(d)
        reg[-1, -1] = 1e-12  # do not regularize the intercept
        try:
            beta = np.linalg.solve(self.xtx + reg, self.xty)
        except np.linalg.LinAlgError:
            return None
        return _LinModel(w=beta[:-1], b=float(beta[-1]))


class BatchLatencyPredictor:
    """Scene-expert linear latency predictor with online hot-swap refit."""

    def __init__(self, ridge: float = 1e-4, expert_threshold: int = 64,
                 refit_interval: int = 256, feature_scale: float = 1e-4,
                 decay: float = 0.9995):
        self.ridge = ridge
        self.expert_threshold = expert_threshold
        self.refit_interval = refit_interval
        # feature magnitudes span ~6 orders; scale for conditioning
        self.fscale = feature_scale
        self.stats: Dict[str, _SceneStats] = {
            s: _SceneStats(NUM_FEATURES, decay) for s in SCENES}
        self.global_stats = _SceneStats(NUM_FEATURES, decay)
        self.models: Dict[str, Optional[_LinModel]] = {s: None for s in SCENES}
        self.global_model: Optional[_LinModel] = None
        self._since_refit = 0
        self.observed = 0

    # ---- featurization helpers ----------------------------------------------
    def _x(self, feats: np.ndarray) -> np.ndarray:
        return feats * self.fscale

    # ---- offline init (paper: "offline-collected batch runtime data") -------
    def fit_offline(self, samples: Sequence[Tuple[Sequence[Tuple[int, int]], float]]):
        if not samples:
            self._refit()
            return
        # batched accumulation: featurize once, then one decayed GEMM per
        # scene (and one global) instead of per-sample rank-1 updates.
        # Grouping by scene preserves each accumulator's sample order, so
        # the sufficient statistics match the sequential path.
        X, scenes, _ = features_many([b for b, _ in samples])
        X = X * self.fscale
        ys = np.asarray([y for _, y in samples], np.float64)
        for s in SCENES:
            idx = np.flatnonzero(scenes == s)
            if len(idx):
                self.stats[s].add_many(X[idx], ys[idx])
        self.global_stats.add_many(X, ys)
        self.observed += len(samples)
        self._refit()

    # ---- online path ---------------------------------------------------------
    def observe(self, batch, latency: float) -> None:
        self._accumulate(batch, latency)
        self._since_refit += 1
        if self._since_refit >= self.refit_interval:
            self._refit()   # hot swap

    def _accumulate(self, batch, y: float) -> None:
        feats, scene = batch_features(batch), scene_of(batch)
        x = self._x(feats)
        self.stats[scene].add(x, y)
        self.global_stats.add(x, y)
        self.observed += 1

    def _refit(self) -> None:
        new_models = {}
        for s in SCENES:
            st = self.stats[s]
            new_models[s] = st.solve(self.ridge) if st.count >= self.expert_threshold else None
        new_global = self.global_stats.solve(self.ridge)
        # hot swap: replace the whole coefficient set atomically
        self.models = new_models
        self.global_model = new_global
        self._since_refit = 0

    # ---- inference ------------------------------------------------------------
    def predict(self, batch) -> float:
        if not batch:
            return 0.0
        feats, scene = batch_features(batch), scene_of(batch)
        x = self._x(feats)
        model = self.models.get(scene) or self.global_model
        if model is None:
            # cold start: crude proportional guess keeps the scheduler alive
            return 1e-5 * float(sum(e[0] for e in batch) + 1)
        return max(model.predict(x), 1e-6)

    # ---- evaluation (paper Table 5) -------------------------------------------
    def predict_many(self, batches) -> np.ndarray:
        """Vectorized ``predict``: one matrix-vector product per scene expert
        instead of a Python-level dot per sample (keeps bulk evaluation off
        the serve loop's critical path)."""
        n = len(batches)
        yh = np.zeros(n)
        if n == 0:
            return yh
        X, scenes, csum = features_many(batches)
        X = X * self.fscale
        empty = np.asarray([not b for b in batches])
        for s in SCENES:
            idx = np.flatnonzero(scenes == s)
            if not len(idx):
                continue
            model = self.models.get(s) or self.global_model
            if model is None:
                # cold start: crude proportional guess (see ``predict``)
                yh[idx] = 1e-5 * (csum[idx] + 1.0)
            else:
                yh[idx] = np.maximum(X[idx] @ model.w + model.b, 1e-6)
        yh[empty] = 0.0
        return yh

    def evaluate(self, samples) -> dict:
        ys = np.asarray([y for _, y in samples], np.float64)
        yh = self.predict_many([b for b, _ in samples])
        err = yh - ys
        ss_res = float(np.sum(err ** 2))
        ss_tot = float(np.sum((ys - ys.mean()) ** 2)) or 1e-12
        return {
            "mae": float(np.mean(np.abs(err))),
            "rmse": float(np.sqrt(np.mean(err ** 2))),
            "r2": 1.0 - ss_res / ss_tot,
            "n": len(ys),
        }
