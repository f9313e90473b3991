"""Batch feature construction (paper §3.2, Table 1).

A batch is ``[(c_i, u_i)]`` or ``[(c_i, u_i, s_i)]``: tokens scheduled this
round, tokens already cached, and (optionally) speculative draft tokens
riding the row — a verify row of k drafts is ``(1 + k, u, k)``. Requests
split into decode (base width ``c_i - s_i <= 1``) and prefill sets (Eq. 2);
verify rows stay in the decode set — they are decode work that happens to be
k+1 tokens wide — and their extra cost is carried by feature x8 instead of
leaking into the prefill features. The scene label (Eq. 3) selects the
expert model.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SCENES = ("pure_decode", "pure_prefill", "mixed")
NUM_FEATURES = 8


def _norm(e) -> Tuple[int, int, int]:
    """Entry -> (c, u, s); plain (c, u) pairs carry s = 0."""
    return (e[0], e[1], e[2] if len(e) > 2 else 0)


def split_sets(batch: Sequence[Tuple]):
    """Eq. 2 over base (non-speculative) widths:
    D = {i | c_i - s_i <= 1}, P = {i | c_i - s_i > 1}."""
    D, P = [], []
    for e in batch:
        c, u, s = _norm(e)
        (D if c - s <= 1 else P).append((c, u, s))
    return D, P


def scene_of(batch: Sequence[Tuple]) -> str:
    """Eq. 3."""
    D, P = split_sets(batch)
    if not P:
        return "pure_decode"
    if not D:
        return "pure_prefill"
    return "mixed"


def batch_features(batch: Sequence[Tuple]) -> np.ndarray:
    """Table 1's feature vector x, extended with x8 for speculation.

    x8 is the verify-row attention/compute mass ``sum_D (c-1) * (u + c)``:
    zero without speculation (every decode row has c = 1), and scaling with
    both draft count and context for verify rows — whose cost x1..x7 would
    otherwise record as a plain 1-token decode."""
    D, P = split_sets(batch)
    x1 = float(sum(c * (u + c) for c, u, _ in P))  # prefill attention complexity
    x2 = float(sum(c * c for c, u, _ in P))        # chunk self-attention
    x3 = float(sum(_norm(e)[1] for e in batch))    # total cached tokens
    x4 = float(len(D))                             # decode request count
    x5 = float(sum(u for _, u, _ in D))            # decode cumulative context
    x6 = float(sum(c for c, _, _ in P))            # total prefill tokens
    x7 = float(max((c for c, _, _ in P), default=0))  # max single prefill chunk
    x8 = float(sum((c - 1) * (u + c) for c, u, _ in D))  # verify-row mass
    return np.array([x1, x2, x3, x4, x5, x6, x7, x8], dtype=np.float64)


def featurize(batch: Sequence[Tuple]) -> Tuple[np.ndarray, str]:
    return batch_features(batch), scene_of(batch)


def features_many(batches: Sequence[Sequence[Tuple]]):
    """Vectorized ``featurize`` over many batches.

    Returns ``(X [N, NUM_FEATURES], scenes [N], csum [N])`` where ``csum`` is
    each batch's total scheduled tokens (the cold-start predictor input).
    Segment reductions (``bincount`` / ``maximum.at``) over the flattened
    (c, u, s) triples replace N python-level ``batch_features`` calls."""
    n = len(batches)
    X = np.zeros((n, NUM_FEATURES), dtype=np.float64)
    scenes = np.full(n, "pure_decode", dtype=object)
    csum = np.zeros(n, dtype=np.float64)
    flat = [cu for b in batches for cu in b]
    if not flat:
        return X, scenes, csum
    seg = np.repeat(np.arange(n), [len(b) for b in batches])
    widths = {len(e) for e in flat}
    if widths == {2}:
        pairs = np.asarray(flat, dtype=np.float64)
        cus = np.concatenate([pairs, np.zeros((len(flat), 1))], axis=1)
    elif widths == {3}:
        cus = np.asarray(flat, dtype=np.float64)
    else:   # mixed widths: normalize entry by entry
        cus = np.asarray([_norm(e) for e in flat], dtype=np.float64)
    c, u, s = cus[:, 0], cus[:, 1], cus[:, 2]
    P = (c - s) > 1
    D = ~P
    X[:, 0] = np.bincount(seg[P], weights=(c * (u + c))[P], minlength=n)
    X[:, 1] = np.bincount(seg[P], weights=(c * c)[P], minlength=n)
    X[:, 2] = np.bincount(seg, weights=u, minlength=n)
    X[:, 3] = np.bincount(seg[D], minlength=n)
    X[:, 4] = np.bincount(seg[D], weights=u[D], minlength=n)
    X[:, 5] = np.bincount(seg[P], weights=c[P], minlength=n)
    np.maximum.at(X[:, 6], seg[P], c[P])
    X[:, 7] = np.bincount(seg[D], weights=((c - 1) * (u + c))[D], minlength=n)
    has_p = np.bincount(seg[P], minlength=n) > 0
    has_d = np.bincount(seg[D], minlength=n) > 0
    scenes[has_p] = "pure_prefill"
    scenes[has_p & has_d] = "mixed"
    csum[:] = np.bincount(seg, weights=c, minlength=n)
    return X, scenes, csum
