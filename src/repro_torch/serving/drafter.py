"""Model-free draft proposers for speculative decoding.

The engine asks a drafter for up to ``k`` candidate continuation tokens per
decode-eligible request per round; candidates execute as one multi-token
verify row through the fused paged-prefill path and are accepted/rejected on
device (see ``models.model.paged_spec_step``). The interface is deliberately
minimal so a real draft model (a small on-device LM sharing the readback, or
a tree/medusa-style proposer) can slot in later: anything with
``propose(context, k) -> Optional[np.ndarray]`` works.

The first cut is **prompt lookup** (n-gram) drafting: find the most recent
earlier occurrence of the transcript's trailing n-gram and propose the
tokens that followed it. Free (no model call, pure host numpy on arrays the
engine already holds), and effective exactly where speculation pays —
repetitive or reference-heavy continuations (code, extraction, multi-turn
chat re-quoting its own context).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class DrafterBase:
    """Draft-proposal interface. ``context`` is the request's full visible
    transcript (prompt + emitted tokens, int32) and ``k`` the maximum drafts
    wanted; return up to ``k`` proposed next tokens, or ``None``/empty when
    there is nothing worth proposing (the engine then runs a plain decode
    row — never a degenerate 0-draft verify row)."""

    def propose(self, context: np.ndarray, k: int) -> Optional[np.ndarray]:
        raise NotImplementedError


class NGramDrafter(DrafterBase):
    """Prompt-lookup drafting: match the transcript's trailing ``n``-gram
    (longest first, ``max_ngram`` down to ``min_ngram``) against the rest of
    the transcript and propose the continuation of the most recent prior
    occurrence."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: Sequence[int], k: int) -> Optional[np.ndarray]:
        ctx = np.asarray(context, np.int32)
        L = len(ctx)
        if k <= 0 or L < self.min_ngram + 1:
            return None
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            tgt = ctx[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero((win == tgt).all(axis=1))
            # the last window IS the target; earlier hits are real matches.
            # The continuation may overlap the suffix itself — that is the
            # classic repetition case and exactly what we want to propose.
            hits = hits[hits < L - n]
            if len(hits) == 0:
                continue
            i = int(hits[-1])
            cont = ctx[i + n:i + n + k]
            if len(cont):
                return cont.astype(np.int32)
        return None
