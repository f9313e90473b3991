"""Cross-engine prefix directory: which replica holds which frozen prefix.

The per-engine radix index (``BlockAllocator``) names pages by *physical*
parent page id — exact, but meaningless outside its own allocator. The
directory generalises it across engines by re-keying on **hashed
page-granular token chains** (``page_chain_hash``): the chain hash of page k
folds the parent's chain hash with the page's token ids, so equal prompt
prefixes produce equal hashes on every replica and in every process.

The directory is *derived* state: it mirrors each replica's committed-page
set through the allocator's commit/reclaim notifications
(``BlockAllocator.listener``), never the other way around. A hit here is a
*routing hint* — the authoritative match still happens inside the chosen
replica's allocator at admission — so staleness (a reclaim racing a route)
costs a missed hit or a cold prefill, never a correctness failure.

``match(token_ids)`` walks the prompt page by page and reports, per replica,
the longest chain held from the root — the router steers the request to the
deepest holder (prefix affinity) unless that replica is saturated.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.serving.block_allocator import ROOT_CHAIN, page_chain_hash


class _ReplicaListener:
    """Allocator-facing adapter binding one replica id to the directory
    (the ``BlockAllocator.listener`` protocol)."""

    def __init__(self, directory: "PrefixDirectory", replica: int):
        self._dir = directory
        self._replica = replica

    def on_commit(self, chain_hash: bytes, depth: int) -> None:
        self._dir.on_commit(self._replica, chain_hash)

    def on_reclaim(self, chain_hash: bytes) -> None:
        self._dir.on_reclaim(self._replica, chain_hash)


class PrefixDirectory:
    """Shared chain-hash -> holder-replica map with per-replica accounting.

    Thread-safe: in-process replicas notify synchronously from the router's
    pump thread, while HTTP replicas apply polled feed events from whichever
    thread drives the client — a plain lock keeps both paths safe."""

    def __init__(self, page_size: int):
        assert page_size > 0
        self.page_size = page_size
        self._holders: Dict[bytes, Set[int]] = {}
        self._by_replica: Dict[int, Set[bytes]] = {}
        self._lock = threading.Lock()
        # lifetime accounting (the router's BENCH record reads these)
        self.commits = 0
        self.reclaims = 0
        self.lookups = 0
        self.hit_lookups = 0          # lookups that matched >= 1 page
        self.hit_tokens = 0           # tokens steered onto a holding replica

    def listener_for(self, replica: int) -> _ReplicaListener:
        """The ``BlockAllocator.listener`` for one replica's allocator."""
        with self._lock:
            self._by_replica.setdefault(replica, set())
        return _ReplicaListener(self, replica)

    # ---- updates (replica commit/reclaim events) ----------------------------
    def on_commit(self, replica: int, chain_hash: bytes) -> None:
        with self._lock:
            self._holders.setdefault(chain_hash, set()).add(replica)
            self._by_replica.setdefault(replica, set()).add(chain_hash)
            self.commits += 1

    def on_reclaim(self, replica: int, chain_hash: bytes) -> None:
        with self._lock:
            holders = self._holders.get(chain_hash)
            if holders is not None:
                holders.discard(replica)
                if not holders:
                    del self._holders[chain_hash]
            self._by_replica.setdefault(replica, set()).discard(chain_hash)
            self.reclaims += 1

    # ---- queries ------------------------------------------------------------
    def chain_hashes(self, token_ids: Sequence[int],
                     max_tokens: Optional[int] = None) -> List[bytes]:
        """Chain hashes of the whole pages of ``token_ids`` in order (the
        same fold the allocator applies at commit)."""
        limit = len(token_ids) if max_tokens is None else min(
            max_tokens, len(token_ids))
        ps = self.page_size
        out: List[bytes] = []
        h = ROOT_CHAIN
        for k in range(limit // ps):
            h = page_chain_hash(h, token_ids[k * ps:(k + 1) * ps])
            out.append(h)
        return out

    def match(self, token_ids: Sequence[int],
              max_tokens: Optional[int] = None) -> Dict[int, int]:
        """Per-replica longest held prefix of ``token_ids``, in tokens.

        Returns ``{replica: matched_tokens}`` for every replica holding at
        least the first page; a replica's count only extends while it holds
        every page of the chain so far (a deeper page held without its
        prefix is unreachable for reuse and does not count)."""
        chain = self.chain_hashes(token_ids, max_tokens)
        matched: Dict[int, int] = {}
        with self._lock:
            self.lookups += 1
            alive = set(self._holders.get(chain[0], ())) if chain else set()
            depth = 0
            for h in chain:
                holders = self._holders.get(h, set())
                alive &= holders
                if not alive:
                    break
                depth += 1
                for r in alive:
                    matched[r] = depth * self.page_size
            if matched:
                self.hit_lookups += 1
        return matched

    def pages_held(self, replica: int) -> int:
        with self._lock:
            return len(self._by_replica.get(replica, ()))

    def note_routed_hit(self, tokens: int) -> None:
        """Record that a request was steered onto a replica already holding
        ``tokens`` of its prefix (the router's directory-hit accounting)."""
        with self._lock:
            self.hit_tokens += tokens

    def stats(self) -> Dict:
        with self._lock:
            return {
                "page_size": self.page_size,
                "entries": len(self._holders),
                "pages_by_replica": {r: len(hs)
                                     for r, hs in self._by_replica.items()},
                "commits": self.commits,
                "reclaims": self.reclaims,
                "lookups": self.lookups,
                "hit_lookups": self.hit_lookups,
                "hit_rate": self.hit_lookups / max(self.lookups, 1),
                "routed_hit_tokens": self.hit_tokens,
            }
