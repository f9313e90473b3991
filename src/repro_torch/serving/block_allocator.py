"""Paged KV-cache block allocator with a copy-on-write radix prefix cache.

Token storage is paged into fixed-size blocks; requests own block lists that
grow as prefill/decode advances. The allocator is the *single* admission /
preemption authority shared by the real ``ServingEngine`` and the analytic
``ServingSimulator``: a request is admitted only when its full prompt plus a
decode reserve fits, growth happens per emitted/prefilled token, and decode
growth failures trigger eviction of the lowest-priority owner
(recompute-on-resume policy, ``pick_victim``).

Beyond pure accounting the allocator hands out *physical page ids* from a
free list; the engine turns an owner's ``page_ids`` into the block table rows
the paged attention kernels consume. The analytic simulator ignores the ids
and uses only the counting API — both views are kept consistent by
``check_invariants``. Page ids and token slots (``page*page_size + offset``)
are **layout-independent**: the fused head-interleaved KV pool
(``[Hkv, P, 2, ps, D]``, ``models.model.PAGED_KV_LAYOUT``) changed the
physical bytes behind a page without touching this accounting, the radix
index, or COW semantics — only the engine-side scatter
(``write_pages_fused``) and the kernels interpret the layout.

**Prefix cache (radix/COW layer).** Full pages whose token content is known
can be *committed* into a content index keyed by the chain
``(parent_page_id, page_token_ids)`` — the parent's physical id uniquely
names the whole prefix below it, so lookups are exact (no hash collisions)
and the index is a radix tree over page-granular token runs. Committed pages
carry a **refcount** (how many owners hold them); ``match_prefix`` lets
admission reuse a frozen prefix chain, increfing each matched page instead
of recomputing it. Sharing is copy-on-write in the only form a paged KV
cache needs: shared pages are *never written* (writes land exclusively in
freshly allocated pages at positions past the matched prefix; partial tail
pages are recomputed rather than copied), so no true page copy ever happens.

Page lifecycle is a three-state machine, which is also the eviction tier
order:

    free  <- allocation pops these first
    cached  (refcount 0, still in the index)  <- reclaimed LRU, leaves first,
            invalidating the index entry, *before* any live request is evicted
    live  (refcount > 0)  <- only evict-and-recompute of a whole owner can
            release these, and releasing an owner merely decrefs: a page
            shared with another live owner is never touched

``free_blocks`` reports free + cached (everything obtainable without
relegating a live request), so legacy capacity checks — and the engine's
"pool fully released" leak assertions — keep their meaning with the cache
populated.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PageKey = Tuple[int, Tuple[int, ...]]   # (parent page id or -1, page tokens)

# Root of every page-chain hash (the hash "above" a prompt's first page).
ROOT_CHAIN = b"\x00" * 8


def page_chain_hash(parent_hash: bytes, chunk: Sequence[int]) -> bytes:
    """Position-independent content name of one page *in its chain*: the
    parent chain hash folded with the page's token ids. Unlike ``PageKey``
    (which names the parent by *physical* page id and is only meaningful
    inside one allocator), chain hashes are stable across engines and
    processes — the cross-engine prefix directory is keyed on them."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash)
    h.update(" ".join(str(int(t)) for t in chunk).encode())
    return h.digest()


@dataclasses.dataclass
class _Owner:
    rid: int
    blocks: int
    tokens: int
    page_ids: List[int] = dataclasses.field(default_factory=list)
    cached_tokens: int = 0        # prefix tokens reused from the index at admit
    committed_pages: int = 0      # commit pointer: page_ids[:k] are in the index
    commit_stalled: bool = False  # first-writer-wins conflict: pointer is final


@dataclasses.dataclass
class _Node:
    """One committed (index-resident) page."""
    pid: int
    key: PageKey
    parent: int                   # parent pid, -1 at the root
    children: int = 0             # committed children (reclaim leaves first)
    refs: int = 0                 # owners holding this page
    last_used: int = 0            # LRU clock tick of the last match/commit
    chain_hash: bytes = b""       # cross-engine content name (page_chain_hash)


class BlockAllocator:
    def __init__(self, capacity_tokens: int, block_size: int = 16):
        assert capacity_tokens > 0 and block_size > 0
        self.block_size = block_size
        self.num_blocks = capacity_tokens // block_size
        # LIFO free list of physical page ids (reuse-hot pages first)
        self._free_ids: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.owners: Dict[int, _Owner] = {}
        self.evictions = 0            # lifetime eviction count (KV pressure)
        self.peak_used_blocks = 0     # high-water mark (per-shard accounting)
        # ---- prefix-cache state ---------------------------------------------
        self._nodes: Dict[int, _Node] = {}          # pid -> committed page
        self._index: Dict[PageKey, int] = {}        # content chain -> pid
        # refcount-0 committed pages in insertion (≈LRU) order
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._clock = 0
        self.cache_commits = 0        # lifetime pages frozen into the index
        self.cache_hit_tokens = 0     # lifetime tokens served from the index
        self.cache_reclaimed = 0      # lifetime cached pages reclaimed (tier 1)
        # Optional commit/reclaim observer (``on_commit(chain_hash, depth)`` /
        # ``on_reclaim(chain_hash)``): the cross-engine prefix directory
        # mirrors this allocator's index through these notifications.
        self.listener = None

    # ---- queries --------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Pages obtainable without evicting a live owner: the free list plus
        refcount-0 cached pages (reclaimable, tier-1 eviction)."""
        return len(self._free_ids) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 committed pages (reclaimable prefix cache)."""
        return len(self._cached)

    @property
    def live_blocks(self) -> int:
        """Pages held by at least one live owner."""
        return self.num_blocks - self.free_blocks

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_admit(self, prompt_len: int, reserve_tokens: int = 0) -> bool:
        return self.blocks_for(prompt_len + reserve_tokens) <= self.free_blocks

    def used_tokens(self) -> int:
        return sum(o.tokens for o in self.owners.values())

    def free_tokens(self) -> int:
        """Upper bound on new tokens storable without eviction (whole free +
        reclaimable pages plus the tail slack of each owner's last page)."""
        slack = sum(o.blocks * self.block_size - o.tokens
                    for o in self.owners.values())
        return self.free_blocks * self.block_size + slack

    def utilization(self) -> float:
        return 1.0 - self.free_blocks / self.num_blocks

    def page_table(self, rid: int) -> List[int]:
        """Physical page ids backing ``rid`` in logical order."""
        return list(self.owners[rid].page_ids)

    def cached_tokens(self, rid: int) -> int:
        """Prefix tokens ``rid`` reused from the index at admission."""
        return self.owners[rid].cached_tokens

    def committed_count(self, rid: int) -> int:
        """How many of ``rid``'s leading pages are frozen in the index."""
        return self.owners[rid].committed_pages

    def commit_stalled(self, rid: int) -> bool:
        """True once ``rid``'s commit pointer hit a first-writer-wins
        conflict — further ``commit`` calls cannot advance it, so callers
        should stop re-deriving content for this owner."""
        return self.owners[rid].commit_stalled

    def referenced_committed_blocks(self) -> int:
        """Committed pages held by at least one live owner (each holds
        exactly ``block_size`` written tokens, counted once however many
        owners share it)."""
        return len(self._nodes) - len(self._cached)

    def shard_stats(self, num_shards: int = 1) -> Dict:
        """Per-shard page-pool accounting for the sharded serving executor.

        A head-sharded pool stores every page id on every shard but only
        ``1/num_shards`` of each page's bytes (KV heads are the sharded dim),
        so page *counts* replicate across shards while byte capacity divides;
        ``num_shards=1`` also covers the replicated sequence-sharded
        fallback. The peak high-water mark feeds the per-shard allocator
        imbalance follow-on (ROADMAP)."""
        used = self.num_blocks - self.free_blocks
        return {
            "kv_pool_shards": num_shards,
            "pages_total": self.num_blocks,
            "pages_used": used,
            "pages_free": self.free_blocks,
            "pages_cached": self.cached_blocks,
            "peak_pages_used": self.peak_used_blocks,
            "utilization": self.utilization(),
            "tokens_capacity_per_shard": self.num_blocks * self.block_size,
        }

    def cache_stats(self) -> Dict:
        """Prefix-cache accounting (BENCH_goodput.json record)."""
        return {
            "cached_pages": self.cached_blocks,
            "committed_pages": len(self._nodes),
            "cache_commits": self.cache_commits,
            "cache_hit_tokens": self.cache_hit_tokens,
            "cache_reclaimed_pages": self.cache_reclaimed,
        }

    def _note_usage(self) -> None:
        self.peak_used_blocks = max(self.peak_used_blocks,
                                    self.num_blocks - self.free_blocks)

    # ---- prefix cache: match / commit / reclaim --------------------------------
    def _page_chunks(self, token_ids: Sequence[int], n_pages: int):
        ps = self.block_size
        for k in range(n_pages):
            yield tuple(int(t) for t in token_ids[k * ps:(k + 1) * ps])

    def match_prefix(self, token_ids: Sequence[int],
                     max_tokens: Optional[int] = None
                     ) -> Tuple[List[int], int]:
        """Longest frozen prefix of ``token_ids`` in the index, as
        ``(page_ids, matched_len)``. Pure query — no refcounts move (admit
        with the same ids to actually take the pages). ``max_tokens`` caps
        the match (the engine passes ``prompt_len - 1`` so at least one
        prompt token is always computed to produce first-token logits);
        matches are whole-page granular."""
        limit = len(token_ids) if max_tokens is None else min(
            max_tokens, len(token_ids))
        n_pages = limit // self.block_size
        out: List[int] = []
        parent = -1
        for chunk in self._page_chunks(token_ids, n_pages):
            pid = self._index.get((parent, chunk))
            if pid is None:
                break
            out.append(pid)
            parent = pid
        return out, len(out) * self.block_size

    def _incref(self, pid: int) -> None:
        node = self._nodes[pid]
        if node.refs == 0:
            self._cached.pop(pid, None)
        node.refs += 1
        self._clock += 1
        node.last_used = self._clock

    def _decref(self, pid: int) -> None:
        node = self._nodes.get(pid)
        if node is None:
            self._free_ids.append(pid)
            return
        node.refs -= 1
        assert node.refs >= 0, f"refcount underflow on page {pid}"
        if node.refs == 0:
            self._cached[pid] = None      # newest at the end (LRU order)

    def _reclaim_one(self) -> Optional[int]:
        """Tier-1 eviction: drop the least-recently-used cached *leaf* page
        from the index and return its id. Leaves first keeps every surviving
        chain matchable from the root; a page with live-ref children cannot
        be cached itself (an owner holding a child holds its whole prefix),
        so scanning ``_cached`` for ``children == 0`` always succeeds when
        the pool is non-empty."""
        for pid in self._cached:
            node = self._nodes[pid]
            if node.children == 0:
                del self._cached[pid]
                del self._nodes[pid]
                self._index.pop(node.key, None)
                parent = self._nodes.get(node.parent)
                if parent is not None:
                    parent.children -= 1
                self.cache_reclaimed += 1
                if self.listener is not None:
                    self.listener.on_reclaim(node.chain_hash)
                return pid
        return None

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` physical pages: free list first, then reclaim cached
        pages (LRU leaves). Returns None (taking nothing) if even the cache
        cannot cover the request."""
        if n > len(self._free_ids) + len(self._cached):
            return None
        out: List[int] = []
        for _ in range(n):
            if self._free_ids:
                out.append(self._free_ids.pop())
            else:
                pid = self._reclaim_one()
                assert pid is not None, "cached pool scan failed"
                out.append(pid)
        return out

    def commit(self, rid: int, content_ids: Sequence[int],
               upto_tokens: int) -> int:
        """Freeze ``rid``'s fully-written leading pages into the index.

        ``content_ids[:upto_tokens]`` is the token content of the owner's
        cache (prompt, plus emitted tokens for decode pages); only whole
        pages are committed, continuing from the owner's commit pointer.
        A chain position whose key already names a *different* physical page
        (an identical prompt prefilled concurrently) stays uncommitted —
        first writer wins and the pointer stalls there, which only costs a
        missed future match. Returns pages newly committed."""
        o = self.owners[rid]
        full = min(upto_tokens, len(content_ids)) // self.block_size
        done = 0
        ps = self.block_size
        while o.committed_pages < full:
            k = o.committed_pages
            pid = o.page_ids[k]
            parent = o.page_ids[k - 1] if k > 0 else -1
            if parent != -1 and parent not in self._nodes:
                o.commit_stalled = True    # chain broken by an earlier stall
                break
            if pid in self._nodes:         # already frozen (matched page)
                o.committed_pages += 1
                continue
            chunk = tuple(int(t) for t in content_ids[k * ps:(k + 1) * ps])
            key: PageKey = (parent, chunk)
            if key in self._index:
                o.commit_stalled = True    # duplicate content, first wins
                break
            self._clock += 1
            parent_chain = (ROOT_CHAIN if parent == -1
                            else self._nodes[parent].chain_hash)
            self._nodes[pid] = _Node(pid, key, parent, refs=1,
                                     last_used=self._clock,
                                     chain_hash=page_chain_hash(parent_chain,
                                                                chunk))
            self._index[key] = pid
            if parent != -1:
                self._nodes[parent].children += 1
            o.committed_pages += 1
            self.cache_commits += 1
            done += 1
            if self.listener is not None:
                self.listener.on_commit(self._nodes[pid].chain_hash, k + 1)
        return done

    # ---- lifecycle --------------------------------------------------------------
    def admit(self, rid: int, initial_tokens: int = 0,
              token_ids: Optional[Sequence[int]] = None,
              match_limit: Optional[int] = None) -> bool:
        """Reserve ``initial_tokens`` for ``rid``. With ``token_ids`` the
        prefix cache is consulted first: matched frozen pages are reused
        (increfed) and only the remainder is allocated fresh; read the hit
        back via ``cached_tokens(rid)``. Without ids the legacy counting
        behaviour is exact (the analytic simulator's path)."""
        assert rid not in self.owners, f"double admit {rid}"
        matched: List[int] = []
        if token_ids is not None and initial_tokens > 0:
            matched, _ = self.match_prefix(token_ids, max_tokens=match_limit)
        total = self.blocks_for(initial_tokens) if initial_tokens else 0
        matched = matched[:total]
        need = total - len(matched)
        # matched cached pages leave the reclaimable pool on incref, so they
        # cannot double as supply for the fresh remainder
        supply = len(self._free_ids) + len(self._cached) \
            - sum(1 for pid in matched if self._nodes[pid].refs == 0)
        if need > supply:
            return False
        for pid in matched:
            self._incref(pid)
        fresh = self._alloc_pages(need)
        assert fresh is not None, "supply check out of sync"
        cached_tok = len(matched) * self.block_size
        self.owners[rid] = _Owner(rid, total, initial_tokens,
                                  matched + fresh,
                                  cached_tokens=cached_tok,
                                  committed_pages=len(matched))
        self.cache_hit_tokens += cached_tok
        self._note_usage()
        return True

    def grow(self, rid: int, new_tokens: int) -> bool:
        """Extend rid's allocation to cover ``new_tokens`` total tokens."""
        o = self.owners[rid]
        if new_tokens <= o.tokens:
            return True
        need = self.blocks_for(new_tokens) - o.blocks
        if need > 0:
            fresh = self._alloc_pages(need)
            if fresh is None:
                return False
            o.page_ids.extend(fresh)
            o.blocks += need
        o.tokens = new_tokens
        self._note_usage()
        return True

    def free(self, rid: int) -> None:
        """Release ``rid``'s hold: committed pages are decrefed (surviving
        as reclaimable cache when no other owner holds them), private
        uncommitted pages return to the free list."""
        o = self.owners.pop(rid, None)
        if o is not None:
            for pid in o.page_ids:
                self._decref(pid)

    # ---- preemption policy ------------------------------------------------------
    def pick_victim(self, needy_rid: int,
                    priority: Callable[[int], float],
                    eligible: Optional[Callable[[int], bool]] = None
                    ) -> Optional[int]:
        """Lowest-priority owner (largest ``priority(rid)`` key) other than
        the needy request — the shared evict-and-recompute policy (tier-2
        eviction; refcount-0 cached pages are always reclaimed first by
        ``grow``/``admit``). Callers pass e.g. ``priority=arrival_of`` so the
        newest request is relegated first (vLLM recompute order).
        ``eligible`` filters the candidate set (the engine's SLO-class
        guard: a victim of a more latency-critical class than the needy
        request is never relegated — e.g. ``batch`` growth cannot evict
        ``interactive``)."""
        cands = [rid for rid in self.owners
                 if rid != needy_rid and (eligible is None or eligible(rid))]
        if not cands:
            return None
        return max(cands, key=priority)

    def evict(self, rid: int) -> None:
        """Release a victim's hold and count the eviction. Pages shared with
        another live owner are merely decrefed — a live ref is never
        touched, only the victim's *exclusive* pages become reclaimable."""
        assert rid in self.owners, f"evicting non-owner {rid}"
        self.free(rid)
        self.evictions += 1

    # ---- invariants (property-tested) -------------------------------------------
    def check_invariants(self) -> None:
        held = {pid for o in self.owners.values() for pid in o.page_ids}
        free = set(self._free_ids)
        cached = set(self._cached)
        assert len(free) == len(self._free_ids), "free id duplicated"
        assert not free & held, "page both free and owned"
        assert not free & cached, "page both free and cached"
        assert not cached & held, "cached page still owned"
        assert free | cached | held == set(range(self.num_blocks)), \
            "page leak"
        assert all(len(o.page_ids) == o.blocks for o in self.owners.values()), \
            "owner id/block mismatch"
        for o in self.owners.values():
            assert o.blocks * self.block_size >= o.tokens, \
                "owner under-allocated"
            assert o.committed_pages <= o.blocks
            assert all(pid in self._nodes
                       for pid in o.page_ids[:o.committed_pages]), \
                "commit pointer past an unfrozen page"
        # refcounts are exactly the number of owners holding each page;
        # uncommitted pages are exclusively owned
        hold_counts: Dict[int, int] = {}
        for o in self.owners.values():
            for pid in o.page_ids:
                hold_counts[pid] = hold_counts.get(pid, 0) + 1
        for pid, n in hold_counts.items():
            node = self._nodes.get(pid)
            if node is None:
                assert n == 1, f"uncommitted page {pid} shared by {n} owners"
            else:
                assert node.refs == n, (pid, node.refs, n)
        assert cached == {pid for pid, nd in self._nodes.items()
                          if nd.refs == 0}, "cached pool / refcount drift"
        # index <-> nodes bijection, child counts consistent
        assert set(self._index.values()) == set(self._nodes), "index drift"
        assert all(self._nodes[pid].key in self._index
                   for pid in self._nodes), "node missing from index"
        kids: Dict[int, int] = {}
        for nd in self._nodes.values():
            if nd.parent != -1:
                assert nd.parent in self._nodes, "orphaned committed child"
                kids[nd.parent] = kids.get(nd.parent, 0) + 1
        for pid, nd in self._nodes.items():
            assert nd.children == kids.get(pid, 0), (pid, nd.children)
