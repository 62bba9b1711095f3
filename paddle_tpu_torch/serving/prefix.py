"""Prefix index — the radix trie over the paged KV-cache; the counterpart
of ``paddle_tpu/serving/prefix.py`` (copied: it is host bookkeeping and
imports no JAX).

Production traffic is a few thousand system prompts × millions of
continuations: re-prefilling a 2k-token system prompt for every request
burns prefill FLOPs recomputing KV rows the pool already holds. The index
maps shared prompt PREFIXES to refcounted pages at ``block`` (page)
granularity, so a request whose prompt starts with a known prefix admits
with only the non-shared suffix prefilled (serving/paged.py owns the
device side; this module is pure host bookkeeping).

Sharing rules the exactness contract rides on:

* **full blocks share in place.** A trie node keys one full page of prompt
  tokens (positions ``j*bs .. (j+1)*bs - 1``); its KV rows depend only on
  tokens before the block's end (causality), so any prompt with the same
  token prefix reads the SAME page. Nodes are refcounted: a live request
  pins its matched path; ``release`` decrements, and the page returns to
  the free list only via eviction at refcount 0 — never under a reader.
* **index-owned pages are never written.** Appends happen strictly past a
  request's prompt, which by construction lands in slot-owned pages.
* **the last partial page copies on write.** A prompt tail shorter than a
  block is stored as a *partial* entry; a hit COPIES the page into a
  fresh slot-owned page before any append touches it (the CoW), so the
  stored page stays immutable while its owner keeps appending to it
  (owner appends land at positions >= its own prompt length — rows the
  tail key never covers).

Eviction is scored by MEASURED reuse, not a hand heuristic (the TVM
lesson, PAPERS.md): every hit credits the entry with the bytes it saved
(rows * page row bytes), and the credit decays with a half-life measured
in admission ticks — a once-hot prefix that stopped hitting decays below
a steadily-reused one regardless of insertion order. Only cold leaves
(refcount 0, no children/partials, no live owner) are evictable, so a
pinned path can never be broken mid-read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Entry:
    """Shared bookkeeping of one cached page (full-block node or partial
    tail): the page id, liveness pins, and the measured-reuse ledger."""

    __slots__ = ("page", "refs", "score", "tick", "hits")

    def __init__(self, page: int, tick: int):
        self.page = page
        self.refs = 0          # live requests reading this page
        self.score = 0.0       # decayed bytes-saved credit
        self.tick = tick       # admission tick of the last credit
        self.hits = 0


class _Node(_Entry):
    """One full-block trie node: ``key`` is the page's token tuple."""

    __slots__ = ("key", "parent", "children", "partials")

    def __init__(self, key, page: int, parent, tick: int):
        super().__init__(page, tick)
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        # partial prompt tails hanging off this depth: tail tokens -> entry
        self.partials: Dict[tuple, "_Partial"] = {}


class _Partial(_Entry):
    """A stored prompt tail shorter than a block. While ``owner`` names a
    live slot the page belongs to that slot (it is still appending past
    its prompt); on slot free the index adopts the page. Hits always COPY
    (never pin), so partials carry no refcount-liveness — only the
    owner-liveness gate."""

    __slots__ = ("key", "node", "owner")

    def __init__(self, key, page: int, node: _Node, owner: Optional[int],
                 tick: int):
        super().__init__(page, tick)
        self.key = key
        self.node = node
        self.owner = owner


class Match:
    """Result of one lookup: the pinned-able full-block path, an optional
    partial-tail entry with its matched token count, and the total shared
    position count (= the admission offset)."""

    __slots__ = ("nodes", "partial", "partial_len", "shared_len")

    def __init__(self, nodes: List[_Node], partial: Optional[_Partial],
                 partial_len: int, block: int):
        self.nodes = nodes
        self.partial = partial
        self.partial_len = partial_len
        self.shared_len = len(nodes) * block + partial_len


class PrefixIndex:
    """The radix index. All methods are host-side and must run under the
    pool owner's single-threaded discipline (the engine's scheduler
    thread / a batcher's serve loop)."""

    def __init__(self, block: int, page_bytes: float, *,
                 half_life: int = 64):
        self.block = block
        self.page_bytes = float(page_bytes)   # reuse-ledger credit unit
        self.half_life = max(int(half_life), 1)
        self.root = _Node((), -1, None, 0)
        self.tick = 0                 # advanced once per admission wave
        # scalar tallies maintained incrementally so telemetry readers
        # (engine gauges under the lock, daemon stats from RPC threads)
        # never WALK the trie the scheduler thread is mutating — a walk
        # mid-insert would raise dictionary-changed-size; int reads are
        # GIL-atomic and an instant-stale value is fine for a gauge
        self.total_pages = 0          # pages the INDEX owns (not slots)
        self.pinned = 0               # nodes with refs > 0 (pages shared)
        self.n_nodes = 0
        self.n_partials = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- lookup ------------------------------------------------------------
    def match(self, tokens: Sequence[int], limit: int) -> Match:
        """Deepest shared prefix of ``tokens`` usable for positions
        ``< limit`` (callers pass ``plen - 1`` so at least one prompt
        token is always re-prefilled — the last token's logits are what
        admission emits, and logits are not cached)."""
        bs = self.block
        node, nodes = self.root, []
        j = 0
        while (j + 1) * bs <= limit:
            child = node.children.get(tuple(int(t) for t in
                                            tokens[j * bs:(j + 1) * bs]))
            if child is None:
                break
            nodes.append(child)
            node, j = child, j + 1
        best, best_m = None, 0
        rest = [int(t) for t in tokens[j * bs:limit]]
        if rest:
            for tail, entry in node.partials.items():
                m = 0
                while m < min(len(tail), len(rest)) and tail[m] == rest[m]:
                    m += 1
                if m > best_m:
                    best, best_m = entry, m
        return Match(nodes, best, best_m, bs)

    def ref(self, node: _Node) -> None:
        """Pin one node (a live request reads its page)."""
        node.refs += 1
        if node.refs == 1:
            self.pinned += 1

    def acquire(self, match: Match) -> None:
        """Pin a matched path for one admitted request and credit the
        reuse ledger: each shared entry earns the bytes this hit did not
        re-prefill (partials credit only the matched rows)."""
        for node in match.nodes:
            self.ref(node)
            self._credit(node, self.page_bytes)
        if match.partial is not None and match.partial_len > 0:
            self._credit(match.partial,
                         self.page_bytes * match.partial_len / self.block)
        if match.shared_len > 0:
            self.hits += 1
        else:
            self.misses += 1

    def release(self, nodes: Sequence[_Node]) -> None:
        """Un-pin a freed request's path. Pages STAY cached (cold) until
        eviction needs them — refcount 0 means evictable, not freed."""
        for node in nodes:
            node.refs -= 1
            assert node.refs >= 0, "prefix-index refcount underflow"
            if node.refs == 0:
                self.pinned -= 1

    # -- insertion ---------------------------------------------------------
    def insert_full(self, parent: _Node, key: tuple,
                    page: int) -> Tuple[_Node, bool]:
        """Insert/find the full-block node for ``key`` under ``parent``
        (the caller walks/extends the path block by block, so the parent
        is always at hand). Returns (node, created): when created, the
        index takes ownership of ``page``; when the key already existed
        (a duplicate admission — e.g. two misses sharing a prefix in one
        wave), the caller keeps ``page``, frees it, and points its block
        table at the existing node's page instead (dedup)."""
        existing = parent.children.get(key)
        if existing is not None:
            return existing, False
        child = _Node(key, page, parent, self.tick)
        parent.children[key] = child
        self.total_pages += 1
        self.n_nodes += 1
        return child, True

    def insert_partial(self, node: _Node, tail: tuple, page: int,
                       owner: int) -> Optional[_Partial]:
        """Register a live slot's last partial prompt page under ``node``.
        The page remains SLOT-owned until :meth:`adopt`; an identical tail
        already present wins (no duplicate entry, returns None)."""
        if not tail or tail in node.partials:
            return None
        entry = _Partial(tail, page, node, owner, self.tick)
        node.partials[tail] = entry
        self.n_partials += 1
        return entry

    def adopt(self, entry: _Partial) -> None:
        """The owning slot freed: the index takes the page (cold)."""
        entry.owner = None
        self.total_pages += 1

    # -- eviction ----------------------------------------------------------
    def _effective(self, e: _Entry) -> float:
        return e.score * 0.5 ** ((self.tick - e.tick) / self.half_life)

    def _credit(self, e: _Entry, saved_bytes: float) -> None:
        e.score = self._effective(e) + saved_bytes
        e.tick = self.tick
        e.hits += 1

    def _candidates(self) -> List[Tuple[float, _Entry, _Node]]:
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            for p in n.partials.values():
                if p.owner is None:
                    out.append((self._effective(p), p, n))
            if (n is not self.root and n.refs == 0 and not n.children
                    and not n.partials):
                out.append((self._effective(n), n, n.parent))
        return out

    def evict_pages(self, n: int, keep=frozenset(), *,
                    count: bool = True) -> List[int]:
        """Evict up to ``n`` of the coldest evictable entries (lowest
        decayed bytes-saved credit first); returns the freed page ids
        (possibly fewer than ``n`` — everything else is pinned). Only
        leaves evict, so matched paths stay intact. ``keep`` is a set of
        ``id(entry)`` values to skip — the CURRENT admission wave's
        matched-but-not-yet-pinned entries (plans pin only inside
        ``PagePool.admit``, so without this guard an eviction in the same
        wave could free a page a block table is about to reference).
        ``count=False`` suppresses the eviction tally (drains are not
        pressure evictions).

        One candidate walk serves a whole batch; the walk repeats only
        when evicting a leaf turned its parent into a new candidate."""
        freed: List[int] = []
        while len(freed) < n:
            progressed = False
            for _, entry, parent in sorted(self._candidates(),
                                           key=lambda c: c[0]):
                if len(freed) >= n:
                    break
                if id(entry) in keep:
                    continue
                if isinstance(entry, _Partial):
                    del parent.partials[entry.key]
                    self.n_partials -= 1
                else:
                    del parent.children[entry.key]
                    self.n_nodes -= 1
                self.total_pages -= 1
                if count:
                    self.evictions += 1
                freed.append(entry.page)
                progressed = True
            if not progressed:
                break
        return freed

    def evict_one(self, keep=frozenset()) -> Optional[int]:
        """Single-page :meth:`evict_pages`; None when nothing evicts."""
        freed = self.evict_pages(1, keep)
        return freed[0] if freed else None

    def clear(self) -> List[int]:
        """Drop EVERY evictable entry (drain/tests); returns freed pages.
        Entries pinned by live requests (refs > 0) survive. A drain is
        not a pressure eviction: the evictions tally is untouched."""
        return self.evict_pages(1 << 62, count=False)

    # -- introspection (scalar reads only: safe from any thread) -----------
    def live_pages(self) -> int:
        """Index pages currently pinned by >= 1 live request (a page read
        by N requests counts once) — the serving.prefix_pages_shared
        gauge. O(1): maintained on the 0<->1 refcount transitions."""
        return self.pinned

    def stats(self) -> Dict[str, float]:
        return {"prefix_nodes": self.n_nodes,
                "prefix_partials": self.n_partials,
                "prefix_pages": self.total_pages,
                "prefix_pages_live": self.pinned,
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_evictions": self.evictions}
