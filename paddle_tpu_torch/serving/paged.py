"""Paged KV cache — the counterpart of ``paddle_tpu/serving/paged.py``.

The cache is a shared pool of fixed-size pages (``page_block`` positions
each) plus a per-slot block table naming which pages hold positions
``j*bs .. (j+1)*bs-1``: device memory holds live tokens, not max_len
padding, and a finished or cancelled request returns its pages at once.

With ``prefix_cache=True`` the pool also shares pages across requests
through a radix index over prompt prefixes (``serving/prefix.py``): a
request whose prompt starts with a cached prefix admits with only the
suffix prefilled (``TransformerLM.prefill_paged``, from an offset over
pre-populated block tables), full prefix pages are read in place under
refcounts, and a matched partial last page is copied into a page of the
slot's own before the suffix appends to it. Cold entries evict by their
measured reuse.

Invariants the exactness contract rides on (as in the JAX pool):

* live slots never share an owned page (allocation pops unique pages);
  pages the index holds are shared read-only and never written after
  the admission wave that filled them;
* page 0 is the reserved NULL page: padded table entries and drained-slot
  writes land there, and no live read is ever unmasked into it;
* admission reserves each request's worst-case owned page count up
  front (prompt + capped budget + one segment of overshoot, less the
  shared prefix pages), and the fit check counts the index's pages too,
  so a live slot can never fail an allocation mid-decode and a cold
  cache can always be evicted out of the way: backpressure happens at
  admission.

Where JAX donates the pools to a jitted program and gets new ones back,
the port writes into the pool tensors in place (admission scatters with
index assignment, each decode step writes its row in place), and the
segment's ``lax.scan`` is a Python loop of ``segment`` steps. As JAX jits
the admission per prompt bucket and the segment per read bound, each is
one CUDA graph on the card (``core/graphs.py``): the admission per
prompt bucket, the prefix-hit admission per (suffix pad, read pages),
the segment per page count of its read; the pools are donated to each
(the graphs' static buffers), the tables, positions, tokens and prompts
are copied in from the host before a replay.

``kv_dtype="int8"`` holds the pools as int8 rows with f32 scale pools
[P, bs, H] (initialised to 1.0); the admission scatters the prompt's
scales with its rows, and the decode reads dequantize on load.

Disaggregation: :meth:`PagePool.export_slot` packs a prefilled slot's
pages for shipping (``serving/ship.py``) and :meth:`PagePool.adopt_slot`
lands a shipment in another pool byte for byte; both order their gather
and scatter with the pool's graphs.

The ``tune`` consults of the JAX pool are not ported: page_block 64,
cache_bucket 256 and prompt buckets (32, 64, 128, 256, 512) are the
heuristic defaults the JAX pool falls back to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.graphs import GraphCache
from ..core.lod import bucket_length
from ..core.place import DeviceLike, resolve_device
from .batcher import (DEFAULT_PROMPT_BUCKETS, Request, clip_emission,
                      validate_request)
from . import ship
from .prefix import Match, PrefixIndex


class _AdmitPlan:
    """One request's host-side admission plan: the prefix-index match (or
    None), the owned pages it must reserve, the prefix cap and its tenant.
    Computed with no pool mutation, so a scheduler can check fits (and
    evict) before it commits anything."""

    __slots__ = ("prompt", "left", "plen", "tenant", "prefix_cap", "match",
                 "need_pages", "offset")

    def __init__(self, prompt, left, need_pages, tenant="default",
                 prefix_cap=None, match: Optional[Match] = None):
        self.prompt = prompt
        self.left = left
        self.plen = int(prompt.size)
        self.tenant = tenant
        self.prefix_cap = prefix_cap
        self.match = match
        self.need_pages = need_pages
        self.offset = match.shared_len if match is not None else 0


class PagePool:
    """Device page pools + host page accounting + the admission, prefix-hit
    admission and segment dispatches."""

    def __init__(self, model, *, slots: int, segment: int = 32,
                 page_block: int = 64, pages: Optional[int] = None,
                 cache_bucket: int = 256,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False, prefix_half_life: int = 64,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model's weights are on {model.device} but "
                             f"the pool is for {self.device}; move the model "
                             "or pass device=")
        if model.max_len % page_block:
            raise ValueError(f"page_block {page_block} must divide "
                             f"max_len {model.max_len}")
        if cache_bucket % page_block:
            raise ValueError(f"cache_bucket {cache_bucket} must be a "
                             f"multiple of page_block {page_block}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        self.model = model
        self.kv_dtype = kv_dtype
        self.n_slots, self.segment = slots, segment
        self.bs = page_block
        self.cache_bucket = cache_bucket
        self.prompt_buckets = tuple(prompt_buckets)
        self.nb_max = model.max_len // page_block
        # default sizing: every slot at max_len + the null page
        self.pages = (slots * self.nb_max + 1) if pages is None else pages
        if self.pages < 2:
            raise ValueError("pages must be >= 2 (null page + one live)")
        self.capacity_pages = self.pages - 1

        H = model.blocks[0].n_heads
        Dh = model.blocks[0].d_head
        dt = torch.int8 if kv_dtype == "int8" else model.dtype
        pools: Dict[str, torch.Tensor] = {}
        for i in range(len(model.blocks)):
            for nm in (f"k{i}", f"v{i}"):
                pools[nm] = torch.zeros((self.pages, self.bs, H, Dh),
                                        dtype=dt, device=self.device)
                if kv_dtype == "int8":
                    # scale 1.0 everywhere, the null page included, so that
                    # a dequantized (never read) padding row stays finite
                    pools[nm + "_scale"] = torch.ones(
                        (self.pages, self.bs, H), dtype=torch.float32,
                        device=self.device)
        # the pools are the graphs' carried state (donated to every one)
        self.graphs = GraphCache("PagePool", self.device)
        self.graphs.cost_modules = [model] if isinstance(
            model, torch.nn.Module) else []
        self.pools = self.graphs.buffer("pools", lambda: pools)
        # the bytes of one cache row of one layer's k or v: an int8 row
        # carries one f32 scale per head (JAX's _decode_attention_bytes)
        itemsize = torch.empty((), dtype=dt).element_size()
        self._H, self._Dh, self._itemsize = H, Dh, itemsize
        self._row_bytes = H * (Dh + 4 if kv_dtype == "int8"
                               else Dh * itemsize)
        # one (k + v) page of every layer: the prefix index's reuse credit
        self.page_bytes = 2.0 * self.bs * self._row_bytes * len(model.blocks)
        self.index: Optional[PrefixIndex] = (
            PrefixIndex(self.bs, self.page_bytes, half_life=prefix_half_life)
            if prefix_cache else None)

        # host accounting
        self.free: List[int] = list(range(self.pages - 1, 0, -1))
        self.tables = np.zeros((slots, self.nb_max), np.int32)
        self.pos = np.zeros((slots,), np.int64)
        self.cur = np.zeros((slots,), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(slots)]
        self.slot_shared: List[list] = [[] for _ in range(slots)]
        self.slot_partial: List[Optional[object]] = [None] * slots
        self.slot_reserve = np.zeros((slots,), np.int64)
        self.reserved = 0
        self.peak_pages_used = 0
        # plain host tallies (always on)
        self.segments_total = 0
        self.admissions_total = 0        # admission dispatches
        self.read_bytes_total = 0.0
        self.occupancy_num = 0           # live tokens, summed per segment
        self.occupancy_den = 0           # allocated page capacity, ditto
        self.prompt_tokens_total = 0     # tokens admitted
        self.prefill_tokens_total = 0    # tokens prefilled
        self.cow_copies_total = 0        # partial-page copies on write
        self.hit_admissions_total = 0    # prefix-hit admission dispatches
        self.admissions_by_bucket: Dict[int, int] = {}   # prompt pad -> n
        self.segments_by_pages: Dict[int, int] = {}      # read pages -> n

    # -- accounting --------------------------------------------------------
    @property
    def pages_used(self) -> int:
        return self.capacity_pages - len(self.free)

    @property
    def index_pages(self) -> int:
        return self.index.total_pages if self.index is not None else 0

    def required_pages(self, plen: int, left: int) -> int:
        """Worst-case pages a (prompt, capped budget) request can touch:
        positions up to plen + left - 1 live, plus up to one segment of
        discarded overshoot, capped at max_len."""
        hi = min(plen + left + self.segment - 1, self.model.max_len)
        return -(-hi // self.bs)

    def fits(self, need_pages: int, pending: int = 0) -> bool:
        """Can a request needing ``need_pages`` owned pages be admitted?
        ``pending`` is what the current admission wave has already claimed
        (``reserved`` only moves inside :meth:`admit`); the pages the
        prefix index holds count too (they are not in the free list)."""
        return (self.reserved + pending + need_pages + self.index_pages
                <= self.capacity_pages)

    def evict_for(self, need_pages: int, pending: int = 0,
                  protect: Sequence[_AdmitPlan] = ()) -> bool:
        """Evict cold prefix-cache entries (lowest decayed measured reuse
        first) until ``need_pages`` fits; True on success. Pinned entries
        never evict, and ``protect`` (the wave's plans, the one being
        priced included) shields the entries a plan has matched but not
        yet pinned (plans pin only inside :meth:`admit`)."""
        if self.index is None:
            return self.fits(need_pages, pending)
        keep = set()
        for plan in protect:
            if plan.match is not None:
                keep.update(id(n) for n in plan.match.nodes)
                if plan.match.partial is not None:
                    keep.add(id(plan.match.partial))
        while True:
            deficit = (self.reserved + pending + need_pages
                       + self.index_pages) - self.capacity_pages
            if deficit <= 0:
                return True
            freed = self.index.evict_pages(deficit, keep)
            if not freed:
                return False
            self.free.extend(freed)
            obs.count("serving.prefix_evictions_total", len(freed))

    def clear_prefix_cache(self) -> int:
        """Drop every unpinned prefix-cache entry back to the free list;
        returns the pages reclaimed."""
        if self.index is None:
            return 0
        freed = self.index.clear()
        self.free.extend(freed)
        return len(freed)

    def prefix_stats(self) -> Dict[str, float]:
        """Host tallies: hits and misses, shared and cached pages, prompt
        against prefilled tokens, copies on write, hit dispatches."""
        out = {"prefix_cache": 1.0 if self.index is not None else 0.0,
               "prompt_tokens": self.prompt_tokens_total,
               "prefill_tokens": self.prefill_tokens_total,
               "cow_copies": self.cow_copies_total,
               "hit_admissions": self.hit_admissions_total}
        if self.index is not None:
            out.update(self.index.stats())
        return out

    def effective_budget(self, prompt_len: int, max_new: int) -> int:
        """The max_len-capped token budget a (prompt, max_new) can hold."""
        return min(max_new, self.model.max_len - prompt_len)

    def validate(self, r: Request) -> int:
        """Submit-time validation; returns the request's worst-case page
        need. Raises ValueError for malformed requests and for requests no
        empty pool could ever hold."""
        validate_request(r, self.model)
        need = self.required_pages(
            r.prompt.size, self.effective_budget(r.prompt.size, r.max_new))
        if need > self.capacity_pages:
            who = f"request {r.rid}" if r.rid >= 0 else "request"
            raise ValueError(
                f"{who}: needs {need} pages (prompt "
                f"{r.prompt.size} + budget "
                f"{self.effective_budget(r.prompt.size, r.max_new)} at "
                f"page_block {self.bs}) but the pool holds "
                f"{self.capacity_pages}; shrink max_new or grow pages")
        return need

    def plan_admission(self, prompt: np.ndarray, left: int, *,
                       tenant: str = "default",
                       prefix_len: Optional[int] = None) -> _AdmitPlan:
        """Match ``prompt`` against the prefix index (nothing is pinned
        until :meth:`admit`) and price the admission in owned pages. The
        match is capped at plen - 1, so at least the last prompt token is
        prefilled: its logits give the first token, and logits are not
        cached."""
        plen = int(prompt.size)
        match = (self.index.match(prompt, plen - 1)
                 if self.index is not None else None)
        shared_full = len(match.nodes) if match is not None else 0
        need = self.required_pages(plen, left) - shared_full
        return _AdmitPlan(prompt, left, need, tenant, prefix_len, match)

    def _alloc(self) -> int:
        if not self.free:       # reservation accounting makes this a bug
            raise RuntimeError("page pool exhausted past its reservations")
        page = self.free.pop()
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return page

    def _ensure(self, slot: int, upto_pos: int) -> None:
        """Grow ``slot``'s table to cover positions < upto_pos; the shared
        prefix pages hold the leading entries, only the tail allocates."""
        need = -(-min(upto_pos, self.model.max_len) // self.bs)
        have = len(self.slot_shared[slot]) + len(self.slot_pages[slot])
        while have < need:
            page = self._alloc()
            self.tables[slot, have] = page
            self.slot_pages[slot].append(page)
            have += 1

    def free_slot(self, slot: int) -> None:
        """Return every owned page, unpin the shared prefix path (its
        pages return only through eviction), hand the last partial prompt
        page to the index (it keys a stored tail), and park the slot:
        table -> null page, pos -> 0, so its idle decode writes and reads
        touch page 0 only."""
        entry = self.slot_partial[slot]
        pages = self.slot_pages[slot]
        if entry is not None:
            if (self.index is not None
                    and entry.node.partials.get(entry.key) is entry):
                # the index adopts the page as a cold cached tail
                self.index.adopt(entry)
                pages.remove(entry.page)
            self.slot_partial[slot] = None
        self.free.extend(pages)
        self.slot_pages[slot] = []
        if self.index is not None and self.slot_shared[slot]:
            self.index.release(self.slot_shared[slot])
        self.slot_shared[slot] = []
        self.reserved -= int(self.slot_reserve[slot])
        self.slot_reserve[slot] = 0
        self.tables[slot, :] = 0
        self.pos[slot] = 0

    # -- disaggregation: export / adopt (serving/ship.py) ------------------
    def export_slot(self, slot: int, first: int):
        """Serialize ``slot``'s prefilled page contents for shipping to a
        decode worker's pool: gather the slot's table pages from every
        pool array (k/v per layer + int8 scales) and pack them with the
        request state (``pos``/first token) under a payload CRC. Rows past
        ``pos`` inside the last page are garbage on both ends — the paged
        read masks by ``pos``, so shipping them changes nothing. The
        gather is ordered after the pool's graphs (``GraphCache.ordered``)."""
        plen = int(self.pos[slot])
        npg = -(-plen // self.bs)
        pages = torch.from_numpy(
            self.tables[slot, :npg].astype(np.int64)).to(self.device)
        with self.graphs.ordered():
            arrays = {nm: arr[pages] for nm, arr in self.pools.items()}
        arrays = {nm: a.cpu() for nm, a in arrays.items()}
        manifest, payload = ship.pack(arrays, plen=plen, first=first,
                                      page_block=self.bs,
                                      kv_dtype=self.kv_dtype)
        obs.count("serving.ship_pages_total", npg)
        obs.count("serving.ship_bytes_total", len(payload))
        return manifest, payload

    def check_shipment(self, plen: int,
                       arrays: Dict[str, torch.Tensor]) -> None:
        """Validate shipped arrays against THIS pool's layout without
        touching any page. Callable at submit time (the engine's
        ``submit_prefilled``) so a mismatched shipment is a structured
        ValueError refusal at the wire edge, never a scheduler-thread
        death mid-adoption."""
        npg = -(-int(plen) // self.bs)
        missing = set(self.pools) - set(arrays)
        extra = set(arrays) - set(self.pools)
        if missing or extra:
            raise ValueError(
                f"shipped arrays disagree with this pool's layout "
                f"(missing {sorted(missing)}, unexpected {sorted(extra)}) "
                "— prefill and decode pools must share model depth and "
                "kv_dtype")
        for nm, rows in arrays.items():
            ref = self.pools[nm]
            want = (npg,) + tuple(ref.shape[1:])
            if tuple(rows.shape) != want:
                raise ValueError(
                    f"shipped {nm!r} shape {tuple(rows.shape)} != expected "
                    f"{want} (page_block/heads/width mismatch)")
            if rows.dtype != ref.dtype:
                raise ValueError(
                    f"shipped {nm!r} dtype {rows.dtype} != pool "
                    f"{ref.dtype}; refusing a lossy cast")

    def adopt_slot(self, slot: int, plen: int, first: int,
                   arrays: Dict[str, torch.Tensor], need_pages: int) -> None:
        """Land a shipped slot (the decode half of :meth:`export_slot`):
        reserve its worst-case owned pages, allocate the table, scatter
        the shipped rows in byte-identical (dtype-checked: a silent cast
        would break wire-greedy parity), and arm ``pos``/``cur`` so the
        next segment continues exactly where the prefill worker's
        admission stopped. The scatter writes the graphs' pool buffers in
        place, ordered with their replays (``GraphCache.ordered``). The
        caller (the engine scheduler) has already checked
        :meth:`fits`/:meth:`evict_for` for ``need_pages``."""
        plen = int(plen)
        npg = -(-plen // self.bs)
        self.check_shipment(plen, arrays)
        self.slot_reserve[slot] = need_pages
        self.reserved += need_pages
        self.slot_shared[slot] = []
        self.slot_partial[slot] = None
        self._ensure(slot, plen)
        pages = torch.from_numpy(
            self.tables[slot, :npg].astype(np.int64)).to(self.device)
        rows = {nm: a.to(self.device) for nm, a in arrays.items()}
        with torch.no_grad(), self.graphs.ordered():
            for nm, r in rows.items():
                self.pools[nm][pages] = r
        self.pos[slot] = plen
        self.cur[slot] = int(first)
        self.prompt_tokens_total += plen
        obs.count("serving.adopted_total")

    # -- the two scheduler-visible operations ------------------------------
    def admit(self, group: List[Tuple[int, _AdmitPlan]]) -> Dict[int, int]:
        """Commit ``group`` = [(slot, plan)] (the caller has checked
        :meth:`fits` / :meth:`evict_for`): reserve owned pages, pin the
        matched prefix paths, allocate the prompts' tail pages, run the
        full-prefill dispatch for misses and the copy-on-write +
        suffix-prefill dispatch for hits, insert the new full prompt
        blocks (and the last partial page) into the index, and return
        {slot: first generated token}."""
        if not group:
            return {}
        if self.index is not None:
            self.index.tick += 1
        miss, hits = [], []
        cow: Dict[int, Tuple[int, int]] = {}      # slot -> (src, dst)
        for slot, plan in group:
            self.slot_reserve[slot] = plan.need_pages
            self.reserved += plan.need_pages
            self.slot_partial[slot] = None
            if plan.match is not None:
                self.index.acquire(plan.match)
                self.slot_shared[slot] = list(plan.match.nodes)
                for j, node in enumerate(plan.match.nodes):
                    self.tables[slot, j] = node.page
                if plan.offset:
                    obs.count("serving.prefix_hits_total",
                              tenant=plan.tenant)
                else:
                    obs.count("serving.prefix_misses_total",
                              tenant=plan.tenant)
            else:
                self.slot_shared[slot] = []
            self._ensure(slot, plan.plen)
            if plan.match is not None and plan.match.partial_len > 0:
                # the block past the shared full pages is the slot's first
                # owned page: the stored tail is copied there before the
                # suffix prefill appends to it
                cow[slot] = (plan.match.partial.page, self.slot_pages[slot][0])
                self.cow_copies_total += 1
            self.prompt_tokens_total += plan.plen
            self.prefill_tokens_total += plan.plen - plan.offset
            (hits if plan.offset else miss).append((slot, plan))
        first = np.zeros((self.n_slots,), np.int64)
        if miss:
            got = self._prefill(miss)
            for slot, _ in miss:
                first[slot] = got[slot]
        if hits:
            got = self._prefill_hits(hits, cow)
            for slot, _ in hits:
                first[slot] = got[slot]
        if self.index is not None:
            for slot, plan in group:
                self._insert_after(slot, plan)
        out = {}
        for slot, plan in group:
            self.pos[slot] = plan.plen
            self.cur[slot] = int(first[slot])
            out[slot] = int(first[slot])
        return out

    def _prefill(self, group) -> np.ndarray:
        """ONE full-pool-width prefill over the prompt bucket: every slot
        row runs (idle rows with length 0 and pages at the null page), as
        the JAX admission program does."""
        tpad = bucket_length(max(p.plen for _, p in group),
                             self.prompt_buckets)
        tpad = min(tpad, self.model.max_len - 1)
        nbp = -(-tpad // self.bs)
        prompts = np.zeros((self.n_slots, tpad), np.int32)
        lens = np.zeros((self.n_slots,), np.int32)
        pages = np.zeros((self.n_slots, nbp), np.int64)
        for slot, plan in group:
            prompts[slot, :plan.plen] = plan.prompt
            lens[slot] = plan.plen
            n = min(nbp, len(self.slot_pages[slot]))
            pages[slot, :n] = self.slot_pages[slot][:n]
        self.graphs.watch(self.model.parameters())
        self.pools, first = self.graphs.run(
            "admit", self._admit_body,
            {"pools": self.pools, "prompts": torch.from_numpy(prompts),
             "lens": torch.from_numpy(lens),
             "pages": torch.from_numpy(pages)}, donate=("pools",),
            cost="serving.admit")
        self.admissions_total += 1
        self.admissions_by_bucket[tpad] = \
            self.admissions_by_bucket.get(tpad, 0) + 1
        return first.cpu().numpy()

    def _prefill_hits(self, hits, cow) -> np.ndarray:
        """The prefix-hit admission: the copies on write, then the suffix
        prefill of every hit from its offset, reading the shared prefix
        pages through the block tables; one pool-width dispatch (one CUDA
        graph per (suffix pad, read pages) on the card)."""
        max_sfx = max(p.plen - p.offset for _, p in hits)
        tpad = min(bucket_length(max_sfx, self.prompt_buckets),
                   self.model.max_len - 1)
        nbr = -(-min(bucket_length(max(p.plen for _, p in hits),
                                   self.prompt_buckets),
                     self.model.max_len) // self.bs)
        suffix = np.zeros((self.n_slots, tpad), np.int32)
        offsets = np.zeros((self.n_slots,), np.int64)
        lens = np.zeros((self.n_slots,), np.int64)
        src = np.zeros((self.n_slots,), np.int64)
        dst = np.zeros((self.n_slots,), np.int64)
        for slot, plan in hits:
            sfx = plan.prompt[plan.offset:]
            suffix[slot, :sfx.size] = sfx
            offsets[slot] = plan.offset
            lens[slot] = sfx.size
            if slot in cow:
                src[slot], dst[slot] = cow[slot]
        self.graphs.watch(self.model.parameters())
        self.pools, first = self.graphs.run(
            "hit", self._hit_body,
            {"pools": self.pools, "suffix": torch.from_numpy(suffix),
             "offsets": torch.from_numpy(offsets),
             "lens": torch.from_numpy(lens),
             "tables": torch.from_numpy(np.ascontiguousarray(
                 self.tables[:, :nbr]).astype(np.int64)),
             "copy_src": torch.from_numpy(src),
             "copy_dst": torch.from_numpy(dst)}, donate=("pools",),
            cost="serving.admit_prefix")
        self.hit_admissions_total += 1
        # modeled HBM bytes of the gathered prefix read (the hit path's
        # bytes term), through the one registered model
        read = obs.roofline.kernel_cost(
            "paged_prefill_attention", batch=self.n_slots, pages=nbr,
            page_block=self.bs, n_heads=self._H, d_head=self._Dh,
            layers=len(self.model.blocks), kv_dtype=self.kv_dtype,
            itemsize=self._itemsize) or 0.0
        obs.count("kernels.bytes_total", read,
                  kernel="paged_prefill_attention")
        return first.cpu().numpy()

    @torch.no_grad()
    def _hit_body(self, pools, suffix, offsets, lens, tables, copy_src,
                  copy_dst):
        """The prefix-hit admission program: each slot's matched partial
        page copied into its fresh owned page (slots with no copy pass
        (0, 0): the null page copies onto itself), then
        ``prefill_paged`` of the suffixes. Returns (pools, each slot's
        first token)."""
        for pool in pools.values():
            pool[copy_dst] = pool[copy_src]
        pools, last = self.model.prefill_paged(pools, suffix, offsets, lens,
                                               tables)
        return pools, torch.argmax(last, dim=-1)

    def _insert_after(self, slot: int, plan: _AdmitPlan) -> None:
        """Grow the radix index from this admission: each full prompt
        block past the matched depth becomes a shared node (the slot's
        page passes to the index, or the slot takes an equal node's page
        and frees its own), and a partial prompt tail registers for
        copy-on-write sharing; ``prefix_cap`` (a declared prefix_len)
        caps what is cached."""
        idx = self.index
        prompt, plen = plan.prompt, plan.plen
        cap = plen if plan.prefix_cap is None else min(plan.prefix_cap, plen)
        q0 = len(plan.match.nodes) if plan.match is not None else 0
        parent = (plan.match.nodes[-1] if plan.match is not None
                  and plan.match.nodes else idx.root)
        kfull = cap // self.bs
        for j in range(q0, kfull):
            page = self.slot_pages[slot].pop(0)
            key = tuple(int(t) for t in prompt[j * self.bs:
                                               (j + 1) * self.bs])
            node, created = idx.insert_full(parent, key, page)
            if created:
                # a first use counts one reuse credit, so a new prefix
                # survives an eviction scan long enough to be hit
                idx._credit(node, idx.page_bytes)
            else:
                # two misses of one prefix in a wave: keep the existing
                # shared page, free ours
                self.free.append(page)
                self.tables[slot, j] = node.page
            idx.ref(node)
            self.slot_shared[slot].append(node)
            self.slot_reserve[slot] -= 1
            self.reserved -= 1
            parent = node
        tail = tuple(int(t) for t in prompt[kfull * self.bs:cap])
        if tail and kfull >= q0 and self.slot_pages[slot]:
            entry = idx.insert_partial(parent, tail,
                                       self.slot_pages[slot][0], slot)
            if entry is not None:
                idx._credit(entry, idx.page_bytes * len(tail) / self.bs)
                self.slot_partial[slot] = entry

    @torch.no_grad()
    def _admit_body(self, pools, prompts, lens, pages):
        """The admission program: the ragged prefill of prompts [slots,
        tpad] padded to whole pages, its rows scattered into the pools at
        ``pages`` [slots, tpad / bs] in place. Returns (pools, each slot's
        first token)."""
        nbp = pages.shape[1]
        tpp = nbp * self.bs
        cell, last = self.model.prefill(prompts, lens,
                                        kv_dtype=self.kv_dtype, pad_to=tpp)
        for nm, pool in pools.items():
            rows = cell[nm][:, :tpp].reshape(
                (self.n_slots, nbp, self.bs) + tuple(pool.shape[2:]))
            pool[pages] = rows.to(pool.dtype)          # in place
        return pools, torch.argmax(last, dim=-1)

    def run_segment(self, live: Sequence[int]) -> np.ndarray:
        """One decode segment across the whole pool; returns the emitted
        token block [slots, segment] (drained slots' rows are garbage).
        Grows live slots' tables first, so no mid-segment allocation
        exists."""
        for i in live:
            self._ensure(i, int(self.pos[i]) + self.segment)
        max_pos = max((int(self.pos[i]) for i in live), default=0)
        cache_len = min(
            -(-(max_pos + self.segment + 1) // self.cache_bucket)
            * self.cache_bucket, self.model.max_len)
        nb = cache_len // self.bs
        pos = np.clip(self.pos, 0, self.model.max_len - 1).astype(np.int32)
        self.graphs.watch(self.model.parameters())
        self.pools, out = self.graphs.run(
            "segment", self._segment_body,
            {"pools": self.pools,
             "tables": torch.from_numpy(np.ascontiguousarray(
                 self.tables[:, :nb])),
             "pos": torch.from_numpy(pos),
             "cur": torch.from_numpy(self.cur)}, donate=("pools",),
            cost="serving.segment")
        obs.count("decode.dispatches_total", route="serve_segment")
        # modeled cache-read bytes through the one registered model
        # (ops/cuda_kernels._paged_decode_attention_bytes)
        read = obs.roofline.kernel_cost(
            "paged_decode_attention", batch=self.n_slots, pages=nb,
            page_block=self.bs, n_heads=self._H, d_head=self._Dh,
            layers=len(self.model.blocks), kv_dtype=self.kv_dtype,
            itemsize=self._itemsize, steps=self.segment) or 0.0
        obs.count("kernels.bytes_total", read,
                  kernel="paged_decode_attention")
        out = out.cpu().numpy()
        block = out[:, :-1]
        self.segments_total += 1
        self.segments_by_pages[nb] = self.segments_by_pages.get(nb, 0) + 1
        # k + v live-table rows streamed per step, every layer
        self.read_bytes_total += (2.0 * self.n_slots * nb * self.bs
                                  * self._row_bytes * len(self.model.blocks)
                                  * self.segment)
        self.occupancy_num += self.live_tokens(live)
        self.occupancy_den += max(self.pages_used, 1) * self.bs
        self.pos += self.segment
        self.cur = out[:, -1].astype(np.int32)
        return block

    @torch.no_grad()
    def _segment_body(self, pools, tables, pos, cur):
        """The segment program (the JAX segment's ``lax.scan``):
        ``segment`` paged decode steps from tokens ``cur`` at ``pos``
        through ``tables`` [slots, nb]. Returns (pools, [slots, segment +
        1]: the tokens fed to each step, then the next token)."""
        cell = dict(pools, pos=pos)
        toks = []
        for _ in range(self.segment):
            logits, cell = self.model.decode_step_paged(cell, cur, tables)
            toks.append(cur)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
        return pools, torch.stack(toks + [cur], dim=1)

    def live_tokens(self, live: Sequence[int]) -> int:
        """Cache rows written across ``live`` slots (occupancy numerator)."""
        return int(sum(min(int(self.pos[i]), self.model.max_len)
                       for i in live))


class PagedBatcher:
    """Continuous batching over the paged pool: greedy outputs token-for-
    token equal to solo decode. ``schedule``: "longest_first" (the
    default) admits the longest budgets first, "fifo" in arrival order
    (the same outputs); ``prefix_cache=True`` shares prompt prefixes
    across requests (:class:`PagePool`)."""

    def __init__(self, model, *, slots: int = 8, segment: int = 32,
                 page_block: int = 64, pages: Optional[int] = None,
                 cache_bucket: int = 256,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 schedule: str = "longest_first",
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False,
                 device: DeviceLike = None):
        if schedule not in ("longest_first", "fifo"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.model = model
        self.schedule = schedule
        self.pool = PagePool(model, slots=slots, segment=segment,
                             page_block=page_block, pages=pages,
                             cache_bucket=cache_bucket,
                             prompt_buckets=prompt_buckets,
                             kv_dtype=kv_dtype, prefix_cache=prefix_cache,
                             device=device)

    def _effective_budget(self, r: Request) -> int:
        return self.pool.effective_budget(r.prompt.size, r.max_new)

    def serve(self, requests: Sequence[Request]) -> Dict[int, np.ndarray]:
        pool = self.pool
        queue = list(requests)
        for r in queue:
            pool.validate(r)
        if self.schedule == "longest_first":
            queue.sort(key=lambda r: -self._effective_budget(r))
        slots: List[Optional[Request]] = [None] * pool.n_slots
        left = np.zeros((pool.n_slots,), np.int64)
        outs: List[List[int]] = [[] for _ in range(pool.n_slots)]
        results: Dict[int, np.ndarray] = {}

        def admit():
            group, pending = [], 0
            for i in range(pool.n_slots):
                if slots[i] is not None or not queue:
                    continue
                r = queue[0]
                plan = pool.plan_admission(
                    r.prompt, self._effective_budget(r), tenant=r.tenant,
                    prefix_len=r.prefix_len)
                if not pool.evict_for(plan.need_pages, pending,
                                      protect=[p for _, p in group]
                                      + [plan]):
                    break          # head-of-line: wait for pages to free
                pending += plan.need_pages
                queue.pop(0)
                slots[i] = r
                left[i] = self._effective_budget(r)
                outs[i] = []
                group.append((i, plan))
            pool.admit(group)

        admit()
        while any(s is not None for s in slots):
            live = [i for i, s in enumerate(slots) if s is not None]
            block = pool.run_segment(live)
            for i in live:
                r = slots[i]
                take, done, _ = clip_emission(block[i], int(left[i]),
                                              r.eos_id)
                outs[i].extend(int(t) for t in take)
                obs.count("decode.tokens_total", len(take), route="serve")
                left[i] -= len(take)
                if done:
                    results[r.rid] = np.asarray(outs[i], np.int32)
                    slots[i] = None
                    pool.free_slot(i)   # pages return BEFORE next admit
            admit()
        return results
