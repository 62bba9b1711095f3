"""The serving engine — the counterpart of ``paddle_tpu/serving/engine.py``:
a long-lived continuous-batching scheduler over the paged pool with an
async submit/poll/cancel surface, weighted-fair class scheduling,
timeouts and queue backpressure.

Threading model: ONE scheduler thread (``start()``) owns every device
dispatch and every :class:`PagePool` mutation. Client threads touch
engine records under ``_lock`` only — submit appends to a queue, poll
reads a token buffer, cancel marks a flag the scheduler honours at the
next segment boundary. Device work runs outside the lock, so a poll never
waits on a dispatch. In-process tests may drive :meth:`step` instead.

``prefix_cache=True`` shares prompt-prefix pages across requests
(:class:`PagePool`'s radix index): a hit admits with only its suffix
prefilled, and the scheduler evicts cold cached prefixes when a request
does not fit otherwise.

Disaggregation: :meth:`ServingEngine.submit_prefilled` queues a shipped
admission (a prompt prefilled on another worker, ``serving/ship.py``),
which the scheduler adopts into the pool in place of a prefill; the RPC
surface over the engine is ``serving/daemon.py``.

Obs, as in JAX: ``serving.*`` and ``decode.tokens_total`` series, the
``serving.prefill``/``serving.segment`` spans, the scheduler thread's
goodput ledger (``component="serving"``), per-request phase timelines on
the obs request ledger keyed by ``submit_key`` (``obs/requests.py``), and
``alert_rules`` (the burn-rate SLO rules at this engine's targets).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import obs
from ..core.place import DeviceLike
from ..obs.goodput import maybe_bucket
from .batcher import SLO_CLASSES, Request, clip_emission
from .paged import DEFAULT_PROMPT_BUCKETS, PagePool


class Overloaded(RuntimeError):
    """Admission refused for capacity (queue cap) — retryable.
    ``retry_after_s`` is the server's backoff hint."""

    def __init__(self, msg: str, retry_after_s: float = 0.2):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class _Rec:
    """One request's lifecycle record (engine-internal)."""

    __slots__ = ("rid", "prompt", "eos_id", "left", "deadline", "t_submit",
                 "t_first", "t_done", "tokens", "done", "reason", "slot",
                 "skip", "cancelled", "collected", "tenant", "slo",
                 "prefix_len", "ship", "key")

    def __init__(self, rid, prompt, left, eos_id, deadline, t_submit,
                 tenant="default", slo="interactive", prefix_len=None):
        self.rid, self.prompt, self.left = rid, prompt, left
        self.eos_id, self.deadline, self.t_submit = eos_id, deadline, t_submit
        self.tenant, self.slo, self.prefix_len = tenant, slo, prefix_len
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.tokens: List[int] = []
        self.done = False
        self.reason = ""
        self.slot: Optional[int] = None
        self.skip = 0              # segment tokens already delivered early
        self.cancelled = False
        self.collected = False     # a poll has observed done=True
        #: a shipped admission's payload (disaggregation): dict with plen,
        #: first, arrays, need — consumed (and dropped) at adoption
        self.ship = None
        #: the fabric-wide submit_key this request's timeline records
        #: under (obs/requests.py); None = no timeline (embedded use)
        self.key: Optional[str] = None


class ServingEngine:
    """Continuous-batching scheduler over the paged pool. ``start()``
    spawns the scheduler thread; tests may drive :meth:`step` directly.
    The pool lives on ``device`` (default: the card), which must hold the
    model's weights; ``kv_dtype="int8"`` holds it quantized (PagePool)."""

    def __init__(self, model, *, slots: int = 8, segment: int = 32,
                 page_block: int = 64, pages: Optional[int] = None,
                 cache_bucket: int = 256,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 kv_dtype: Optional[str] = None, queue_cap: int = 64,
                 default_timeout_s: Optional[float] = None,
                 prefix_cache: bool = False,
                 class_weights: Optional[Dict[str, float]] = None,
                 max_tenants: int = 32,
                 slo_ttft_s: float = 1.0, slo_tpot_s: float = 0.25,
                 slo_budget: float = 0.1, device: DeviceLike = None,
                 clock=time.monotonic):
        self.pool = PagePool(model, slots=slots, segment=segment,
                             page_block=page_block, pages=pages,
                             cache_bucket=cache_bucket,
                             prompt_buckets=prompt_buckets,
                             kv_dtype=kv_dtype, prefix_cache=prefix_cache,
                             device=device)
        self.model = model
        self.queue_cap = queue_cap
        self.default_timeout_s = default_timeout_s
        # weighted-fair deficit scheduling across SLO classes: each class
        # with waiting work accrues weight-proportional credit per round,
        # and admission debits the admitted request's token budget
        self.class_weights = dict(class_weights
                                  or {"interactive": 4.0, "batch": 1.0})
        for c in SLO_CLASSES:
            self.class_weights.setdefault(c, 1.0)
        for c, w in self.class_weights.items():
            if not (w > 0):
                raise ValueError(
                    f"class_weights[{c!r}] must be > 0, got {w!r}")
        self.max_tenants = max_tenants
        # SLO targets the default burn-rate alert rules are derived from
        # (obs/alerts.py serving_slo_rules; the daemon registers them on
        # the master aggregator's alert engine)
        if slo_ttft_s <= 0 or slo_tpot_s <= 0:
            raise ValueError("slo_ttft_s / slo_tpot_s must be > 0")
        if not (0.0 < slo_budget < 1.0):
            raise ValueError(
                f"slo_budget must be in (0, 1), got {slo_budget!r}")
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_tpot_s = float(slo_tpot_s)
        self.slo_budget = float(slo_budget)
        self._tenants = set()
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queues: Dict[str, List[_Rec]] = {c: [] for c in SLO_CLASSES}
        self._deficit: Dict[str, float] = {c: 0.0 for c in SLO_CLASSES}
        self._live: Dict[int, _Rec] = {}      # slot -> record
        self._recs: Dict[int, _Rec] = {}      # rid -> record (incl. done)
        self._done_order: List[int] = []      # finished rids, oldest first
        self._next_rid = 0
        self._stop = False
        self._failed: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        # goodput ledger for the scheduler thread (None when the obs
        # plane is off): opened by _run, so in-process tests driving
        # step() directly stay ledger-free and deterministic
        self._gp = None

    # -- client surface (any thread) ---------------------------------------
    def _queue_len_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, prompt, max_new: int, *, eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None, tenant: str = "default",
               slo: str = "interactive",
               prefix_len: Optional[int] = None,
               submit_key: Optional[str] = None) -> int:
        """Queue one request; returns its rid. Raises ValueError for a
        malformed or unservable request and :class:`Overloaded` when the
        queue cap is reached. ``prefix_len`` declares how many leading
        prompt tokens are a shared prefix worth caching (the prefix cache
        inserts no more; matching is always by content); ``submit_key``
        keys this request's phase timeline on the obs request ledger
        (None = record nothing)."""
        r = Request(-1, np.asarray(prompt), int(max_new), eos_id,
                    tenant=str(tenant), slo=str(slo), prefix_len=prefix_len)
        self.pool.validate(r)                  # mutates r.prompt to int32
        left = self.pool.effective_budget(r.prompt.size, r.max_new)
        timeout = timeout_s if timeout_s is not None else \
            self.default_timeout_s
        now = self._clock()
        deadline = None if timeout is None else now + float(timeout)
        with self._lock:
            if self._failed is not None:
                raise RuntimeError(
                    f"serving engine failed and stopped: {self._failed}")
            if (r.tenant not in self._tenants
                    and len(self._tenants) >= self.max_tenants):
                raise ValueError(
                    f"request: tenant {r.tenant!r} would exceed this "
                    f"engine's {self.max_tenants}-tenant label budget")
            if self._queue_len_locked() >= self.queue_cap:
                obs.count("serving.rejected_total", reason="overloaded")
                raise Overloaded(
                    f"queue full ({self.queue_cap} waiting); retry later")
            self._tenants.add(r.tenant)
            rid = self._next_rid
            self._next_rid += 1
            rec = _Rec(rid, r.prompt, left, eos_id, deadline, now,
                       tenant=r.tenant, slo=r.slo, prefix_len=r.prefix_len)
            rec.key = submit_key
            self._recs[rid] = rec
            self._queues[r.slo].append(rec)
            obs.gauge_set("serving.queue_depth", self._queue_len_locked())
            self._wake.notify_all()
        obs.req_phase(submit_key, "admitted", tenant=str(tenant),
                      slo=str(slo))
        return rid

    def submit_prefilled(self, plen: int, first: int, arrays, *,
                         max_new: int, eos_id: Optional[int] = None,
                         timeout_s: Optional[float] = None,
                         tenant: str = "default",
                         slo: str = "interactive",
                         submit_key: Optional[str] = None) -> int:
        """Queue a shipped admission (disaggregation): the prompt was
        prefilled on another worker and arrives as ``arrays`` — the slot's
        page rows for every pool array (``serving/ship.py`` ``unpack``
        output) — plus the prefill's first generated token. The scheduler
        adopts it into the pool instead of prefilling (admit_prefill's
        adopt branch); from there the record is a local admission's: the
        same weighted-fair scheduling, budget/EOS/timeout finalization and
        backpressure. A shipment whose arrays do not fit this pool's
        layout raises ValueError here, before anything is queued."""
        plen = int(plen)
        # a placeholder prompt of the shipped length drives the shared
        # validation (length bounds, tenant charset, slo class, the
        # page-budget check); token values are never needed decode-side
        r = Request(-1, np.zeros(plen, np.int32), int(max_new), eos_id,
                    tenant=str(tenant), slo=str(slo))
        need = self.pool.validate(r)
        self.pool.check_shipment(plen, arrays)
        left = self.pool.effective_budget(plen, int(max_new))
        timeout = timeout_s if timeout_s is not None else \
            self.default_timeout_s
        now = self._clock()
        deadline = None if timeout is None else now + float(timeout)
        with self._lock:
            if self._failed is not None:
                raise RuntimeError(
                    f"serving engine failed and stopped: {self._failed}")
            if (r.tenant not in self._tenants
                    and len(self._tenants) >= self.max_tenants):
                raise ValueError(
                    f"request: tenant {r.tenant!r} would exceed this "
                    f"engine's {self.max_tenants}-tenant label budget")
            if self._queue_len_locked() >= self.queue_cap:
                obs.count("serving.rejected_total", reason="overloaded")
                raise Overloaded(
                    f"queue full ({self.queue_cap} waiting); retry later")
            self._tenants.add(r.tenant)
            rid = self._next_rid
            self._next_rid += 1
            rec = _Rec(rid, None, left, eos_id, deadline, now,
                       tenant=r.tenant, slo=r.slo)
            rec.ship = {"plen": plen, "first": int(first),
                        "arrays": arrays, "need": need}
            rec.key = submit_key
            self._recs[rid] = rec
            self._queues[r.slo].append(rec)
            obs.gauge_set("serving.queue_depth", self._queue_len_locked())
            self._wake.notify_all()
        obs.req_phase(submit_key, "admitted", tenant=str(tenant),
                      slo=str(slo), shipped=True)
        return rid

    def poll(self, rid: int, cursor: int = 0):
        """Tokens generated so far from ``cursor`` on: (tokens, done,
        reason). Raises KeyError for an unknown rid. A poll that observes
        done marks the result collected (eligible for the purge)."""
        with self._lock:
            rec = self._recs[rid]
            if rec.done:
                rec.collected = True
            return list(rec.tokens[cursor:]), rec.done, rec.reason

    def pending_results(self) -> int:
        """Finished results no poll has collected yet (the drain signal
        of a daemon: live and queued work drain before)."""
        with self._lock:
            return sum(1 for rid in self._done_order
                       if rid in self._recs
                       and not self._recs[rid].collected)

    def cancel(self, rid: int) -> bool:
        """Request cancellation; True if the request was still queued or
        running. A live slot's pages free at the next segment boundary."""
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None or rec.done:
                return False
            rec.cancelled = True
            queue = self._queues.get(rec.slo, ())
            if rec.slot is None and rec in queue:
                queue.remove(rec)
                self._finalize_locked(rec, "cancelled")
            self._wake.notify_all()
            return True

    def timings(self, rid: int) -> Dict[str, Optional[float]]:
        """Engine-clock timestamps of one request: t_submit, t_first (None
        until the first token), t_done (None until finalized)."""
        with self._lock:
            rec = self._recs[rid]
            return {"t_submit": rec.t_submit, "t_first": rec.t_first,
                    "t_done": rec.t_done}

    def stats(self) -> Dict[str, float]:
        with self._lock:
            live = len(self._live)
            queued = self._queue_len_locked()
            per_class = {f"queue_{c}": len(q)
                         for c, q in self._queues.items()}
        pool = self.pool
        out = {"queue_depth": queued, "slots_live": live,
               "slots_total": pool.n_slots,
               "pages_used": pool.pages_used,
               "pages_reserved": pool.reserved,
               "pages_total": pool.capacity_pages,
               "page_block": pool.bs,
               "peak_pages_used": pool.peak_pages_used}
        out.update(per_class)
        out.update(pool.prefix_stats())
        return out

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Spawn the scheduler thread. An engine that was stopped starts
        again with its pool (and its graphs) as they were; requests
        submitted while it was stopped wait in the queue."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("serving engine already started")
            self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def alert_rules(self):
        """The engine's SLO alert defaults: multi-window burn-rate rules
        over ``serving.ttft_seconds`` / ``serving.tpot_seconds`` at THIS
        engine's configured targets — what the daemon registers on the
        master aggregator's alert engine."""
        from ..obs.alerts import serving_slo_rules
        return serving_slo_rules(self.slo_ttft_s, self.slo_tpot_s,
                                 self.slo_budget)

    @property
    def failed(self) -> Optional[str]:
        """The error that stopped the scheduler, or None."""
        with self._lock:
            return self._failed

    def _run(self) -> None:
        # goodput window over the scheduler's whole life: device work is
        # the prefill/segment dispatches, the admission-wait below is
        # idle, and goodput.ratio says what fraction of the wall time the
        # card was decoding — the serving twin of the trainer's ledger
        self._gp = obs.goodput.open_ledger("serving")
        try:
            while True:
                with self._lock:
                    while (not self._stop and not self._live
                           and self._queue_len_locked() == 0):
                        self._wake.wait(timeout=1.0)
                    if self._stop:
                        return
                try:
                    self.step()
                except Exception as e:  # a dead scheduler must not look
                    self._fail_all(e)   # alive
                    return
        finally:
            gp, self._gp = self._gp, None
            if gp is not None:
                gp.close()

    def _fail_all(self, exc: BaseException) -> None:
        """A dispatch raised: finalize every outstanding request with
        reason="error" (pollers see done instead of hanging), refuse new
        submissions with the cause, and stop scheduling."""
        traceback.print_exc()
        with self._lock:
            self._failed = f"{type(exc).__name__}: {exc}"
            for queue in self._queues.values():
                for rec in list(queue):
                    self._finalize_locked(rec, "error")
                queue.clear()
            for rec in list(self._live.values()):
                self._release_locked(rec, "error")
            self._set_gauges_locked()

    # -- the scheduler (scheduler thread only) -----------------------------
    def step(self) -> None:
        """One scheduling iteration: reap -> admit/prefill -> decode."""
        self._reap()
        self.admit_prefill()
        if self._live:
            self.decode_segment()

    def _reap(self) -> None:
        """Honour cancels and deadlines at the segment boundary."""
        now = self._clock()
        with self._lock:
            for queue in self._queues.values():
                for rec in list(queue):
                    if rec.cancelled or (rec.deadline is not None
                                         and now >= rec.deadline):
                        queue.remove(rec)
                        self._finalize_locked(
                            rec, "cancelled" if rec.cancelled else "timeout")
            for rec in list(self._live.values()):
                if rec.cancelled or (rec.deadline is not None
                                     and now >= rec.deadline):
                    self._release_locked(
                        rec, "cancelled" if rec.cancelled else "timeout")
            self._set_gauges_locked()

    def admit_prefill(self) -> int:
        """Phase 1: assign free slots to queued requests by weighted-fair
        deficit scheduling across SLO classes (FIFO within a class; a class
        head that does not fit the page budget, even after cold cached
        prefixes are evicted, blocks only its class), run the batched
        prefill (the full prefill for misses, copy-on-write and the suffix
        prefill for prefix-cache hits; shipped admissions are adopted in
        its place), and emit each admission's first token (TTFT stops
        here). Returns the number admitted."""
        with maybe_bucket(self._gp, "host_input"), self._lock:
            group, adopts, members, pending = [], [], [], 0
            free_slots = [s for s in range(self.pool.n_slots)
                          if s not in self._live]
            quantum = float(self.pool.segment)
            for c in SLO_CLASSES:
                if self._queues[c]:
                    w = self.class_weights[c]
                    self._deficit[c] = min(self._deficit[c] + quantum * w,
                                           8 * quantum * w)
                else:
                    self._deficit[c] = 0.0      # no banking while idle
            blocked = set()
            while free_slots:
                avail = [c for c in SLO_CLASSES
                         if self._queues[c] and c not in blocked]
                if not avail:
                    break
                c = max(avail, key=lambda k: self._deficit[k])
                rec = self._queues[c][0]
                if rec.ship is not None:
                    # a shipped admission owns its worst-case pages like
                    # any other; it just skips the prefill dispatch
                    if not self.pool.evict_for(rec.ship["need"], pending,
                                               protect=[p for _, p
                                                        in group]):
                        blocked.add(c)
                        continue
                    self._queues[c].pop(0)
                    self._deficit[c] -= float(rec.left)
                    pending += rec.ship["need"]
                    slot = free_slots.pop(0)
                    rec.slot = slot
                    self._live[slot] = rec
                    adopts.append((slot, rec))
                    members.append(rec)
                    if rec.key is not None:
                        # queue wait of a shipped admission ends here
                        obs.req_phase(rec.key, "scheduled", slot=slot)
                    continue
                plan = self.pool.plan_admission(
                    rec.prompt, rec.left, tenant=rec.tenant,
                    prefix_len=rec.prefix_len)
                if not self.pool.evict_for(plan.need_pages, pending,
                                           protect=[p for _, p in group]
                                           + [plan]):
                    blocked.add(c)  # pages free at segment boundaries
                    continue
                self._queues[c].pop(0)
                self._deficit[c] -= float(rec.left)
                pending += plan.need_pages
                slot = free_slots.pop(0)
                rec.slot = slot
                self._live[slot] = rec
                group.append((slot, plan))
                members.append(rec)
                if rec.key is not None:
                    obs.req_phase(rec.key, "queued", slot=slot)
        if not group and not adopts:
            return 0
        adopted = {rec.rid for _, rec in adopts}
        with obs.span("serving.prefill", batch=len(group) + len(adopts)), \
                maybe_bucket(self._gp, "device"):
            first = self.pool.admit(group)      # device work, lock released
            for slot, rec in adopts:            # ditto: scheduler thread
                s = rec.ship
                self.pool.adopt_slot(slot, s["plen"], s["first"],
                                     s["arrays"], s["need"])
                first[slot] = s["first"]
                rec.ship = None                 # payload consumed
        now = self._clock()
        with maybe_bucket(self._gp, "host_sync"), self._lock:
            for rec in members:
                # a cancel landing during the prefill only sets the flag;
                # the next _reap honours it
                rec.t_first = now
                obs.observe("serving.ttft_seconds", now - rec.t_submit,
                            tenant=rec.tenant)
                if rec.key is not None:
                    # telescoped dur: device prefill (or local adoption)
                    # wall since the queued/scheduled record above
                    obs.req_phase(rec.key,
                                  "adopt" if rec.rid in adopted
                                  else "prefill")
                    obs.req_phase(rec.key, "first_token",
                                  ttft_s=round(now - rec.t_submit, 6))
                tok = first[rec.slot]
                if rec.eos_id is not None and tok == rec.eos_id:
                    self._release_locked(rec, "eos")
                    continue
                rec.tokens.append(tok)
                obs.count("decode.tokens_total", route="serve")
                rec.left -= 1
                rec.skip = 1        # the next segment re-emits this token
                if rec.left <= 0:
                    self._release_locked(rec, "length")
            self._set_gauges_locked()
        return len(group) + len(adopts)

    def decode_segment(self) -> None:
        """Phase 2: one batched decode segment over every live slot, then
        collect tokens, finish requests and return pages."""
        with self._lock:
            live = sorted(self._live)
        if not live:
            return
        with obs.span("serving.segment", live=len(live)), \
                maybe_bucket(self._gp, "device"):
            block = self.pool.run_segment(live)  # device work, lock released
        with maybe_bucket(self._gp, "host_sync"), self._lock:
            for slot in live:
                rec = self._live.get(slot)
                if rec is None or rec.done:
                    continue
                usable = block[slot, rec.skip:]
                rec.skip = 0
                take, done, reason = clip_emission(usable, rec.left,
                                                   rec.eos_id)
                rec.tokens.extend(int(t) for t in take)
                obs.count("decode.tokens_total", len(take), route="serve")
                if rec.key is not None and len(take):
                    # consecutive segments fold into one ledger record
                    obs.req_phase(rec.key, "decode", n=len(take))
                rec.left -= len(take)
                if done:
                    self._release_locked(rec, reason)
            self._set_gauges_locked()

    # -- internals (call with _lock held) ----------------------------------
    def _release_locked(self, rec: _Rec, reason: str) -> None:
        if rec.slot is not None:
            self._live.pop(rec.slot, None)
            self.pool.free_slot(rec.slot)
        self._finalize_locked(rec, reason)

    def _finalize_locked(self, rec: _Rec, reason: str) -> None:
        rec.done, rec.reason = True, reason
        rec.t_done = self._clock()
        obs.count("serving.requests_total", outcome=reason,
                  tenant=rec.tenant)
        if rec.key is not None:
            obs.req_phase(rec.key,
                          "cancel" if reason == "cancelled" else "done",
                          reason=reason, tokens=len(rec.tokens))
        if rec.t_first is not None and len(rec.tokens) > 1:
            # time-per-output-token over the tokens after the first (TTFT
            # owns the first) — the SLO pair dashboards alert on
            obs.observe("serving.tpot_seconds",
                        (rec.t_done - rec.t_first)
                        / (len(rec.tokens) - 1), tenant=rec.tenant)
        self._done_order.append(rec.rid)
        # bound the finished-record memory without dropping results nobody
        # has read: purge collected records first, uncollected ones only
        # past a hard cap
        cap = max(4 * self.queue_cap, 256)
        while len(self._done_order) > cap:
            victim = next((rid for rid in self._done_order
                           if rid not in self._recs
                           or self._recs[rid].collected), None)
            if victim is None:
                if len(self._done_order) <= 4 * cap:
                    break
                victim = self._done_order[0]
            self._done_order.remove(victim)
            self._recs.pop(victim, None)

    def _set_gauges_locked(self) -> None:
        pool = self.pool
        obs.gauge_set("serving.queue_depth", self._queue_len_locked())
        obs.gauge_set("serving.slots_live", len(self._live))
        obs.gauge_set("serving.pages_used", pool.pages_used)
        obs.gauge_set("serving.pages_reserved", pool.reserved)
        used = pool.pages_used * pool.bs
        obs.gauge_set("serving.page_occupancy",
                      pool.live_tokens(list(self._live)) / used
                      if used else 0.0)
        if pool.index is not None:
            obs.gauge_set("serving.prefix_pages_shared",
                          pool.index.live_pages())
