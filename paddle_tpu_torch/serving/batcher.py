"""Continuous batching over a pinned slot pool, speculative decoding, and
the request records and checks every serving loop shares — the
counterpart of ``paddle_tpu/serving/batcher.py``.

``ContinuousBatcher`` decodes a fixed pool of ``slots`` dense KV caches
(``TransformerLM.prefill``/``decode_step``, so the reads go through kernel
#4, or #5 at ``kv_dtype="int8"``): slots at different positions decode in
one batched step, and the host only acts at segment boundaries. Where the
JAX batcher jits a ``lax.scan`` of ``segment`` steps per read bound and
the admission prefill with its masked merge per prompt bucket, the port
runs each as one CUDA graph on the card (``core/graphs.py``), the pool
donated to both and merged in place. ``SpeculativeDecoder`` verifies a
draft's proposals with ``TransformerLM.verify_step``; a round's device
work (the draft steps and the verify) is one graph. The paged pool
(``serving/paged.py``) is the engine's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.graphs import GraphCache
from ..core.lod import bucket_length
from ..core.place import DeviceLike, resolve_device

#: SLO classes a request may declare — the weighted-fair scheduler's queue
#: key (serving/engine.py). "interactive" is the latency class; "batch"
#: the throughput class that yields slots under contention.
SLO_CLASSES = ("interactive", "batch")

#: the bounded-cardinality contract for the ``tenant`` label: a short
#: identifier from a closed alphabet
TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,31}$")


@dataclass
class Request:
    """One generation request: prompt ids, generation budget, optional EOS
    (generation stops BEFORE emitting eos_id; it is not returned).
    ``prefix_len`` declares how many leading prompt tokens are a shared
    prefix worth caching (the paged pool's prefix cache caps what it
    inserts there; matching is always by content)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    tenant: str = "default"
    slo: str = "interactive"
    prefix_len: Optional[int] = None


def prefix_resubmission_error(declared, recorded) -> Optional[str]:
    """A forwarded resubmission may not declare a ``prefix_len`` above the
    recorded original's; returns the error text, or None when honest."""
    if declared is None:
        return None
    if int(declared) > int(recorded or 0):
        return (f"resubmission declares prefix_len {int(declared)} but the "
                f"recorded original was {int(recorded or 0)} — a forwarded "
                "replay may not inflate its cached-prefix claim "
                "(replay-hardening)")
    return None


def validate_request(r: Request, model, *,
                     max_prefix_len: Optional[int] = None) -> None:
    """Normalize and reject a malformed request at submit time with a
    precise ValueError. Mutates ``r.prompt`` to a flat int32 array."""
    r.prompt = np.asarray(r.prompt, np.int32).reshape(-1)
    who = f"request {r.rid}" if r.rid >= 0 else "request"
    if r.prompt.size == 0:
        raise ValueError(f"{who}: empty prompt (prefill needs at least "
                         "one token)")
    if r.max_new <= 0:
        raise ValueError(f"{who}: max_new must be >= 1, got {r.max_new}")
    if r.prompt.size + 1 > model.max_len:
        raise ValueError(f"{who}: prompt longer than max_len "
                         f"{model.max_len}")
    if r.prompt.min() < 0 or r.prompt.max() >= model.vocab:
        # JAX clamps an out-of-range id silently; an index on the card
        # faults the whole context, so it is refused here
        raise ValueError(f"{who}: token ids must lie in [0, {model.vocab})")
    if not TENANT_RE.match(str(r.tenant)):
        raise ValueError(
            f"{who}: tenant {str(r.tenant)[:40]!r} violates the bounded-"
            "cardinality label contract (need [A-Za-z0-9][A-Za-z0-9._-]"
            "{0,31})")
    if r.slo not in SLO_CLASSES:
        raise ValueError(f"{who}: unknown slo class {r.slo!r} "
                         f"(one of {SLO_CLASSES})")
    if r.prefix_len is not None:
        if int(r.prefix_len) < 0 or int(r.prefix_len) > r.prompt.size:
            raise ValueError(
                f"{who}: declared prefix_len {r.prefix_len} outside the "
                f"prompt (len {r.prompt.size}) — a shared prefix cannot "
                "be longer than the prompt that carries it")
        r.prefix_len = int(r.prefix_len)
    if max_prefix_len is not None:
        err = prefix_resubmission_error(r.prefix_len, max_prefix_len)
        if err is not None:
            raise ValueError(f"{who}: {err}")


def clip_emission(row, left: int, eos_id: Optional[int]):
    """Budget-cap + EOS-truncate one slot's emitted token row. Returns
    ``(take, done, reason)``; EOS stops BEFORE emitting ``eos_id``."""
    take = row[:min(int(left), len(row))]
    done, reason = len(take) >= left, "length"
    if eos_id is not None:
        hits = np.nonzero(take == eos_id)[0]
        if hits.size:
            take, done, reason = take[:hits[0]], True, "eos"
    return take, done, reason


DEFAULT_PROMPT_BUCKETS = (32, 64, 128, 256, 512)


@dataclass
class _Slot:
    req: Optional[Request] = None
    left: int = 0
    out: List[int] = field(default_factory=list)


def _model_device(model, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model's weights are on {model.device} but the "
                         f"batcher is for {dev}; move the model or pass "
                         "device=")
    return dev


class ContinuousBatcher:
    """Continuous batching over a pinned pool of ``slots`` dense KV caches
    padded to max_len: each request's greedy continuation equals its solo
    decode at the same ``kv_dtype``.

    ``schedule`` orders admission: "longest_first" (the default) admits
    the largest effective budgets first, "fifo" in arrival order; the
    outputs are the same either way (greedy decode does not depend on
    the batch). ``cache_bucket``
    bounds each segment's cache read to the next bucket multiple past the
    live slots' positions. ``kv_dtype="int8"`` holds the pool quantized:
    tokens then equal the solo int8 decode."""

    def __init__(self, model, *, slots: int = 8, segment: int = 32,
                 cache_bucket: int = 256,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 schedule: str = "longest_first",
                 kv_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        if schedule not in ("longest_first", "fifo"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        self.schedule = schedule
        self.device = _model_device(model, device)
        self.model = model
        self.n_slots, self.segment = slots, segment
        self.cache_bucket = cache_bucket
        self.prompt_buckets = tuple(prompt_buckets)
        self.kv_dtype = kv_dtype
        self.segments_total = 0
        self.segments_by_len: Dict[int, int] = {}    # cache_len -> count
        self.graphs = GraphCache("ContinuousBatcher", self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _budget(self, r: Request) -> int:
        return min(r.max_new, self.model.max_len - r.prompt.size)

    @torch.no_grad()
    def serve(self, requests: Sequence[Request]) -> Dict[int, np.ndarray]:
        """Run every request to completion; returns {rid: generated ids}."""
        model, n = self.model, self.n_slots
        queue = list(requests)
        for r in queue:
            validate_request(r, model)
        if self.schedule == "longest_first":
            queue.sort(key=lambda r: -self._budget(r))
        slots = [_Slot() for _ in range(n)]
        results: Dict[int, np.ndarray] = {}
        self.graphs.watch(model.parameters())

        # the pool: a dummy full-width prefill at the smallest prompt
        # bucket, padded to max_len
        tpad0 = min(bucket_length(1, self.prompt_buckets), model.max_len - 1)
        cell, _ = model.prefill(self._tensor(np.zeros((n, tpad0), np.int32)),
                                self._tensor(np.zeros((n,), np.int32)),
                                kv_dtype=self.kv_dtype)
        cur = torch.zeros((n,), dtype=torch.int32, device=self.device)
        pos_host = np.zeros((n,), np.int64)

        def admit():
            nonlocal cell, cur
            free = [i for i, s in enumerate(slots) if s.req is None]
            group = [(i, queue.pop(0)) for i in free[:len(queue)]]
            if not group:
                return
            tpad = min(bucket_length(max(r.prompt.size for _, r in group),
                                     self.prompt_buckets),
                       model.max_len - 1)
            prompts = np.zeros((n, tpad), np.int32)
            lens = np.zeros((n,), np.int32)
            mask = np.zeros((n,), bool)
            for i, r in group:
                prompts[i, :r.prompt.size] = r.prompt
                lens[i] = r.prompt.size
                mask[i] = True
            cell, cur = self.graphs.run(
                "admit", self._admit_body,
                {"cell": cell, "cur": cur, "prompts": torch.from_numpy(prompts),
                 "lens": torch.from_numpy(lens),
                 "mask": torch.from_numpy(mask)},
                donate=("cell", "cur"))
            for i, r in group:
                slots[i] = _Slot(r, self._budget(r), [])
                pos_host[i] = r.prompt.size

        def park_idle():
            # drained slots decode on; reset them before a segment could
            # carry their position to max_len
            idle = [i for i, s in enumerate(slots) if s.req is None
                    and pos_host[i] + 2 * self.segment >= model.max_len]
            if idle:
                cell["pos"][self._tensor(np.asarray(idle, np.int64))] = 0
                pos_host[idle] = 0

        admit()
        while any(s.req is not None for s in slots):
            park_idle()
            # reads sized to the live slots only: a drained slot at a high
            # position reads at most cache_len rows of garbage
            max_pos = max(int(pos_host[i]) for i, s in enumerate(slots)
                          if s.req is not None)
            cache_len = min(-(-(max_pos + self.segment + 1)
                              // self.cache_bucket) * self.cache_bucket,
                            model.max_len)
            cell, cur, block = self.graphs.run(
                "segment", self._segment_body, {"cell": cell, "cur": cur},
                static={"cache_len": cache_len}, donate=("cell", "cur"))
            # one dispatch serves `segment` tokens across every live slot
            obs.count("decode.dispatches_total", route="serve_segment")
            block = block.cpu().numpy()
            self.segments_total += 1
            self.segments_by_len[cache_len] = \
                self.segments_by_len.get(cache_len, 0) + 1
            pos_host += self.segment
            for i, s in enumerate(slots):
                if s.req is None:
                    continue
                take, done, _ = clip_emission(block[i], s.left, s.req.eos_id)
                s.out.extend(int(t) for t in take)
                obs.count("decode.tokens_total", len(take), route="serve")
                s.left -= len(take)
                if done:
                    results[s.req.rid] = np.asarray(s.out, np.int32)
                    slots[i] = _Slot()
            admit()
        return results

    @torch.no_grad()
    def _admit_body(self, cell, cur, prompts, lens, mask):
        """The admission program: a pool-width prefill of prompts [slots,
        tpad], merged into the rows of the slots in ``mask`` in place
        (cache rows past tpad keep what they held: they lie past pos, are
        never read, and are written before pos reaches them), with each
        admitted slot's first token into ``cur``. Returns (cell, cur)."""
        tpad = prompts.shape[1]
        new, last = self.model.prefill(prompts, lens, kv_dtype=self.kv_dtype,
                                       pad_to=tpad)
        for nm, t in cell.items():
            if nm == "pos":
                t.copy_(torch.where(mask, new[nm], t))
            else:
                m = mask.view((-1,) + (1,) * (t.dim() - 1))
                t[:, :tpad] = torch.where(m, new[nm], t[:, :tpad])
        cur.copy_(torch.where(mask, torch.argmax(last, dim=-1).to(cur.dtype),
                              cur))
        return cell, cur

    @torch.no_grad()
    def _segment_body(self, cell, cur, *, cache_len):
        """The segment program: ``segment`` decode steps over the first
        ``cache_len`` cache rows, the position and token carried into
        ``cell["pos"]`` and ``cur`` in place. Returns (cell, cur, the
        tokens fed to each step [slots, segment])."""
        c, tok, toks = cell, cur, []
        for _ in range(self.segment):
            logits, c = self.model.decode_step(c, tok, cache_len=cache_len)
            toks.append(tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        cell["pos"].copy_(c["pos"])
        block = torch.stack(toks, dim=1)
        cur.copy_(tok)
        return cell, cur, block


class SpeculativeDecoder:
    """Speculative greedy decoding: a draft proposes ``k - 1`` tokens a
    round, the target scores the whole span in one ``verify_step`` and
    emits the longest agreeing prefix plus its own next token. Every
    emitted token is the target's greedy choice, so the output is the
    target's greedy decode for any draft; the draft only sets how many
    tokens a round yields. Rejected rows lie past the reset position and
    are overwritten before they are read.

    ``draft`` is any model with ``prefill(prompt[, kv_dtype=])`` and
    ``decode_step(cell, tokens)``; the target itself reading an int8 cache
    (``draft_kv_dtype="int8"``) is the self-speculation draft. The target
    holds its cache at full precision."""

    def __init__(self, model, draft, *, k: int = 4,
                 draft_kv_dtype: Optional[str] = None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.model, self.draft, self.k = model, draft, k
        self.draft_kv_dtype = draft_kv_dtype
        self.graphs = GraphCache("SpeculativeDecoder", model.device)

    @torch.no_grad()
    def generate(self, prompt, steps: int) -> Tuple[np.ndarray, Dict]:
        """prompt [B, T0] (or [T0]) -> (tokens [B, steps] int32, stats:
        rounds / proposed / accepted / acceptance_rate). The accept loop,
        positions and tokens stay on the host, as in JAX; a round's device
        work is :meth:`_round_body`, one CUDA graph per (B, k) on the
        card."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        B, T0 = prompt.shape
        if T0 == 0:
            raise ValueError("empty prompt (prefill needs >= 1 token)")
        # frozen samples re-write up to k span rows past their last
        # position and a final round can overshoot by k - 1: 2k of margin
        need = T0 + steps + 2 * self.k
        for name, m in (("model", self.model), ("draft", self.draft)):
            if need > m.max_len:
                raise ValueError(
                    f"prompt ({T0}) + steps ({steps}) + 2k ({2 * self.k}) "
                    f"exceeds {name} max_len ({m.max_len})")
        dev = self.model.device
        ids = torch.from_numpy(prompt).to(dev)
        cell, last = self.model.prefill(ids)
        obs.count("decode.dispatches_total", route="spec_prefill")
        cur = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
        dcell, _ = (self.draft.prefill(ids, kv_dtype=self.draft_kv_dtype)
                    if self.draft_kv_dtype is not None
                    else self.draft.prefill(ids))
        self.graphs.watch([p for m in (self.model, self.draft)
                           if isinstance(m, torch.nn.Module)
                           for p in m.parameters()])

        pos = np.full((B,), T0, np.int64)
        emitted: List[List[int]] = [[int(t)] for t in cur]
        rounds = proposed = accepted = 0
        while min(len(e) for e in emitted) < steps:
            cell, dcell, out = self.graphs.run(
                "round", self._round_body,
                {"cell": cell, "dcell": dcell,
                 "pos": torch.from_numpy(pos.astype(np.int32)),
                 "cur": torch.from_numpy(cur)},
                donate=("cell", "dcell"))
            # the round's graph holds JAX's k draft dispatches and its
            # verify: counted under JAX's routes, so the counts agree
            if self.k > 1:
                obs.count("decode.dispatches_total", self.k,
                          route="spec_draft")
            obs.count("decode.dispatches_total", route="spec_verify")
            out = out.cpu().numpy()
            t_np, props_np = out[:, :self.k], out[:, self.k:]
            next_cur = cur.copy()
            for b in range(B):
                if len(emitted[b]) >= steps:
                    continue                # frozen: pos and cur hold
                m = 0
                while m < self.k - 1 and props_np[b, m] == t_np[b, m]:
                    m += 1
                emitted[b].extend(int(x) for x in t_np[b, :m + 1])
                next_cur[b] = t_np[b, m]
                pos[b] += m + 1
                proposed += self.k - 1
                accepted += m
            cur = next_cur
            rounds += 1
        obs.count("decode.spec_proposed_total", proposed)
        obs.count("decode.spec_accepted_total", accepted)
        obs.count("decode.tokens_total", B * steps, route="spec")
        out = np.asarray([e[:steps] for e in emitted], np.int32)
        return out, {"rounds": rounds, "proposed": proposed,
                     "accepted": accepted,
                     "acceptance_rate": (accepted / proposed if proposed
                                         else 1.0)}

    @torch.no_grad()
    def _round_body(self, cell, dcell, pos, cur):
        """A round's device work: from token ``cur`` at the accepted
        positions ``pos`` the draft proposes k - 1 tokens, then one more
        step writes the last proposal's row (on a fully accepted round it
        becomes live); the target scores the span [cur, proposals] in one
        ``verify_step``. Rejected rows lie past the next round's position
        and are overwritten before they are read. Returns (cell, dcell,
        [B, 2k - 1]: the target's k choices, then the k - 1
        proposals)."""
        dc = dict(dcell, pos=pos)
        d_cur, props = cur, []
        for i in range(self.k if self.k > 1 else 0):
            logits, dc = self.draft.decode_step(dc, d_cur)
            d_cur = torch.argmax(logits, dim=-1).to(torch.int32)
            if i < self.k - 1:
                props.append(d_cur)     # the k-th output is discarded
        span = torch.stack([cur] + props, dim=1)              # [B, k]
        logits, _ = self.model.verify_step(dict(cell, pos=pos), span)
        choice = torch.argmax(logits, dim=-1).to(torch.int32)
        return cell, dcell, torch.cat([choice, span[:, 1:]], dim=1)
