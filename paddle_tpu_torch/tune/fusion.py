"""The graph-level fusion pass, measured-only — the counterpart of
``paddle_tpu/tune/fusion.py``.

``analysis.dataflow.fusable_groups()`` emits legality-certified fusion
candidates (elementwise chains and producer->consumer epilogues, each with
a dependence certificate); this module decides which certified groups the
Executor runs as one fused region, and, as in JAX, the answer is never a
heuristic: it comes from the autotune cache's ``fusion`` space, where
every entry records a fused-vs-unfused measurement of this program family
on this ``device_kind``.

On the card a block already runs as one CUDA graph, so a fused region is
a scheduling unit of that graph: its member ops run together at the
first member's slot, in their own order, under one ``record_function``
range tagged ``b{B}_op{first}_fused_<kind>`` (JAX's named-scope tag),
which ``obs/xplane.py`` attributes the kernels to. It computes the same
ops in the same order as the unfused run, so the two are bit-equal, and
whether a region ships is decided by the measurement alone.

The consult chain is JAX's, fail-safe at every link:

1. the oracle must certify the group today (``fusable_groups``);
2. the rewrite must be schedulable (``analysis.region_schedulable``);
3. a cache entry must exist under the exact key
   ``fusion | group kind | device_kind | program_sig:shape_family:group_sig``
   with a fresh ``space_hash``;
4. the entry's persisted certificate must still match the group
   (``analysis.certificate_matches``);
5. the entry's measured verdict must be ``fuse: true``.

Every rejection counts on ``fluid.fusion_rejected_total{reason}`` and
every activation on ``fluid.fused_regions_total{source}``, once per plan
decision (the executor memoizes plans).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .cache import get_cache
from .spaces import space_hash

FUSION_SPACE = "fusion"

#: consult-refusal reasons (the bounded label set of
#: ``fluid.fusion_rejected_total``)
REJECT_REASONS = ("no_entry", "stale", "invalid_plan", "cert_invalid",
                  "measured_slower", "not_schedulable")


def _device_kind() -> str:
    from ..obs.roofline import _device_kind as dk
    return dk()


# --------------------------------------------------------------------------
# keys: program signature + shape family + group signature
# --------------------------------------------------------------------------

def program_signature(program) -> str:
    """Content hash of the global block's op list — the stable half of a
    ``fusion`` family key: a pure function of the desc (op types, io
    names, non-callable attrs), so a tuned entry written by one process
    resolves in another that rebuilt the same program."""
    block = program.blocks[0]
    blob = [{"type": op.type,
             "inputs": {k: list(v) for k, v in sorted(op.inputs.items())},
             "outputs": {k: list(v) for k, v in sorted(op.outputs.items())},
             "attrs": {k: repr(v) for k, v in sorted(op.attrs.items())
                       if not callable(v)}}
            for op in block.ops]
    raw = json.dumps(blob, sort_keys=True).encode()
    return hashlib.sha1(raw).hexdigest()[:12]


def certificate(program, group) -> Dict[str, Any]:
    """The persistable form of one group's dependence certificate:
    ``FusionGroup.to_dict()`` plus the member op types (indices alone
    can't detect an op swapped in place)."""
    block = program.blocks[group.block_idx]
    d = group.to_dict()
    d["op_types"] = [block.ops[i].type for i in group.op_idxs]
    return d


def group_signature(cert: Mapping[str, Any]) -> str:
    """Digest of one certificate's identity-bearing fields — the third
    component of a fusion family key, recomputable by L008 from the
    persisted entry alone."""
    blob = json.dumps(
        {"kind": cert.get("kind"),
         "op_idxs": list(cert.get("op_idxs") or []),
         "op_types": list(cert.get("op_types") or []),
         "inputs": list(cert.get("inputs") or []),
         "outputs": list(cert.get("outputs") or []),
         "edges": [e.get("var") for e in (cert.get("edges") or [])]},
        sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


def _pow2(n: int) -> int:
    v = 1
    while v < n:
        v *= 2
    return v


def shape_family(feed_shapes: Mapping[str, Tuple[int, ...]]) -> str:
    """Digest of the feed signature with every dim rounded up to a power
    of two — the shape-family half of the key: a measured verdict holds
    for the shape *family* it was measured on (batch jitter within a
    pow-2 bucket shares the entry), never interpolates across families."""
    parts = "|".join(
        f"{n}:{'x'.join(str(_pow2(max(1, int(d)))) for d in shp)}"
        for n, shp in sorted(feed_shapes.items()))
    return hashlib.sha1(parts.encode()).hexdigest()[:10]


def fusion_family(prog_sig: str, shape_fam: str, group_sig: str) -> str:
    """``program_sig:shape_family:group_sig`` — L008 re-derives the third
    component from the entry's persisted certificate and flags any
    mismatch (a hand-edited or wrongly merged cache)."""
    return f"{prog_sig}:{shape_fam}:{group_sig}"


# --------------------------------------------------------------------------
# the consult: FusionPlan
# --------------------------------------------------------------------------

@dataclass
class FusionPlan:
    """One plan decision for (program, feed shapes, fetch): the activated
    groups, their family keys, the per-family rejections, and the source
    stamp. ``key()`` joins the executor's compiled-fn cache key so fused
    and unfused decisions compile separate entries."""

    groups: List[Any] = field(default_factory=list)
    families: List[str] = field(default_factory=list)
    rejected: List[Tuple[str, str]] = field(default_factory=list)
    source: str = "off"          # "tuned" | "forced" | "off"

    def key(self) -> Tuple:
        return tuple((g.kind, tuple(g.op_idxs)) for g in self.groups)


EMPTY_PLAN = FusionPlan()


def cache_has_fusion_entries(device_kind: Optional[str] = None) -> bool:
    """Cheap pre-gate for the executor's hot path: with no ``fusion``
    entries for this device_kind in the active cache, the measured-only
    answer is 'unfused' for every group — skip the dataflow analysis
    entirely."""
    cache = get_cache()
    if cache is None:
        return False
    dk = device_kind or _device_kind()
    return any(e.get("space") == FUSION_SPACE
               and e.get("device_kind") == dk
               for e in cache.entries.values())


def plan_for(program, feed_shapes: Mapping[str, Tuple[int, ...]], *,
             fetch: Sequence[str] = (), feed: Sequence[str] = (),
             force: Any = None) -> FusionPlan:
    """The fusion decision for one (program, feed shapes, fetch).

    ``force=None`` is the production path: consult the autotune cache,
    activate only measured winners.  ``force=True`` activates every
    schedulable certified group; a set of first-op indices activates
    exactly those groups (the measurement harness's per-group knob).
    Both forced forms still require certification AND schedulability —
    forcing can cost speed, never correctness."""
    from .. import obs
    from ..analysis.dataflow import (certificate_matches, fusable_groups,
                                     region_schedulable)
    groups = fusable_groups(program, fetch=fetch, feed=feed)
    if not groups:
        return EMPTY_PLAN
    block = program.blocks[0]
    plan = FusionPlan(source="forced" if force is not None else "tuned")

    prog_sig = shp = dk = None
    cache = None
    if force is None:
        cache = get_cache()
        prog_sig = program_signature(program)
        shp = shape_family(feed_shapes)
        dk = _device_kind()

    for g in groups:
        cert = certificate(program, g)
        if force is not None:
            wanted = (force is True
                      or (hasattr(force, "__contains__")
                          and g.op_idxs[0] in force))
            if not wanted:
                continue
            fam = f"forced:g{g.op_idxs[0]}"
            if not region_schedulable(block, g):
                plan.rejected.append((fam, "not_schedulable"))
                obs.count("fluid.fusion_rejected_total",
                          reason="not_schedulable")
                continue
            plan.groups.append(g)
            plan.families.append(fam)
            obs.count("fluid.fused_regions_total", source="forced")
            continue

        fam = fusion_family(prog_sig, shp, group_signature(cert))

        def reject(reason: str) -> None:
            plan.rejected.append((fam, reason))
            obs.count("fluid.fusion_rejected_total", reason=reason)

        entry = (cache.get(FUSION_SPACE, g.kind, dk, fam)
                 if cache is not None else None)
        if entry is None:
            reject("no_entry")
            continue
        if entry.get("space_hash") != space_hash(FUSION_SPACE):
            reject("stale")
            continue
        p = entry.get("plan")
        if not isinstance(p, dict) or not isinstance(p.get("fuse"), bool):
            reject("invalid_plan")
            continue
        if (entry.get("program_signature") != prog_sig
                or not certificate_matches(entry.get("certificate"), g,
                                           cert["op_types"])):
            reject("cert_invalid")
            continue
        if not region_schedulable(block, g):
            reject("not_schedulable")
            continue
        if not p["fuse"]:
            reject("measured_slower")
            continue
        plan.groups.append(g)
        plan.families.append(fam)
        obs.count("fluid.fused_regions_total", source="tuned")
    if not plan.groups and not plan.rejected:
        return EMPTY_PLAN
    return plan


# --------------------------------------------------------------------------
# the measurement: fused-vs-unfused per certified group
# --------------------------------------------------------------------------

def _time_run(exe, program, feed, fetch, reps: int) -> float:
    """Best-of-``reps`` seconds of one whole ``exe.run`` — the first run
    (the eager run and the graph capture) outside the window, as
    :func:`tune.driver.measure_callable` times: CUDA events on a card,
    the wall clock elsewhere."""
    from .driver import measure_callable
    return measure_callable(
        lambda: exe.run(program, feed=feed, fetch_list=fetch,
                        return_numpy=False), (), reps=reps, space="fusion",
        device=exe.device)


def measure_fusion(program, startup, feed: Dict[str, Any],
                   fetch: Sequence[str], *, reps: int = 2,
                   note: str = "", device=None) -> List[Dict[str, Any]]:
    """Measure every certified group of ``program`` fused vs unfused —
    whole-pipeline executor dispatches, one group toggled at a time — and
    return one cache-entry row per group (``plan: {"fuse": bool}`` plus
    the certificate and both timings).  A group only earns ``fuse: true``
    by beating the unfused baseline on THIS backend; rows for losing
    groups persist too, so the consult can distinguish "measured slower"
    from "never measured"."""
    import numpy as np

    from ..core.place import require_device
    from ..fluid.executor import Executor, Scope
    device = require_device(device)
    fetch_names = [v if isinstance(v, str) else v.name for v in fetch]
    groups_src = _certified(program, feed, fetch_names)
    if not groups_src:
        return []
    prog_sig = program_signature(program)
    shp = shape_family({k: np.shape(v) for k, v in feed.items()})

    def timed(fuse) -> float:
        exe = Executor(scope=Scope(), fuse=fuse, device=device)
        if startup is not None:
            exe.run(startup)
        return _time_run(exe, program, feed, fetch_names, reps)

    base_s = timed(False)
    rows: List[Dict[str, Any]] = []
    for g in groups_src:
        cert = certificate(program, g)
        fused_s = timed(frozenset((g.op_idxs[0],)))
        fuse = fused_s < base_s
        rows.append({
            "space": FUSION_SPACE, "kernel": g.kind,
            "family": fusion_family(prog_sig, shp, group_signature(cert)),
            "plan": {"fuse": fuse},
            "tuned_ms": round(min(fused_s, base_s) * 1e3, 4),
            "heuristic_plan": {"fuse": False},
            "heuristic_ms": round(base_s * 1e3, 4),
            "fused_ms": round(fused_s * 1e3, 4),
            "unfused_ms": round(base_s * 1e3, 4),
            "speedup": round(base_s / fused_s, 3) if fused_s else None,
            "program_signature": prog_sig,
            "shape_family": shp,
            "certificate": cert,
            "n_ops": len(g.op_idxs),
            "candidates": 2,
            "note": note,
        })
    return rows


def _certified(program, feed, fetch_names):
    """Schedulable certified groups only — measuring an unschedulable
    group would time the unfused fallback twice and could persist a
    meaningless 'win'."""
    from ..analysis.dataflow import fusable_groups, region_schedulable
    block = program.blocks[0]
    return [g for g in fusable_groups(program, fetch=fetch_names,
                                      feed=list(feed))
            if region_schedulable(block, g)]


def build_proxy_program(*, batch: int = 32, width: int = 64,
                        depth: int = 3, seed: int = 0):
    """The driver's fusion-sweep workload: an MLP regression step whose
    graph carries BOTH certified group kinds — each fc layer's
    bias-add+activation is an elementwise chain, and a scale/add epilogue
    rides the logits — plus SGD, so donation interacts with the fused
    path exactly as in a real training loop.

    Resets the default programs (same contract as the benchmarks) and
    returns ``(main_program, startup_program, feed, fetch_names)``."""
    import numpy as np

    from .. import fluid
    fluid.reset_default_programs()
    x = fluid.layers.data("fusion_x", shape=(width,))
    y = fluid.layers.data("fusion_y", shape=(1,))
    h = x
    for _ in range(depth):
        h = fluid.layers.fc(h, width, act="relu")
    out = fluid.layers.fc(h, 1)
    # elementwise epilogue chain on the residual: sub -> mul (squared err)
    err = fluid.layers.elementwise_sub(out, y)
    loss = fluid.layers.mean(fluid.layers.elementwise_mul(err, err))
    fluid.SGDOptimizer(1e-2).minimize(loss)
    rs = np.random.RandomState(seed)
    feed = {"fusion_x": rs.randn(batch, width).astype(np.float32),
            "fusion_y": rs.randn(batch, 1).astype(np.float32)}
    return (fluid.default_main_program(), fluid.default_startup_program(),
            feed, [loss.name])
