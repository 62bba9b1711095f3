"""paddle_tpu_torch.tune — the measured autotuning plane, the counterpart of
``paddle_tpu/tune``.

The plan knobs the port's routes would otherwise hard-code (the row tile
of a recurrent kernel, the split count of a decode read, the paged
cache's ``page_block``, the serving bucket grids, which certified groups
the fluid executor fuses) are enumerable plan spaces
(:mod:`~paddle_tpu_torch.tune.spaces`); a measurement driver
(:mod:`~paddle_tpu_torch.tune.driver`, :func:`run_tune`) times every
candidate on the current device, and the winners persist in a versioned
cache (:mod:`~paddle_tpu_torch.tune.cache`) the routing entries consult
first. Entries are keyed under ``obs.roofline._device_kind()``: the
card's name, or ``"cpu"``.

The consult functions here are the routing entries' only doorway into
the cache, and fail safe as JAX's do: any miss, hash staleness, schema
mismatch or illegal plan returns the "no tuned entry" answer and the
caller's heuristic decides. A tuned plan changes the launch geometry,
never the ops a route computes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from .cache import (CACHE_ENV, DISABLE_ENV, SCHEMA_VERSION, AutotuneCache,
                    default_cache_path, get_cache, load_cache, reset,
                    set_cache)
from .spaces import (PROFILES, SPACE_DEFS, SPACE_NAMES, fused_candidates,
                     fused_family, space_hash)

__all__ = [
    "AutotuneCache", "CACHE_ENV", "DISABLE_ENV", "SCHEMA_VERSION",
    "default_cache_path", "load_cache", "get_cache", "set_cache", "reset",
    "SPACE_DEFS", "SPACE_NAMES", "PROFILES", "space_hash", "fused_family",
    "fused_candidates", "run_tune", "results_markdown", "MISS",
    "fused_plan", "decode_kernel_min_len", "page_block", "bucket_grid",
    "plan_source",
]

#: sentinel for "no tuned entry applies — the heuristic decides". Distinct
#: from None, which ``decode_kernel_min_len`` returns as a real value.
MISS = object()


def _device_kind() -> str:
    from ..obs.roofline import _device_kind as dk
    return dk()


def _fresh_entry(space: str, kernel: str,
                 family: str) -> Optional[Dict[str, Any]]:
    """The active cache's entry for (space, kernel, device_kind, family),
    or None — misses include hash-stale entries (L008 reports those)."""
    cache = get_cache()
    if cache is None:
        return None
    entry = cache.get(space, kernel, _device_kind(), family)
    if entry is None or entry.get("space_hash") != space_hash(space):
        return None
    return entry


def fused_plan(kernel: str, *, T: int, H: int, gates: int, batch: int,
               dtype=None, limits: Optional[Tuple[int, int]] = None):
    """The tuned route (``ops.rnn_kernels.Route``) of one recurrent-kernel
    call, or None.

    ``kernel`` is a ``LAUNCHES`` name of ops/rnn_kernels.py; ``limits``
    the (SMs, shared memory a block) the call plans for. The cached row
    tile is re-checked for residency on those limits before it is
    honoured (``ops.rnn_kernels.tile_route``): a cache copied from another
    card, or edited by hand, can cost a heuristic fallback, never an
    illegal launch."""
    entry = _fresh_entry("fused_rnn", kernel,
                         fused_family(gates=gates, T=T, H=H, batch=batch))
    if entry is None:
        return None
    from .spaces import route_of
    return route_of(entry.get("plan"), kernel=kernel, H=H, batch=batch,
                    dtype=dtype, limits=limits)


def decode_kernel_min_len():
    """Tuned decode-route crossover: the read length from which the kernel
    serves a decode read on this device_kind. Returns :data:`MISS` when no
    tuned entry applies (heuristic decides), None when the tuned verdict
    is "the plain version everywhere" (a CPU host), else a positive int
    (1 on a card, where every read of a CUDA tensor takes the kernel)."""
    entry = _fresh_entry("decode_route", "decode_attention", "default")
    if entry is None:
        return MISS
    plan = entry.get("plan")
    if not isinstance(plan, dict) or "kernel_min_len" not in plan:
        return MISS
    v = plan["kernel_min_len"]
    if v is None:
        return None
    if isinstance(v, int) and not isinstance(v, bool) and v >= 1:
        return v
    return MISS


def _decode_splits(bh: int, L: int) -> Optional[int]:
    """The tuned split count of a decode read of ``L`` rows for ``bh``
    (sample, head) pairs (``ops.cuda_kernels.decode_splits``), or None.
    Exact (bh, L) families only; a count past the read's rows is
    rejected."""
    entry = _fresh_entry("decode_route", "decode_attention", "default")
    if entry is None:
        return None
    plan = entry.get("plan")
    splits = plan.get("splits") if isinstance(plan, dict) else None
    if not isinstance(splits, dict):
        return None
    from .spaces import decode_family
    n = splits.get(decode_family(bh, L))
    if isinstance(n, int) and not isinstance(n, bool) and 1 <= n <= L:
        return n
    return None


def page_block(max_len: int, cache_bucket: int) -> Optional[int]:
    """Tuned paged-KV page size, validated against the caller's grid
    (must divide ``max_len`` and ``cache_bucket``), or None."""
    entry = _fresh_entry("page_block", "paged_decode_attention", "default")
    if entry is None:
        return None
    plan = entry.get("plan")
    if not isinstance(plan, dict):
        return None
    bs = plan.get("page_block")
    if (isinstance(bs, int) and not isinstance(bs, bool) and bs >= 1
            and max_len % bs == 0 and cache_bucket % bs == 0):
        return bs
    return None


def bucket_grid(kind: str, *, max_len: Optional[int] = None,
                divisor: Optional[int] = None) -> Optional[Tuple[int, ...]]:
    """Tuned prompt/cache bucket grid for serving captures, or None.

    ``kind`` is ``"prompt"`` or ``"cache"``. The winner is re-validated
    here against the caller's constraints, as JAX's is: strictly
    ascending unique positive ints, buckets past ``max_len`` dropped (an
    emptied grid is a miss), and every bucket divisible by ``divisor``
    when given."""
    entry = _fresh_entry("bucket_grid", "prefill_dispatch", kind)
    if entry is None:
        return None
    plan = entry.get("plan")
    if not isinstance(plan, dict):
        return None
    buckets = plan.get("buckets")
    if (not isinstance(buckets, (list, tuple)) or not buckets
            or not all(isinstance(b, int) and not isinstance(b, bool)
                       and b >= 1 for b in buckets)
            or list(buckets) != sorted(set(buckets))):
        return None
    if max_len is not None:
        buckets = [b for b in buckets if b <= max_len]
        if not buckets:
            return None
    if divisor is not None and any(b % divisor for b in buckets):
        return None
    return tuple(buckets)


def plan_source() -> str:
    """"tuned" when an autotune cache with at least one current-hash entry
    for this device_kind is active, else "heuristic" — the bench rows'
    ``plan_source`` stamp (analysis/bench_schema.py)."""
    cache = get_cache()
    if cache is None:
        return "heuristic"
    dk = _device_kind()
    for entry in cache.entries.values():
        if (entry.get("device_kind") == dk
                and entry.get("space") in SPACE_DEFS
                and entry.get("space_hash")
                == space_hash(entry["space"])):
            return "tuned"
    return "heuristic"


def run_tune(*args, **kwargs):
    """Lazy veneer over :func:`tune.driver.run_tune`."""
    from .driver import run_tune as _run
    return _run(*args, **kwargs)


def results_markdown(report):
    from .driver import results_markdown as _md
    return _md(report)
