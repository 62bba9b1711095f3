"""The device cost ledger — chip utilization as a first-class obs signal,
the port's counterpart of ``paddle_tpu/obs/roofline.py``.

One resolution path for every ``mfu`` / ``hbm_bw_util`` figure:

* **Peak tables** — dense-peak TFLOP/s *and* HBM GB/s keyed by
  ``torch.cuda.get_device_name()``. One row: the card the port runs on,
  NVIDIA's data-sheet figures for the H100 SXM part at its 700 W power
  limit (989 TFLOP/s dense bf16, 3350 GB/s of HBM3). No TPU row is
  carried over: an unknown device, the CPU included, resolves to
  ``None`` and every derived utilization is then an honest null. Override
  with ``PADDLE_TPU_PEAK_TFLOPS`` / ``PADDLE_TPU_PEAK_HBM_GBPS``.
* **Per-key costs** — JAX reads ``cost_analysis()`` off an AOT executable
  once per argument signature. The port compiles no XLA programs: it
  counts a body's cost once per ``GraphCache`` key (:func:`body_cost`) by
  running the body on ``meta`` copies of its inputs, FLOPs under
  ``torch.utils.flop_counter.FlopCounterMode`` and bytes under a
  ``TorchDispatchMode`` that adds each aten op's input and output bytes
  (the counterpart of XLA's "bytes accessed").
* **Kernel cost models** — the port's kernels are ctypes calls that
  neither mode sees, as XLA sees Pallas custom calls as zero: their plain
  versions run :func:`opaque` to the count, and each wrapper contributes
  the modeled bytes JAX registers (:func:`register_kernel_cost` /
  :func:`kernel_cost`, registered by ``ops/cuda_kernels.py`` and
  ``ops/rnn_kernels.py``) and no FLOPs.
* **Accounting** — :func:`account` accumulates
  ``fluid.device_flops_total`` / ``fluid.device_bytes_total`` on the
  installed session and derives the live ``roofline.mfu`` /
  ``roofline.hbm_bw_util`` gauges from the counter deltas over a short
  window.

Failure is loud but bounded: a cost count that raises warns ONCE per
process, counts ``roofline.cost_analysis_failures_total``, and resolves to
``None``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

# -- peak tables (the roofline's two ceilings) ---------------------------------

#: dense bf16 peak TFLOP/s by torch.cuda.get_device_name(): NVIDIA's data
#: sheet for the H100 SXM part (700 W power limit; a card set below it runs
#: slower under load)
PEAK_TFLOPS: Dict[str, Optional[float]] = {
    "NVIDIA H100 80GB HBM3": 989.0,
    "cpu": None,
}

#: HBM bandwidth GB/s by device name (same source and part)
PEAK_HBM_GBPS: Dict[str, Optional[float]] = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "cpu": None,
}


def _device_kind() -> str:
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    return "cpu"


_warned_env_vars: set = set()


def _env_peak(var: str) -> Optional[float]:
    """``float(os.environ[var])`` with a malformed value demoted to a
    once-per-process warning and a fall-through to the device table."""
    env = os.environ.get(var)
    if not env:
        return None
    try:
        return float(env)
    except ValueError:
        with _warn_lock:
            if var in _warned_env_vars:
                return None
            _warned_env_vars.add(var)
        warnings.warn(
            f"ignoring malformed {var}={env!r} (expected a number); peak "
            "resolves from the built-in device table instead",
            RuntimeWarning, stacklevel=3)
        return None


def peak_flops_per_sec() -> Optional[float]:
    """Chip dense peak in FLOP/s, or None when unknown (derived MFU is
    then omitted/null)."""
    env = _env_peak("PADDLE_TPU_PEAK_TFLOPS")
    if env is not None:
        return env * 1e12
    tf = PEAK_TFLOPS.get(_device_kind())
    return None if tf is None else tf * 1e12


def peak_hbm_bytes_per_sec() -> Optional[float]:
    """Chip HBM bandwidth in bytes/s, or None when unknown."""
    env = _env_peak("PADDLE_TPU_PEAK_HBM_GBPS")
    if env is not None:
        return env * 1e9
    gb = PEAK_HBM_GBPS.get(_device_kind())
    return None if gb is None else gb * 1e9


# -- failure path ---------------------------------------------------------------

_warned_cost_failure = False
_warn_lock = threading.Lock()


def cost_failure(where: str, exc: Optional[BaseException] = None) -> None:
    """A cost count failed: count it and warn ONCE per process."""
    from . import count
    count("roofline.cost_analysis_failures_total")
    global _warned_cost_failure
    with _warn_lock:
        if _warned_cost_failure:
            return
        _warned_cost_failure = True
    detail = f": {type(exc).__name__}: {exc}" if exc is not None else ""
    warnings.warn(
        f"meta-tensor cost count failed at {where}{detail} — derived "
        "FLOPs/bytes resolve to null for this key (counted in "
        "roofline.cost_analysis_failures_total; further failures this "
        "process are counted silently)",
        RuntimeWarning, stacklevel=3)


# -- the per-key cost record ----------------------------------------------------

class Cost:
    """FLOPs + bytes of ONE call of a body. ``None`` fields mean the count
    could not resolve them — honest unknowns. ``peak_hbm_bytes`` has no
    counterpart (no memory analysis runs) and stays None."""

    __slots__ = ("flops", "bytes", "peak_hbm_bytes")

    def __init__(self, flops: Optional[float] = None,
                 bytes: Optional[float] = None,
                 peak_hbm_bytes: Optional[int] = None):
        self.flops = flops
        self.bytes = bytes
        self.peak_hbm_bytes = peak_hbm_bytes

    def __repr__(self):
        return (f"Cost(flops={self.flops}, bytes={self.bytes}, "
                f"peak_hbm_bytes={self.peak_hbm_bytes})")


_opaque_tls = threading.local()


class opaque:
    """Inside a cost count, run the block with the counting modes off: what
    a kernel wrapper's plain version runs under, so that a kernel counts
    as zero FLOPs and zero bytes in the modes, as a Pallas custom call
    does in XLA's analysis (the wrapper adds its modeled bytes instead).
    A no-op outside a count."""

    def __enter__(self):
        self._ctx = None
        if getattr(_opaque_tls, "counting", 0):
            from torch.utils._python_dispatch import _disable_current_modes
            self._ctx = _disable_current_modes()
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return False


def _bytes_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Bytes(TorchDispatchMode):
        """Each aten op's input and output tensor bytes (views are free)."""

        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                for t in tree_leaves((args, kwargs, out)):
                    if isinstance(t, torch.Tensor):
                        self.total += t.numel() * t.element_size()
            return out

    return _Bytes()


def _to_meta(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to_meta(v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    import dataclasses
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_meta(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def body_cost(body: Callable, inputs: Dict[str, Any],
              static: Optional[Dict[str, Any]] = None,
              where: str = "body", modules=()) -> Optional[Cost]:
    """The :class:`Cost` of one call of ``body(**inputs, **static)``,
    counted on ``meta`` copies of the inputs (and of the parameters and
    buffers of ``modules``, the weights a body reads without taking them
    as inputs): FLOPs by ``FlopCounterMode``, bytes by the aten bytes
    mode. The body's counter increments are taken and dropped (the call
    is a count, not work); a body that cannot run on meta tensors
    resolves to None through :func:`cost_failure`."""
    import contextlib
    import torch
    from torch.nn.utils.stateless import _reparametrize_module
    from torch.utils.flop_counter import FlopCounterMode
    from . import recording
    meta = _to_meta(inputs)
    static = {k: (None if isinstance(v, torch.Generator) else v)
              for k, v in (static or {}).items()}
    bm = _bytes_mode()
    fc = FlopCounterMode(display=False)
    _opaque_tls.counting = getattr(_opaque_tls, "counting", 0) + 1
    try:
        with contextlib.ExitStack() as st:
            for m in modules:
                st.enter_context(_reparametrize_module(m, {
                    n: _to_meta(t) for n, t in itertools.chain(
                        m.named_parameters(), m.named_buffers())}))
            st.enter_context(recording())
            st.enter_context(collect_kernel_bytes())
            with fc, bm:
                body(**meta, **static)
    except Exception as e:
        cost_failure(where, e)
        return None
    finally:
        _opaque_tls.counting -= 1
    flops = float(fc.get_total_flops())
    return Cost(flops=flops if flops > 0 else None,
                bytes=float(bm.total) if bm.total > 0 else None)


# -- kernel cost models (the kernels' zero-FLOP override) ----------------------

#: kernel name -> callable(**meta) -> modeled HBM bytes per dispatch
_KERNEL_COSTS: Dict[str, Callable[..., float]] = {}


def register_kernel_cost(kernel: str, fn: Callable[..., float]) -> None:
    """Register the modeled HBM bytes of one launch of a hand kernel (the
    kernel's own module does, at import); every consumer resolves through
    :func:`kernel_cost`, so the modeled number has exactly one owner."""
    _KERNEL_COSTS[kernel] = fn


def kernel_cost(kernel: str, **meta) -> Optional[float]:
    """Modeled HBM bytes for one launch of ``kernel`` under ``meta``;
    None when no model is registered."""
    fn = _KERNEL_COSTS.get(kernel)
    if fn is None:
        return None
    return float(fn(**meta))


def registered_kernels() -> Tuple[str, ...]:
    return tuple(sorted(_KERNEL_COSTS))


# -- per-call kernel-byte collection ---------------------------------------------
# A kernel launch site counts its modeled bytes into kernels.bytes_total
# when it runs; inside a graph capture that count is taken by obs.recording
# and re-emitted per replay. The owner of a call (GraphCache) also wraps it
# in collect_kernel_bytes() to learn the call's bytes for account()'s
# extra: a capture's collection is kept with the graph and reused per
# replay, as JAX's executor re-emits its trace-time collection per run.

_collect = threading.local()


class collect_kernel_bytes:
    """Context manager around one call: collects the kernel bytes
    recorded by launch sites inside. ``per_kernel`` (kernel -> bytes of
    the call) is set at exit."""

    def __init__(self):
        self.per_kernel: Dict[str, float] = {}

    def __enter__(self):
        stack = getattr(_collect, "stack", None)
        if stack is None:
            stack = _collect.stack = []
        stack.append({})
        return self

    def __exit__(self, *exc):
        self.per_kernel = _collect.stack.pop()
        return False


def record_kernel_bytes(kernel: str, nbytes: Optional[float]) -> bool:
    """Record one launch's modeled bytes with the innermost collector;
    False when none is active."""
    stack = getattr(_collect, "stack", None)
    if not stack:
        return False
    if nbytes:
        d = stack[-1]
        d[kernel] = d.get(kernel, 0.0) + float(nbytes)
    return True


def note_kernel_bytes(kernel: str, nbytes: Optional[float]) -> None:
    """What a kernel launch site calls with one launch's modeled bytes:
    counted into ``kernels.bytes_total`` (re-emitted per replay when the
    launch was captured) and recorded with the call's collector."""
    if not nbytes:
        return
    from . import _SESSION, count
    if _SESSION is None:
        return
    record_kernel_bytes(kernel, nbytes)
    count("kernels.bytes_total", nbytes, kernel=kernel)


def emit_kernel_bytes(kb: Optional[Dict[str, float]]) -> float:
    """Re-emit one call's collected kernel bytes into
    ``kernels.bytes_total`` and return their sum (the ``account()``
    extra)."""
    if not kb:
        return 0.0
    from . import count
    extra = 0.0
    for k, v in kb.items():
        if v:
            extra += v
            count("kernels.bytes_total", v, kernel=k)
    return extra


# -- accounting + derived gauges -----------------------------------------------

#: minimum window between derived-gauge recomputes (seconds): utilization
#: over sub-millisecond deltas is noise
_GAUGE_WINDOW_S = 0.25


class _Deriver:
    """Per-registry derivation state: turns counter deltas into the live
    roofline gauges."""

    __slots__ = ("t0", "flops0", "bytes0")

    def __init__(self, now: float):
        self.t0 = now
        self.flops0 = 0.0
        self.bytes0 = 0.0


_derivers: "weakref.WeakKeyDictionary[Any, _Deriver]" = \
    weakref.WeakKeyDictionary()
_derive_lock = threading.Lock()


def account(cost: Optional[Cost], extra_bytes: float = 0.0,
            registry=None, now: Optional[float] = None) -> None:
    """Accumulate one call's cost into the device counters and refresh the
    derived roofline gauges. No-op without an installed session.
    ``extra_bytes`` carries kernel-modeled bytes the count cannot see."""
    from . import session
    s = session()
    if s is None and registry is None:
        return
    reg = registry if registry is not None else s.registry
    flops = (cost.flops or 0.0) if cost is not None else 0.0
    nbytes = ((cost.bytes or 0.0) if cost is not None else 0.0) + extra_bytes
    if flops:
        reg.counter("fluid.device_flops_total").inc(flops)
    if nbytes:
        reg.counter("fluid.device_bytes_total").inc(nbytes)
    derive_gauges(reg, now=now)


def derive_gauges(registry, now: Optional[float] = None,
                  min_window: float = _GAUGE_WINDOW_S) -> None:
    """Set ``roofline.mfu`` / ``roofline.hbm_bw_util`` from the device
    counters' deltas since the last derivation (rate-limited). Peaks
    unknown (off the card, no env override) -> the gauge is never set."""
    if now is None:
        now = time.monotonic()
    d = _derivers.get(registry)
    if d is not None and now - d.t0 < min_window:
        return
    with _derive_lock:
        d = _derivers.get(registry)
        if d is None:
            _derivers[registry] = d = _Deriver(now)
            d.flops0 = registry.counter("fluid.device_flops_total").get()
            d.bytes0 = registry.counter("fluid.device_bytes_total").get()
            return
        dt = now - d.t0
        if dt < min_window:
            return
        flops = registry.counter("fluid.device_flops_total").get()
        nbytes = registry.counter("fluid.device_bytes_total").get()
        dflops, dbytes = flops - d.flops0, nbytes - d.bytes0
        d.t0, d.flops0, d.bytes0 = now, flops, nbytes
    # >1.0 is physically impossible — a collapsed window or an
    # over-counting byte model: the gauge SKIPS the set (the last honest
    # reading stands) rather than fabricate a saturated chip
    peak_f = peak_flops_per_sec()
    if peak_f and dflops >= 0:
        mfu = dflops / dt / peak_f
        if mfu <= 1.0:
            registry.gauge("roofline.mfu").set(mfu)
    peak_b = peak_hbm_bytes_per_sec()
    if peak_b and dbytes >= 0:
        util = dbytes / dt / peak_b
        if util <= 1.0:
            registry.gauge("roofline.hbm_bw_util").set(util)


def _reset_derivers() -> None:
    """Test hook: forget derivation state between injected registries."""
    with _derive_lock:
        _derivers.clear()
