"""Device profiling over ``torch.profiler`` — the port's counterpart of
``paddle_tpu/utils/profiler.py`` (the hl_profiler_start/hl_profiler_stop
analog).

* :func:`start` / :func:`stop` — begin/end a trace into a log dir; the
  trace lands as a Chrome trace JSON (``<logdir>/trace-<n>.json``) that
  ``python -m paddle_tpu_torch obs export --xplane`` and
  :func:`paddle_tpu_torch.obs.xplane.read_trace` read.
* :func:`profile` — context manager form.
* :func:`annotate` — a named host range on the trace
  (``torch.profiler.record_function``) and the obs span of the same name;
  ``StatSet`` timers annotate while a trace is active.
* :func:`device_memory_stats` — ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import glob
import itertools
import os
from contextlib import contextmanager
from typing import Optional

_active = None          # (logdir, torch.profiler.profile)
_seq = itertools.count()


def start(logdir: str):
    """Begin a trace of the host and, where there is a card, its kernels
    (cudaProfilerStart analog)."""
    global _active
    import torch
    from torch.profiler import ProfilerActivity
    if _active is not None:
        raise RuntimeError("a profiler trace is already active")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _active = (logdir, prof)


def stop() -> Optional[str]:
    """End the trace and write it under the logdir; returns the logdir."""
    global _active
    if _active is None:
        return None
    logdir, prof = _active
    _active = None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{next(_seq)}.json"))
    return logdir


def is_active() -> bool:
    return _active is not None


@contextmanager
def profile(logdir: str):
    start(logdir)
    try:
        yield logdir
    finally:
        stop()


@contextmanager
def annotate(name: str):
    """Named range on the trace (``record_function``) and the obs span of
    the same name (the shared null span when no session is installed)."""
    import torch
    from .. import obs
    with torch.profiler.record_function(name), obs.span(name):
        yield


def trace_files(logdir: str):
    """The trace files written under ``logdir``."""
    return sorted(glob.glob(os.path.join(logdir, "trace-*.json")))


def device_memory_stats(device=None) -> dict:
    """Live device memory statistics (``torch.cuda.memory_stats``) under
    JAX's key names where they have one (bytes_in_use, peak_bytes_in_use,
    bytes_limit), plus the allocator's own keys; empty with no card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    if device is None:
        device = torch.cuda.current_device()
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_limit"] = torch.cuda.get_device_properties(
        device).total_memory
    return stats
