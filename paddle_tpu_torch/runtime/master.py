"""TaskMaster — fault-tolerant data-shard dispatch (native/task_master.cc),
the counterpart of ``paddle_tpu/runtime/master.py``.

Go master client semantics (go/master/client.go + python/paddle/v2/master/
client.py): set a dataset of chunk payloads, consume tasks, report
finished/failed; timed-out tasks re-dispatch; over-failed tasks are discarded;
snapshot/restore covers master crash recovery (SURVEY.md §5 failure detection).
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional, Tuple

from .lib import load_library


class TaskMaster:
    def __init__(self, timeout_s: float = 60.0, failure_max: int = 3):
        self._lib = load_library()
        self._h = self._lib.ptm_create(ctypes.c_double(timeout_s),
                                       failure_max)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ptm_destroy(self._h)
            self._h = None

    def set_dataset(self, payloads: List[str]):
        arr = (ctypes.c_char_p * len(payloads))(
            *[p.encode() for p in payloads])
        self._lib.ptm_set_dataset(self._h, arr, len(payloads))

    def get_task(self, now: Optional[float] = None) -> Optional[Tuple[int, str]]:
        """-> (task_id, payload) | None when nothing currently available."""
        ts = ctypes.c_double(time.monotonic() if now is None else now)
        size = 4096
        while True:
            buf = ctypes.create_string_buffer(size)
            needed = ctypes.c_int(0)
            tid = self._lib.ptm_get_task(self._h, ts, buf, len(buf),
                                         ctypes.byref(needed))
            if tid == -3:  # buffer too small; task not consumed — retry bigger
                size = max(needed.value, size * 2)
                continue
            if tid < 0:
                return None
            return tid, buf.value.decode()

    def pass_finished(self) -> bool:
        """True when todo and pending are both empty (end of pass)."""
        t, p, d, x, e = self.stats()
        return t == 0 and p == 0

    def task_finished(self, task_id: int):
        self._lib.ptm_task_finished(self._h, task_id)

    def new_pass(self) -> bool:
        """Refill todo from done for the next pass; False if pass unfinished."""
        return self._lib.ptm_new_pass(self._h) == 0

    def task_failed(self, task_id: int) -> bool:
        """Returns True if the task was discarded (failure_max reached)."""
        return self._lib.ptm_task_failed(self._h, task_id) == 1

    def tick(self, now: Optional[float] = None) -> int:
        """Requeue timed-out pending tasks; returns how many moved."""
        return self._lib.ptm_tick(
            self._h, ctypes.c_double(time.monotonic() if now is None else now))

    def stats(self) -> Tuple[int, int, int, int, int]:
        vals = [ctypes.c_int() for _ in range(5)]
        self._lib.ptm_stats(self._h, *[ctypes.byref(v) for v in vals])
        return tuple(v.value for v in vals)  # todo, pending, done, discarded, epoch

    def snapshot(self, path: str):
        if self._lib.ptm_snapshot(self._h, path.encode()) != 0:
            raise IOError(f"snapshot to {path} failed")

    def restore(self, path: str):
        rc = self._lib.ptm_restore(self._h, path.encode())
        if rc != 0:
            raise IOError(f"restore from {path} failed ({rc})")
