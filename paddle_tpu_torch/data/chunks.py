"""Reader <-> recordio-chunk bridge + the fault-tolerant cloud reader — the
counterpart of ``paddle_tpu/data/chunks.py``.

Reference pipeline being re-provided: datasets are converted to RecordIO
chunks, the master shards chunk ranges into tasks, and trainers read via
``cloud_reader`` (python/paddle/v2/reader/creator.py:91-109 +
python/paddle/v2/master/client.py:15-80). Sample payloads are pickled tuples
(the reference pickles through its recordio client the same way); files are
the CRC-checked chunk format of native/recordio.cc, so the same rows make
the same files in both packages and each reads the other's.

The idle polls and tasks count into an installed obs session as JAX's do
(``data.retries_total``/``giveups_total``/``backoff_seconds_total``
through ``obs.retry_observer("data")`` when the policy has no observer;
``data.tasks_total``, ``data.task_failures_total``).
"""

from __future__ import annotations

import os
import pickle
from typing import Iterable, List, Optional

from .. import faults, obs
from ..utils.retry import RetryBudgetExceeded, RetryPolicy
from .reader import Reader


def dump_to_chunks(reader_creator: Reader, dirname: str, *,
                   samples_per_chunk: int = 1024,
                   prefix: str = "chunk") -> List[str]:
    """Materialise a reader into chunk files; returns the paths
    (dataset/common.py convert + recordio writer analog)."""
    from ..runtime.recordio import RecordWriter
    os.makedirs(dirname, exist_ok=True)
    paths: List[str] = []
    writer = None
    count = 0
    for sample in reader_creator():
        if writer is None:
            path = os.path.join(dirname, f"{prefix}-{len(paths):05d}.ptr")
            writer = RecordWriter(path)
            paths.append(path)
        writer.write(pickle.dumps(sample, protocol=4))
        count += 1
        if count >= samples_per_chunk:
            writer.close()
            writer = None
            count = 0
    if writer is not None:
        writer.close()
    return paths


def chunk_reader(paths: Iterable[str]) -> Reader:
    """Reader creator over chunk files (recordio.creator analog)."""
    paths = list(paths)

    def reader():
        from ..runtime.recordio import RecordReader
        for path in paths:
            with RecordReader(path) as r:
                for payload in r:
                    yield pickle.loads(payload)

    return reader


class _Starved(Exception):
    """Internal: the master had no task for us but the pass is not done."""


def cloud_reader(master_client, *, poll_interval: float = 0.1,
                 max_idle_polls: int = 600,
                 new_pass_at_end: bool = False,
                 poll_policy: Optional[RetryPolicy] = None) -> Reader:
    """Fault-tolerant distributed reader (creator.py:91 cloud_reader): pull
    chunk tasks from the master service, stream their samples, report
    finished/failed. One pass = until the master says the pass is done.

    ``new_pass_at_end`` cycles the master's pass when this reader drains it,
    so the next ``reader()`` call streams a fresh pass — correct for a
    single consumer (the --local_master dev mode); multi-consumer jobs
    coordinate the pass transition externally (e.g. rank 0 only).

    Idle polling (other consumers hold every pending task) runs under a
    :class:`RetryPolicy` — gentle exponential backoff instead of a fixed
    busy-poll, bounded by an overall starvation deadline equivalent to the
    legacy ``max_idle_polls * poll_interval`` budget. Pass ``poll_policy``
    to tune it (a fake-clock policy makes tests sleepless).
    """

    _END = object()

    def reader():
        if poll_policy is not None:
            # starvation is the only retryable event at this site; a caller
            # tunes the schedule/deadline and must not need to know about
            # the module-private _Starved marker
            import copy
            policy = copy.copy(poll_policy)
            policy.retryable = _Starved
        else:
            policy = RetryPolicy(
                max_attempts=None, base_delay=poll_interval, multiplier=1.5,
                max_delay=max(poll_interval * 10, poll_interval),
                deadline=max_idle_polls * poll_interval,
                jitter=0.1, retryable=_Starved)

        if policy.observer is None:
            # idle-poll telemetry: data.retries_total / giveups / backoff
            policy.observer = obs.retry_observer("data")

        def poll_once():
            task = master_client.get_task()
            if task is not None:
                return task
            todo, pending, done, disc, epoch = master_client.stats()
            if todo == 0 and pending == 0:
                return _END                     # pass complete
            raise _Starved()

        while True:
            try:
                task = policy.call(poll_once, describe="task poll")
            except RetryBudgetExceeded as e:
                raise TimeoutError(
                    f"master starved the reader "
                    f"({e.attempts} idle polls)") from e
            if task is _END:
                if new_pass_at_end:
                    master_client.new_pass()
                return
            task_id, path = task
            obs.count("data.tasks_total")
            try:
                faults.fire("reader.next")      # chaos: per-task failure
                yield from chunk_reader([path])()
            except Exception:
                # the elastic contract (go/master re-dispatch): report the
                # task failed and let the master hand it to a healthy
                # consumer (or discard after failure_max strikes)
                obs.count("data.task_failures_total")
                master_client.task_failed(task_id)
                continue
            master_client.task_finished(task_id)

    return reader
