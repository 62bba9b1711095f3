"""Double-buffered host->device prefetch — a copy of
``paddle_tpu/data/prefetch.py`` (its ``data.prefetch_iters_total`` count
waits for the obs session plane, ROADMAP A.8).

The reference overlaps batch production with training via a dedicated thread and
a two-slot queue (``DoubleBuffer``, gserver/dataproviders/DataProvider.h:249,
enabled per-provider). Here the payload is the feeder's tensors on the card:
the worker thread converts a batch and copies it to the card while the main
thread replays the previous step's graph (``data/feeder.py`` says on which
stream).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional


class DoubleBuffer:
    """Wrap a batch iterable; a worker thread keeps ``depth`` batches ready.

    Usage::
        for batch in DoubleBuffer(lambda: feeder_batches(), depth=2):
            step(*batch)
    """

    def __init__(self, batches: Callable[[], Iterable[Any]], depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None,
                 timeout: Optional[float] = None):
        self.batches = batches
        self.depth = depth
        self.transform = transform
        # watchdog: a producer that silently wedges (dead data source, hung
        # filesystem) must surface as TimeoutError, not hang the train loop
        self.timeout = timeout

    def __iter__(self) -> Iterator[Any]:
        from .reader import buffered, map_readers
        creator = self.batches
        if self.transform is not None:
            # transform runs on the worker thread, overlapping host conversion
            # with device compute
            creator = map_readers(self.transform, creator)
        return iter(buffered(creator, self.depth, timeout=self.timeout)())
