"""Reader protocol + decorators — a copy of ``paddle_tpu/data/reader.py``.

A *reader creator* is a zero-arg callable returning an iterable of samples —
identical protocol to the reference (python/paddle/v2/reader/decorator.py:26-233,
minibatch.py). Decorators compose creators; everything is lazy. The
queue-health metrics of ``buffered`` (``data.queue_depth``,
``data.starved_total``, ``data.timeouts_total``) wait for the obs session
plane (ROADMAP A.8).
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Any, Callable, Iterable, List

Reader = Callable[[], Iterable[Any]]


def map_readers(func: Callable, *readers: Reader) -> Reader:
    """Apply func elementwise across the outputs of several readers
    (decorator.py:26 map_readers)."""

    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader


def shuffle(reader_creator: Reader, buf_size: int, seed: int = None) -> Reader:
    """Pool-shuffle with a bounded buffer (decorator.py:62 shuffle)."""

    def reader():
        rng = _random.Random(seed)
        buf: List[Any] = []
        for e in reader_creator():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return reader


def chain(*readers: Reader) -> Reader:
    """Concatenate readers end-to-end (decorator.py:90 chain)."""

    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip readers into tuple samples (decorator.py:118 compose)."""

    def _to_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        its = [r() for r in readers]
        for items in (zip(*its) if not check_alignment
                      else itertools.zip_longest(*its, fillvalue=_SENTINEL)):
            if check_alignment and any(i is _SENTINEL for i in items):
                raise ValueError("composed readers have different lengths")
            yield sum((_to_tuple(i) for i in items), ())

    return reader


_SENTINEL = object()


def buffered(reader_creator: Reader, size: int,
             timeout: float = None) -> Reader:
    """Background-thread read-ahead of up to ``size`` samples — the per-reader
    analog of the C++ DoubleBuffer (DataProvider.h:249).

    ``timeout`` is a watchdog: if the producer thread delivers nothing for
    that many seconds, the consumer raises TimeoutError instead of blocking
    forever behind a wedged data source."""

    def reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        end = object()
        err: List[BaseException] = []

        def worker():
            try:
                for s in reader_creator():
                    q.put(s)
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            try:
                s = q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"prefetch watchdog: no batch within {timeout}s "
                    "(data source wedged?)") from None
            if s is end:
                if err:
                    raise err[0]
                return
            yield s

    return reader


def firstn(reader_creator: Reader, n: int) -> Reader:
    """Take the first n samples (decorator.py:172 firstn)."""

    def reader():
        return itertools.islice(reader_creator(), n)

    return reader


def xmap_readers(mapper: Callable, reader_creator: Reader, process_num: int,
                 buffer_size: int, order: bool = False) -> Reader:
    """Parallel map over a thread pool (decorator.py:190 xmap_readers)."""

    def reader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        end = object()

        def feeder():
            for i, s in enumerate(reader_creator()):
                in_q.put((i, s))
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, s = item
                out_q.put((i, mapper(s)))

        threading.Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=worker, daemon=True).start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                else:
                    yield item[1]
        else:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                pending[item[0]] = item[1]
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            while want in pending:
                yield pending.pop(want)
                want += 1

    return reader


def cache(reader_creator: Reader) -> Reader:
    """Materialise once, replay from memory (PyDataProvider2 CacheType.CACHE_PASS
    analog, python/paddle/trainer/PyDataProvider2.py:55)."""
    data: List[Any] = []
    filled = [False]

    def reader():
        if not filled[0]:
            data.extend(reader_creator())
            filled[0] = True
        return iter(data)

    return reader


def batch(reader_creator: Reader, batch_size: int, drop_last: bool = False) -> Reader:
    """Group samples into lists of batch_size (v2/minibatch.py paddle.batch)."""

    def reader():
        b: List[Any] = []
        for s in reader_creator():
            b.append(s)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return reader


def mix(readers_with_ratios, seed: int = 0) -> Reader:
    """Ratio-mixed interleave of sub-readers — the MultiDataProvider.cpp
    analog (gserver/dataproviders/MultiDataProvider: sub-providers sampled by
    configured ratios). ``readers_with_ratios``: [(reader, weight), ...] with
    strictly positive weights; exhausted sub-readers drop out and the rest
    renormalise."""
    if any(w <= 0 for _, w in readers_with_ratios):
        raise ValueError("mix() weights must be strictly positive")

    def reader():
        rng = _random.Random(seed)
        its = [iter(r()) for r, _ in readers_with_ratios]
        weights = [float(w) for _, w in readers_with_ratios]
        while its:
            i = rng.choices(range(len(its)), weights=weights)[0]
            try:
                yield next(its[i])
            except StopIteration:
                del its[i], weights[i]

    return reader
