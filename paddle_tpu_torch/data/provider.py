"""The ``@provider`` decorator protocol — PyDataProvider2 parity; a copy of
``paddle_tpu/data/provider.py``.

Reference surface (python/paddle/trainer/PyDataProvider2.py:55): a user
writes ``def process(settings, filename)`` yielding rows, decorates it with
``@provider(input_types=..., cache=..., init_hook=...)``, and the trainer
pulls batches per file. Mapping: the decorated function becomes
a READER CREATOR factory — ``process(f1, f2, ...)`` returns a creator
compatible with every reader decorator/DataFeeder in
:mod:`paddle_tpu_torch.data` — so legacy provider code ports by changing only how the result is handed
to the trainer. ``cache=CacheType.CACHE_PASS_IN_MEM`` materializes rows on
the first pass (the reference's in-memory pass cache); ``init_hook`` runs
once with the settings object before any row is produced.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class _Settings:
    """The ``settings`` object handed to init_hook and process: carries
    input_types (+ anything init_hook attaches — the reference's
    settings.slots idiom)."""

    def __init__(self, input_types):
        self.input_types = input_types
        self.slots = input_types
        self.logger = None


def provider(input_types: Optional[Sequence] = None,
             cache: int = CacheType.NO_CACHE,
             init_hook: Optional[Callable] = None,
             should_shuffle: bool = False,
             **hook_kwargs: Any):
    """Decorate ``process(settings, source)`` into a reader-creator factory.

    ``process("a.txt", "b.txt")`` -> reader creator yielding every row of
    every source, optionally shuffled per pass (should_shuffle) and cached
    in memory after the first pass (CACHE_PASS_IN_MEM).
    """

    def deco(process: Callable):
        def make_reader(*sources):
            settings = _Settings(list(input_types or []))
            if init_hook is not None:
                init_hook(settings, **hook_kwargs)
            srcs = list(sources) if sources else [None]
            cached: list = []

            def reader():
                if cache == CacheType.CACHE_PASS_IN_MEM and cached:
                    rows = cached
                else:
                    rows = []
                    for src in srcs:
                        for row in process(settings, src):
                            if cache == CacheType.CACHE_PASS_IN_MEM:
                                rows.append(row)
                            elif should_shuffle:
                                rows.append(row)
                            else:
                                yield row
                    # fill only while still empty: two generators started
                    # against an empty cache (a partially-consumed pass
                    # resumed alongside a full one) must not both extend,
                    # duplicating every row in subsequent passes
                    if cache == CacheType.CACHE_PASS_IN_MEM and not cached:
                        cached.extend(rows)
                if cache == CacheType.CACHE_PASS_IN_MEM or should_shuffle:
                    if should_shuffle:
                        import random
                        rows = list(rows)
                        random.shuffle(rows)
                    yield from rows

            reader.settings = settings
            return reader

        make_reader.__name__ = getattr(process, "__name__", "provider")
        make_reader.settings_factory = lambda: _Settings(
            list(input_types or []))
        return make_reader

    return deco
