"""Retry/backoff policy — a copy of ``paddle_tpu/utils/retry.py``.

:class:`RetryPolicy` runs a call under a schedule:

* exponential backoff: ``base_delay * multiplier**attempt``
* jitter: each delay is scaled by a uniform draw from
  ``[1-jitter, 1+jitter]`` (seedable — deterministic in tests)
* ``max_delay`` cap, so backoff never exceeds one recovery probe interval
* overall ``deadline`` (seconds from first attempt): when the budget is
  spent the last error is re-raised — a caller never blocks unboundedly
* a ``retryable`` exception predicate: anything else propagates immediately

Time is injectable (``clock``/``sleep``) so tests drive a fake clock and
never really sleep.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, Union

RetryableSpec = Union[Type[BaseException], Tuple[Type[BaseException], ...],
                      Callable[[BaseException], bool]]


class RetryBudgetExceeded(ConnectionError):
    """Raised when attempts/deadline are exhausted; carries the tally."""

    def __init__(self, msg: str, *, attempts: int,
                 last_error: Optional[BaseException] = None):
        super().__init__(msg)
        self.attempts = attempts
        self.last_error = last_error


class RetryPolicy:
    """Exponential-backoff retry schedule with jitter, cap and deadline.

    Args:
      max_attempts: total tries (first call included). ``None`` = unbounded
        (then ``deadline`` must bound the loop).
      base_delay: pre-jitter delay after the first failure, seconds.
      multiplier: exponential growth factor per attempt.
      max_delay: cap applied before jitter.
      deadline: overall budget in seconds from the first attempt; ``None``
        disables it.
      jitter: +/- fraction of each delay randomised (0 = deterministic).
      retryable: exception class(es) or predicate deciding what to retry.
      sleep/clock: injectable time functions (fake clock in tests).
      seed: seeds the jitter RNG for reproducible schedules.
      observer: optional stats callback ``observer(event, **info)`` —
        ``"attempt"`` (kw: attempt, delay, error) before each backoff
        sleep, ``"giveup"`` (kw: attempts, error) when the budget is
        spent, ``"success"`` (kw: attempts) on a retried call that then
        succeeded. This is how the observability plane subscribes
        (``paddle_tpu_torch.obs.retry_observer``) without this module
        importing ``obs`` — the callback is plain data out.
    """

    def __init__(self, *, max_attempts: Optional[int] = 5,
                 base_delay: float = 0.05, multiplier: float = 2.0,
                 max_delay: float = 2.0, deadline: Optional[float] = None,
                 jitter: float = 0.25,
                 retryable: RetryableSpec = (OSError, ConnectionError),
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 seed: Optional[int] = None,
                 observer: Optional[Callable[..., None]] = None):
        if max_attempts is None and deadline is None:
            raise ValueError("unbounded policy: set max_attempts or deadline")
        if max_attempts is not None and max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.deadline = deadline
        self.jitter = jitter
        self.retryable = retryable
        self.sleep = sleep
        self.clock = clock
        self.observer = observer
        self._rng = random.Random(seed)

    def _observe(self, event: str, **info) -> None:
        if self.observer is not None:
            self.observer(event, **info)

    def delay_for(self, attempt: int) -> float:
        """Pre-jitter delay after failed attempt ``attempt`` (0-based)."""
        return min(self.base_delay * (self.multiplier ** attempt),
                   self.max_delay)

    def _jittered(self, delay: float) -> float:
        if self.jitter == 0.0:
            return delay
        return delay * self._rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)

    def is_retryable(self, exc: BaseException) -> bool:
        if callable(self.retryable) and not isinstance(self.retryable, type):
            return bool(self.retryable(exc))
        return isinstance(exc, self.retryable)  # type: ignore[arg-type]

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             describe: str = "operation", **kw):
        """Run ``fn(*args, **kw)`` under the policy.

        Non-retryable exceptions propagate untouched. On budget exhaustion
        raises :class:`RetryBudgetExceeded` naming the attempt count,
        chaining the last underlying error.
        """
        start = self.clock()
        attempt = 0
        last: Optional[BaseException] = None
        while True:
            try:
                result = fn(*args, **kw)
                if attempt:
                    self._observe("success", attempts=attempt + 1)
                return result
            except BaseException as e:
                if not self.is_retryable(e):
                    raise
                last = e
            attempt += 1
            if self.max_attempts is not None and attempt >= self.max_attempts:
                break
            delay = self._jittered(self.delay_for(attempt - 1))
            if self.deadline is not None and \
                    (self.clock() - start) + delay > self.deadline:
                break
            if on_retry is not None:
                on_retry(attempt, last)
            self._observe("attempt", attempt=attempt, delay=delay,
                          error=last)
            if delay > 0:
                self.sleep(delay)
        self._observe("giveup", attempts=attempt, error=last)
        raise RetryBudgetExceeded(
            f"{describe} failed after {attempt} attempt(s): {last}",
            attempts=attempt, last_error=last) from last
