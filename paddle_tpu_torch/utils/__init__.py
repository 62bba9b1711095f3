"""Host utilities — copies of the jax-free ``paddle_tpu/utils`` modules:
logging, flags, retry schedules and the ``StatSet`` timers, with JAX's
re-exports. ``Registry`` (``utils/registry.py``) and ``utils/profiler.py``
wait for ROADMAP A.8."""

from .flags import FLAGS, Flags
from .logging import get_logger, logger
from .retry import RetryBudgetExceeded, RetryPolicy
from .stats import GLOBAL_STATS, StatSet, StatSnapshot, timer

__all__ = ["FLAGS", "Flags", "StatSet", "StatSnapshot", "GLOBAL_STATS",
           "timer", "get_logger", "logger", "RetryPolicy",
           "RetryBudgetExceeded"]
