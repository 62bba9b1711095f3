"""Host utilities — copies of the ``paddle_tpu/utils`` modules: logging,
flags, retry schedules, the ``StatSet`` timers and the ``Registry``, with
JAX's re-exports; ``utils/profiler.py`` drives ``torch.profiler``."""

from .flags import FLAGS, Flags
from .logging import get_logger, logger
from .registry import Registry
from .retry import RetryBudgetExceeded, RetryPolicy
from .stats import GLOBAL_STATS, StatSet, StatSnapshot, timer

__all__ = ["FLAGS", "Flags", "Registry", "StatSet", "StatSnapshot",
           "GLOBAL_STATS", "timer",
           "get_logger", "logger", "RetryPolicy", "RetryBudgetExceeded"]
