"""Training events delivered to user callbacks — the event set of
``paddle_tpu/trainer/event.py`` (the reference's v2 API:
BeginPass/EndPass/BeginIteration/EndIteration/TestResult), fired from the
train loop at the same points."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class BeginPass:
    pass_id: int


@dataclass
class EndPass:
    pass_id: int
    evaluator_result: Optional[Dict[str, float]] = None


@dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


@dataclass
class EndIteration:
    pass_id: int
    batch_id: int
    cost: float
    evaluator_result: Optional[Dict[str, float]] = None
    metrics: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TestResult:
    pass_id: int
    cost: float
    evaluator_result: Optional[Dict[str, float]] = None
