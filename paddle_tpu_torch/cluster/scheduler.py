"""Weighted-fair deficit scheduling for WORKERS-WITHIN-A-FLEET — a copy of
``paddle_tpu/cluster/scheduler.py``.

This is PR 12's slots-within-an-engine scheduler
(:meth:`paddle_tpu_torch.serving.engine.ServingEngine.admit_prefill`) lifted one
level up: the resource is no longer a decode slot but a whole worker
process, the classes are no longer SLO tenants but fleet POPULATIONS
(elastic-DP training, decode-pool serving), and the quantum is one
worker. The invariants carry over unchanged:

* each population with unmet demand accrues ``weight * quantum`` credit
  per scheduling round, capped at ``8 * quantum * weight`` (no unbounded
  banking across idle stretches);
* credit resets while a population has nothing to ask for
  (work-conserving — batch training soaks ALL idle capacity when serving
  is quiet, at zero stored debt);
* grants debit the winner's balance by the worker cost, so interactive
  serving pre-empts queued batch growth at the weight ratio without ever
  idling a free worker;
* URGENT populations (a firing TTFT/TPOT burn-rate alert) are served
  before any credit comparison — an SLO burn is the fleet-level analogue
  of interactive head-of-line traffic.

:meth:`FleetScheduler.preempt` is the piece slots never needed: when an
urgent population wants a worker and the fleet budget is exhausted, it
names the victim population (lowest weight first, never urgent, never
below its floor) whose worker the actor should drain — the train/serve
YIELD protocol (docs/design/fleet.md).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

#: default population weights — interactive serving outweighs batch
#: training 4:1, the same ratio PR 12 ships for slots
DEFAULT_WEIGHTS = {"serve": 4.0, "train": 1.0}

#: cost of one grant, in credit units (one worker)
WORKER_COST = 1.0


class FleetScheduler:
    """Deficit round-robin over fleet populations.

    Deterministic: ties break on population name, and the credit state
    is exposed (``credits()``) so tests can assert the banking bounds.
    """

    def __init__(self, weights: Optional[Mapping[str, float]] = None,
                 *, quantum: float = 1.0):
        self.weights: Dict[str, float] = dict(weights or DEFAULT_WEIGHTS)
        self.quantum = float(quantum)
        self._credit: Dict[str, float] = {}

    def weight(self, population: str) -> float:
        return float(self.weights.get(population, 1.0))

    def credits(self) -> Dict[str, float]:
        return dict(self._credit)

    # -- allocation ---------------------------------------------------------
    def allocate(self, supply: int, demands: Mapping[str, int],
                 urgent: Iterable[str] = ()) -> Dict[str, int]:
        """Split ``supply`` spawnable workers across ``demands``.

        ``demands`` maps population -> workers wanted (non-positive
        entries are treated as no demand and reset that population's
        bank). ``urgent`` populations are granted first, before any
        deficit comparison. Returns population -> granted count; the sum
        never exceeds ``supply``.
        """
        urgent = set(urgent)
        want = {p: int(n) for p, n in demands.items() if int(n) > 0}
        grants = {p: 0 for p in demands}
        for p in set(self._credit) | set(demands):
            if p not in want:
                self._credit[p] = 0.0          # no banking while idle
        supply = max(0, int(supply))
        # urgent head-of-line: an SLO burn never waits on credit
        for p in sorted(want, key=lambda q: (q not in urgent, q)):
            if supply <= 0 or p not in urgent:
                break
            take = min(want[p], supply)
            grants[p] += take
            supply -= take
            self._credit[p] = self._credit.get(p, 0.0) - take * WORKER_COST
        # deficit rounds over whatever budget is left
        while supply > 0:
            avail = [p for p in sorted(want)
                     if want[p] - grants[p] > 0]
            if not avail:
                break
            for p in avail:
                w = self.weight(p)
                self._credit[p] = min(
                    self._credit.get(p, 0.0) + self.quantum * w,
                    8 * self.quantum * w)
            p = max(avail, key=lambda q: (self._credit[q], q))
            grants[p] += 1
            supply -= 1
            self._credit[p] -= WORKER_COST
        return grants

    # -- preemption (the yield protocol) ------------------------------------
    def preempt(self, current: Mapping[str, int],
                floors: Mapping[str, int], for_population: str,
                urgent: Iterable[str] = ()) -> Optional[str]:
        """Name the population that should YIELD one worker to
        ``for_population``, or None when nobody legally can.

        A victim must not be the requester, must not itself be urgent,
        and must hold more workers than its floor (``min_workers`` — the
        byte-stable training floor is still a floor). Lowest weight
        loses first; ties break on name for determinism.
        """
        urgent = set(urgent)
        candidates = [
            p for p, n in current.items()
            if p != for_population and p not in urgent
            and int(n) > int(floors.get(p, 0))]
        if not candidates:
            return None
        return min(candidates, key=lambda p: (self.weight(p), p))
