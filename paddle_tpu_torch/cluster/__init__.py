"""paddle_tpu_torch.cluster — the fleet actor subsystem, a copy of
``paddle_tpu/cluster`` (it imports no JAX) wired to the port's membership,
obs and faults planes.

Closes the autoscale loop: :class:`FleetActor` polls the membership +
health planes and converts hysteresis-stable recommendations and SLO
burn-rate alerts into worker spawns/drains through the injectable
:class:`SpawnBackend` seam, sharing one fleet budget across training and
serving populations via the :class:`FleetScheduler` (PR 12's
weighted-fair deficit scheduler, generalized to workers). See
docs/design/fleet.md.
"""
from .actor import (ActorReporter, FleetActor, MasterProbe, Population,
                    RouterProbe, SLO_BURN_RULES)
from .scheduler import DEFAULT_WEIGHTS, FleetScheduler
from .spawn import (HookSpawnBackend, SpawnBackend, SpawnHandle,
                    SubprocessSpawnBackend)

__all__ = [
    "ActorReporter", "DEFAULT_WEIGHTS", "FleetActor", "FleetScheduler",
    "HookSpawnBackend", "MasterProbe", "Population", "RouterProbe",
    "SLO_BURN_RULES", "SpawnBackend", "SpawnHandle",
    "SubprocessSpawnBackend",
]
