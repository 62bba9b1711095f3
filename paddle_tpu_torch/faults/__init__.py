"""paddle_tpu_torch.faults — deterministic fault injection, the counterpart
of ``paddle_tpu/faults``. See :mod:`paddle_tpu_torch.faults.inject` for the
sites the port has and their semantics."""

from .inject import (SITES, Fault, FaultError, FaultPlan, filter_bytes,
                     filter_value, fire, is_active)

__all__ = ["FaultPlan", "Fault", "FaultError", "SITES",
           "fire", "filter_bytes", "filter_value", "is_active"]
