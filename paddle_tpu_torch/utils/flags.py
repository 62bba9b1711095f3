"""Global runtime flags — a copy of ``paddle_tpu/utils/flags.py``, read
from the same ``PDTPU_<NAME>`` environment variables.

Analog of the reference's gflags wrapper (paddle/utils/Flags.h:19-43) which centralizes
process-level knobs (``use_gpu``, ``trainer_count``, ``trainer_id``, ``log_period``,
``parallel_nn``, ...). Here flags are a typed namespace that can be overridden from the
environment (``PDTPU_<NAME>``) or programmatically; the TPU-relevant set replaces the
GPU/pserver knobs with mesh/platform ones.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Any, Optional, Tuple


def _env(name: str, default, cast):
    raw = os.environ.get("PDTPU_" + name.upper())
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class Flags:
    # platform selection: "tpu" | "cpu" | "" (= let jax pick)
    platform: str = ""
    # mesh shape for data/model axes when using the default mesh helpers
    trainer_count: int = 0            # 0 = all local devices (ref: Flags.h trainer_count)
    trainer_id: int = 0               # process index in multi-host runs
    # numerics
    default_dtype: str = "float32"
    matmul_precision: str = "default"  # "default" | "bfloat16" | "highest"
    # logging / metrics cadence (ref: --log_period)
    log_period: int = 100
    show_parameter_stats_period: int = 0
    # checkpointing (ref: --saving_period / save_dir)
    save_dir: str = "output"
    saving_period: int = 1
    # data pipeline
    prefetch_depth: int = 2           # double-buffer depth (ref DataProvider DoubleBuffer)
    seed: int = 0

    def update(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown flag '{k}'")
            setattr(self, k, v)
        return self


def _from_env() -> Flags:
    f = Flags()
    for fld in fields(Flags):
        setattr(f, fld.name, _env(fld.name, getattr(f, fld.name), type(getattr(f, fld.name))))
    return f


FLAGS = _from_env()
