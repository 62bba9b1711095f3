"""paddle_tpu_torch.analysis — static verification + lint passes over
Program IR, the counterpart of ``paddle_tpu/analysis``.

A compiler stack is debuggable when its IR can be checked *before* it
runs. This subpackage rejects malformed programs with precise
:class:`Diagnostic`\\ s before any op runs or CUDA graph is captured:

- :func:`verify_program`   — structural checks (V0xx): def-before-use with
  parent-scope lookup, registered op types, duplicate writes, sub-block
  index sanity/acyclicity, while-condition liveness, fetch existence.
- :func:`infer_program_shapes` — abstract shape/dtype interpretation (S0xx)
  with per-op rules via :func:`register_shape_infer` and a fallback that
  runs the registered compute on ``meta`` tensors.
- :func:`lint_program`     — advisory catalogue (L0xx): dead ops, unused
  vars, trace-safety, sharding-annotation consistency.

Entry points: ``analyze_program`` (everything, returns diagnostics) and
``check_or_raise`` (the ``Executor.run(verify=True)`` pre-flight). The
``lint`` CLI subcommand waits for ROADMAP A.8c; the lint over the tune
plane's cache (L008) is :func:`lint_autotune_cache`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .dataflow import (Dataflow, DonationHazard, Effect, FusionGroup,
                       analyze_dataflow, certificate_matches,
                       classify_effect, donation_hazards, explain_var,
                       fusable_groups, region_schedulable)
from .diagnostics import (Diagnostic, ProgramVerificationError, Severity,
                          block_paths, errors, format_diagnostics,
                          max_severity, op_site)
from .lints import (LINT_CATALOGUE, lint_alert_rules, lint_autotune_cache,
                    lint_catalogue_drift, lint_metric_names, lint_program)
from .shape_infer import (UNKNOWN, ShapeInferRegistry, dtype_name,
                          infer_program_shapes, register_shape_infer)
from .verify import verify_program

__all__ = [
    "Diagnostic", "Severity", "ProgramVerificationError",
    "errors", "format_diagnostics", "max_severity", "op_site", "block_paths",
    "verify_program", "infer_program_shapes", "register_shape_infer",
    "ShapeInferRegistry", "UNKNOWN", "lint_program", "lint_metric_names",
    "lint_catalogue_drift", "lint_autotune_cache", "lint_alert_rules",
    "LINT_CATALOGUE",
    "Dataflow", "DonationHazard", "Effect", "FusionGroup",
    "analyze_dataflow", "classify_effect", "donation_hazards",
    "explain_var", "fusable_groups", "region_schedulable",
    "certificate_matches",
    "analyze_program", "check_or_raise",
]


def _feed_shapes(feed: Optional[Dict[str, Any]]) -> Dict[str, Tuple]:
    """(shape, dtype name) of each feed: torch tensors and numpy arrays
    alike, the dtype named as numpy names it ("float32", "int64")."""
    out: Dict[str, Tuple] = {}
    for name, val in (feed or {}).items():
        arr = np.asarray(val) if not hasattr(val, "shape") else val
        out[name] = (tuple(arr.shape), dtype_name(arr.dtype))
    return out


def analyze_program(program, feed: Optional[Dict[str, Any]] = None,
                    fetch: Iterable[str] = (),
                    run_verify: bool = True, run_shapes: bool = True,
                    run_lints: bool = True,
                    mesh_axes: Optional[Sequence[str]] = None,
                    severity_overrides: Optional[Dict[str, Severity]] = None,
                    donate: Optional[bool] = None,
                    ) -> List[Diagnostic]:
    """Run every enabled pass over ``program`` and return all diagnostics.

    ``feed`` may hold real arrays (their shapes seed the interpreter) or be
    omitted, in which case data vars use declared shapes with placeholder
    dynamic dims.  ``fetch`` is a list of var names (strings).  ``donate``
    mirrors the Executor's donation switch for L011 (True: hazards are
    errors; None: advisory; False: skipped)."""
    fetch_names = [v if isinstance(v, str) else v.name for v in fetch]
    diags: List[Diagnostic] = []
    if run_verify:
        verify_program(program, feed=list(feed or ()), fetch=fetch_names,
                       diags=diags)
    if run_shapes and not errors(diags):
        # structural errors make abstract interpretation meaningless noise
        infer_program_shapes(program, feed_shapes=_feed_shapes(feed),
                             diags=diags)
    if run_lints:
        # the dataflow walker recurses through the same sub-block indices
        # the verifier validates; structural errors there would make the
        # chains (and L010-L012) nonsense, so those lints gate on V0xx
        enable = (set(LINT_CATALOGUE) - {"L010", "L011", "L012"}
                  if errors(diags) else None)
        lint_program(program, fetch=fetch_names, mesh_axes=mesh_axes,
                     severity_overrides=severity_overrides,
                     feed=list(feed or ()), donate=donate,
                     enable=enable, diags=diags)
    # nested sub-block sites cite the full parent chain (block 0.2, op #5)
    paths = block_paths(program)
    for d in diags:
        if d.block_idx is not None and d.block_path is None:
            d.block_path = paths.get(d.block_idx)
    return diags


def check_or_raise(program, feed: Optional[Dict[str, Any]] = None,
                   fetch: Iterable[str] = (),
                   mesh_axes: Optional[Sequence[str]] = None,
                   donate: Optional[bool] = None
                   ) -> List[Diagnostic]:
    """Pre-flight for ``Executor.run(verify=True)``: raise
    :class:`ProgramVerificationError` on any error-severity diagnostic,
    return the full list (warnings included) otherwise.  ``mesh_axes``
    pins the valid sharding axis names (L004) for custom meshes.
    ``donate`` is the run's donation switch — with it True a provable
    donation hazard (L011) is an error this pre-flight refuses."""
    diags = analyze_program(program, feed=feed, fetch=fetch,
                            mesh_axes=mesh_axes, donate=donate)
    if errors(diags):
        raise ProgramVerificationError(diags)
    return diags
