"""Bench-row schema — the contract between benchmark rows and every
consumer downstream (a bench script's stdout JSONL, the parser that reads
its last line, trend tracking, a lint over bench rows). The port's copy
of ``paddle_tpu/analysis/bench_schema.py``.

A malformed row fails silently: a benchmark that drops `mfu` or
`hbm_bw_util` from its dict still prints, the trend tooling skips the
missing column, and the regression surfaces much later as an empty
column. Rows are validated here instead.

Family rules key on the metric NAME, which is itself part of the contract
(metric keys carry methodology; see benchmarks/lstm_textcls.py):

* every row: ``metric`` (str), ``value`` (number or null), ``unit`` (str),
  ``vs_baseline`` (number or null);
* ``*_train_*`` rows: ``mfu`` — the roofline campaign's target column
  (no training row below 15% MFU, ROADMAP item 3) — plus ``plan_source``
  ("tuned" | "heuristic": did this row's kernel-plan consults resolve
  against measured autotune winners, ``paddle_tpu.tune.plan_source()``);
* ``*_decode_*`` rows: ``hbm_bw_util`` — decode is bytes-bound, so its
  roofline column is bandwidth, not FLOPs (target >= 0.30) — plus
  ``plan_source`` as above;
* ``*_serve_*`` rows: ``ttft_p50_ms`` + ``tpot_p50_ms`` — a serving row
  without its SLO pair is throughput theater (time-to-first-token and
  time-per-output-token are what callers experience; the daemon rows);
* ``*_prefix_*`` rows additionally: ``hit_rate`` — a prefix-cache row
  whose speedup is not conditioned on its measured hit rate is
  unreproducible (a serve+prefix metric name matches BOTH families, so
  the SLO pair stays mandatory too; benchmarks/serving_prefix.py);
* ``*_route_*`` rows: the SLO pair PLUS ``n_decode_workers`` — a routed
  serving number is meaningless without the fleet size it was spread
  over (1 prefill + 2 decode pools is not comparable to a solo daemon;
  benchmarks/serving_router.py) — PLUS ``ttft_breakdown``: the
  phase-decomposed TTFT p50s (queued/prefill/ship/adopt, ms) from the
  request-timeline ledger, so a routed TTFT regression names WHICH hop
  moved instead of reopening the whole fabric;
* ``*_fleet_*`` rows: ``recovery_windows`` + ``slo_recovered`` — a
  fleet-actor recovery number is the chaos bar itself: how many alert
  windows from kill to restored SLO, and whether the SLO actually
  recovered (a recovery-time row that never re-met the SLO is a
  failure wearing a latency; benchmarks/fleet_autoscale.py).
"""

from __future__ import annotations

from typing import Dict, List

#: keys every row must carry
REQUIRED_KEYS = ("metric", "value", "unit", "vs_baseline")

#: metric-name substring -> additionally required keys. ``methodology``
#: ("measured" | "modeled") says whether the roofline/SLO columns come
#: from on-chip measurement of the real executable or from an analytic
#: projection — so on-chip vs projected numbers are distinguishable in
#: the trajectory (attach_mfu defaults it to "measured"; the decode
#: rows' hand byte models stamp "modeled")
FAMILY_REQUIRED = {
    "_train_": ("mfu", "methodology", "plan_source"),
    "_decode_": ("hbm_bw_util", "methodology", "plan_source"),
    "_serve_": ("ttft_p50_ms", "tpot_p50_ms", "methodology"),
    "_prefix_": ("hit_rate",),
    "_route_": ("ttft_p50_ms", "tpot_p50_ms", "n_decode_workers",
                "ttft_breakdown"),
    "_fleet_": ("recovery_windows", "slo_recovered"),
}

#: the only legal methodology stamps
METHODOLOGIES = ("measured", "modeled")

#: the only legal plan_source stamps: whether the row's kernel-plan
#: consults could resolve against MEASURED autotune winners
#: (paddle_tpu.tune.plan_source()) or the built-in heuristics owned every
#: plan — required on the _train_/_decode_ families so tuned-vs-heuristic
#: deltas are machine-checkable across BENCH files
#: (benchmarks/autotune_delta.py emits the paired rows)
PLAN_SOURCES = ("tuned", "heuristic")

#: substrings exempting a row from family rules (comparative/meta rows
#: that are not themselves roofline measurements)
FAMILY_EXEMPT = ("_speedup_",)


def validate_row(row) -> List[str]:
    """Problems with one row dict; empty list == valid."""
    if not isinstance(row, dict):
        return [f"row is {type(row).__name__}, not a dict"]
    problems = []
    for key in REQUIRED_KEYS:
        if key not in row:
            problems.append(f"missing required key '{key}'")
    metric = row.get("metric")
    if metric is not None and not isinstance(metric, str):
        problems.append("'metric' must be a string")
    for key in ("value", "vs_baseline"):
        if key in row and row[key] is not None \
                and not isinstance(row[key], (int, float)):
            problems.append(f"'{key}' must be a number or null")
    if "methodology" in row and row["methodology"] not in METHODOLOGIES:
        problems.append(f"'methodology' must be one of {METHODOLOGIES}, "
                        f"got {row['methodology']!r}")
    if "plan_source" in row and row["plan_source"] not in PLAN_SOURCES:
        problems.append(f"'plan_source' must be one of {PLAN_SOURCES}, "
                        f"got {row['plan_source']!r}")
    if isinstance(metric, str) and not any(t in metric
                                           for t in FAMILY_EXEMPT):
        for tag, extra in FAMILY_REQUIRED.items():
            if tag in metric:
                for key in extra:
                    if key not in row:
                        problems.append(
                            f"'{metric}' is a {tag.strip('_')} row but "
                            f"lacks '{key}' (family rule: roofline rows "
                            "carry their utilization column)")
    return problems


def validate_rows(rows) -> Dict[int, List[str]]:
    """{row index: problems} over an iterable of row dicts (valid rows are
    omitted)."""
    out: Dict[int, List[str]] = {}
    for i, row in enumerate(rows):
        problems = validate_row(row)
        if problems:
            out[i] = problems
    return out
