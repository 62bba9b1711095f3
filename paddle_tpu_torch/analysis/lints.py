"""Configurable lint catalogue over Program IR — the port's copy of
``paddle_tpu/analysis/lints.py``.

Three lints need planes the port has not taken yet and raise naming
ROADMAP A.8: :func:`lint_catalogue_drift` and :func:`lint_alert_rules`
(the obs catalogue and alert rules) and :func:`lint_autotune_cache` (the
tune plane). L004 checks axis names against the port's own copy of the
mesh plane's canonical axis order (:data:`CANONICAL_ORDER`).

Lints are advisory by default (WARNING/INFO); the CLI's ``--fail-on`` and
:func:`lint_program`'s ``severity_overrides`` promote or demote them.  IDs:

- **L001 dead-op** (warning): an op none of whose outputs is ever read by a
  later op (in any block), fetched, or synced to the scope (persistable).
  The block's run computes it and throws it away, so it is almost always
  a bug in the code that built the program.  The last op of a block is
  exempt when no fetch list is given — its outputs are the block's
  results.
- **L002 unused-variable** (info): a declared var no op reads or writes and
  nobody fetches — desc noise that bloats serialized programs.
- **L003 trace-safety** (warning): attrs that break graph capture or program
  serialization — host callables outside ``fill_init.init`` (cannot
  round-trip through ``Program.to_dict``; if they close over arrays the op
  becomes trace-dependent) and array-valued attrs (constants baked into the
  desc make the compiled fn shape-dependent on program-building state).
- **L004 sharding-consistency** (error): a ``Variable.sharding`` annotation
  or op-level ``sharding`` attr that repeats an axis or has more entries
  than the tensor has dims — a mesh would reject or mis-partition it.
  An axis name outside the valid set is an ERROR when the
  caller pins ``mesh_axes`` explicitly, but only a WARNING against the
  default :data:`CANONICAL_ORDER` (``make_mesh`` accepts custom
  axis names, so an unknown name may be a real custom axis).  A malformed
  spec (non-string entries, a non-sequence) is reported, never raised on.
- **L005 metric-naming** (warning): an observability metric name that
  breaks the public naming contract (docs/design/observability.md):
  shape ``subsystem.noun_qualifier`` (one dot, snake_case), counters end
  ``_total``, histograms end ``_seconds``/``_bytes``/``_total``, gauges
  claim no reserved suffix.  Runs over :data:`paddle_tpu.obs.CATALOGUE`
  in the ``paddle_tpu lint`` CLI (:func:`lint_metric_names`) — metric
  names are API surface; a drive-by rename breaks dashboards silently.
- **L006 shape-churn** (warning): a Program is being run with feeds whose
  shapes keep changing and no bucket spec — every distinct shape pays a
  fresh run and CUDA graph capture.  Unlike L001–L005 this has no static
  signature (the desc can't see future feed shapes), so it is emitted *at
  run time* by ``fluid.Executor`` as a ``RuntimeWarning`` naming this id,
  on a streak of compiled-fn cache misses (``executor._CHURN_STREAK``)
  with ``Executor(buckets=None)``.  Fix: pass a
  :class:`~paddle_tpu.data.feeder.BucketSpec`
  (docs/design/executor_perf.md).
- **L009 alert-rules** (warning): an alert rule
  (:mod:`paddle_tpu.obs.alerts`) referencing a metric name the catalogue
  does not declare, filtering on a label key the metric's catalogue entry
  does not carry (``worker`` is always legal — the merged-view label
  contract), or applying a kind that cannot evaluate against the metric's
  kind (``burn_rate`` needs a histogram; ``threshold`` needs a
  counter/gauge value).  Rules are config pointed at the catalogue's API
  surface — a rule naming a typo'd metric silently never fires, which is
  the worst possible alerting failure.  Runs over the shipped default
  rule set in ``paddle_tpu lint`` (:func:`lint_alert_rules`) and the obs
  test-suite.
- **L007 catalogue-drift** (warning): an emit site in ``paddle_tpu/``
  (``obs.count/gauge_set/observe``, ``registry.counter/gauge/histogram``,
  a span's ``metric=``) passes a string-literal metric name that is not
  declared in ``obs/catalogue.py`` — or, vice versa, a catalogue entry no
  emit site ever names (an orphan that documents a series which cannot
  exist).  The catalogue is the metrics API surface; drift in either
  direction means dashboards and docs lie.  Runs over the source tree in
  the ``paddle_tpu lint`` CLI and the obs test-suite
  (:func:`lint_catalogue_drift`).
- **L010 dead-write** (warning), **L011 donation-hazard** (error), **L012
  alias-escape** (warning): the dataflow-backed lints — def-use chains,
  alias roots, and the donation-safety proof from
  :mod:`paddle_tpu.analysis.dataflow` (see :func:`_lint_dataflow` and
  docs/design/analysis.md "Dataflow & liveness").
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

from .diagnostics import Diagnostic, Severity
from .verify import BLOCK_ATTR_KEYS, _ATTR_BIND_KEYS, _ATTR_READ_KEYS, _names

#: the mesh plane's axis order (``paddle_tpu/parallel/mesh.py``), the
#: valid sharding axis names when ``lint_program`` is given no
#: ``mesh_axes``; the port's ``parallel/mesh.py`` takes it over (A.7)
CANONICAL_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model", "tp")

LINT_CATALOGUE = {
    "L001": ("dead-op", Severity.WARNING),
    "L002": ("unused-variable", Severity.INFO),
    "L003": ("trace-safety", Severity.WARNING),
    "L004": ("sharding-consistency", Severity.ERROR),
    "L005": ("metric-naming", Severity.WARNING),
    # L006 is runtime-emitted by fluid.Executor (cache-miss streak with no
    # bucket spec) — catalogued here so the id/severity live in one table
    "L006": ("shape-churn", Severity.WARNING),
    "L007": ("catalogue-drift", Severity.WARNING),
    "L008": ("autotune-staleness", Severity.WARNING),
    "L009": ("alert-rules", Severity.WARNING),
    # L010-L012 are dataflow-backed (analysis.dataflow): def-use chains,
    # alias roots, and the donation-safety proof, not per-block scans
    "L010": ("dead-write", Severity.WARNING),
    "L011": ("donation-hazard", Severity.ERROR),
    "L012": ("alias-escape", Severity.WARNING),
}

# control-flow / executor-lowered ops act through sub-blocks, not outputs
_STRUCTURAL_OPS = {"while", "conditional_block", "static_rnn",
                   "beam_search_gen", "autodiff_grad", "feed", "fetch"}

# env-read attr keys beyond verify's tables (names read at lowering time)
_EXTRA_READ_KEYS = ("mem_update_names", "step_out_names", "prob_name",
                    "token_embed_name", "last_mem_outputs", "loss", "params")


def _attr_read_names(op) -> Set[str]:
    reads: Set[str] = set()
    for table in (_ATTR_READ_KEYS, _ATTR_BIND_KEYS):
        for key in table.get(op.type, ()):
            reads.update(_names(op.attrs.get(key)))
    for key in _EXTRA_READ_KEYS:
        if key in op.attrs:
            reads.update(_names(op.attrs.get(key)))
    return reads


def _all_reads(program) -> Set[str]:
    reads: Set[str] = set()
    for block in program.blocks:
        for op in block.ops:
            reads.update(op.input_vars())
            reads.update(_attr_read_names(op))
    return reads


def lint_program(program, fetch: Iterable[str] = (),
                 mesh_axes: Optional[Sequence[str]] = None,
                 enable: Optional[Iterable[str]] = None,
                 severity_overrides: Optional[Dict[str, Severity]] = None,
                 feed: Iterable[str] = (),
                 donate: Optional[bool] = None,
                 diags: Optional[List[Diagnostic]] = None) -> List[Diagnostic]:
    """Run the lint catalogue; returns the diagnostic list.

    ``fetch`` — names the caller will fetch (liveness roots for L001/L002,
    donation exclusions for L011).  ``feed`` — names the caller feeds
    (donation exclusions).  ``mesh_axes`` — valid sharding axis names;
    defaults to :data:`CANONICAL_ORDER`.  ``enable`` — subset of
    lint IDs to run (default: all).  ``severity_overrides`` — e.g. promote
    ``{"L001": Severity.ERROR}`` to make dead ops hard failures.
    ``donate`` — the executor's donation switch: ``True`` makes L011 an
    ERROR (the run WILL donate hazardous buffers), ``None`` (static /CLI
    context) demotes it to an advisory WARNING, ``False`` skips it.
    """
    diags = [] if diags is None else diags
    enabled = set(enable) if enable is not None else set(LINT_CATALOGUE)
    overrides = severity_overrides or {}

    def emit(code: str, message: str, severity: Optional[Severity] = None,
             **kw):
        sev = overrides.get(
            code, severity if severity is not None
            else LINT_CATALOGUE[code][1])
        diags.append(Diagnostic(code, sev, message, **kw))

    fetch = set(fetch)
    reads = _all_reads(program)
    persistables = {name for block in program.blocks
                    for name, v in block.vars.items() if v.persistable}

    if "L001" in enabled:
        _lint_dead_ops(program, reads, fetch, persistables, emit)
    if "L002" in enabled:
        _lint_unused_vars(program, reads, fetch, emit)
    if "L003" in enabled:
        _lint_trace_safety(program, emit)
    if "L004" in enabled:
        _lint_sharding(program, mesh_axes, emit)
    if enabled & {"L010", "L011", "L012"}:
        _lint_dataflow(program, fetch, set(feed), donate, enabled, emit)
    return diags


def _lint_dataflow(program, fetch, feed, donate, enabled, emit):
    """The dataflow-backed lints (analysis.dataflow consumers).

    - **L010 dead-write**: a Def with zero recorded Uses that a later Def
      of the same name kills before the end of the program.  Same-block
      linear kills are V003's domain (an ERROR there) and skipped here;
      L010 owns the cross-block cases V003's per-block pending scan cannot
      see (a sub-block write overwritten after the loop, a branch write
      overwritten by the parent).
    - **L011 donation-hazard**: :func:`analysis.dataflow.donation_hazards`
      found a donated persistable whose entry value may be read after its
      overwrite — an ERROR when ``donate=True`` (the run corrupts), an
      advisory WARNING in static/CLI context (``donate=None``), skipped
      when donation is off.
    - **L012 alias-escape**: a sub-block op writes a name that aliases an
      outer-scope var (through assign/reshape/... view roots) while the
      base var itself is never updated in that control region: the write
      rebinds only the view name — under the reference's shared-buffer
      semantics the base would change, under the executor's by-name
      semantics it silently does not.
    """
    from . import dataflow as D
    df = D.analyze_dataflow(program, feed=feed, fetch=fetch)
    paths = df.block_paths

    if "L010" in enabled:
        for d in df.defs:
            if d.kind != "op" or d.uses or d.name in fetch:
                continue
            if d in df.final_env.get(d.name, ()):
                continue          # reaches the end: fetchable/synced, live
            killers = sorted((k for k in df.defs
                              if k.name == d.name and k.kind == "op"
                              and k.pos > d.pos), key=lambda k: k.pos)
            if not killers:
                continue          # never overwritten: L001's dead-op case
            if killers[0].block_idx == d.block_idx:
                continue          # same-block linear kill: V003's ERROR
            emit("L010",
                 f"dead write: '{d.name}' written here is overwritten at "
                 f"{killers[0].site(paths)} before any read",
                 block_idx=d.block_idx, op_idx=d.op_idx, op_type=d.op_type,
                 var=d.name,
                 hint="read the value before the overwrite, or drop the "
                      "first write — the traced computation discards it")

    if "L011" in enabled and donate is not False:
        sev = (LINT_CATALOGUE["L011"][1] if donate
               else Severity.WARNING)
        for hz in D.donation_hazards(program, feed=feed, fetch=fetch, df=df):
            first_ow = hz.overwrites[0]
            qualifier = ("" if donate else
                         " (advisory: hazardous if run with donate=True, "
                         "the Executor default)")
            emit("L011", hz.describe(paths) + qualifier, severity=sev,
                 block_idx=first_ow.block_idx, op_idx=first_ow.op_idx,
                 op_type=first_ow.op_type, var=hz.name,
                 hint="move the read before the update, fetch the var "
                      "(fetched persistables are never donated), or run "
                      "with donate=False")

    if "L012" in enabled:
        for esc in df.alias_escapes:
            emit("L012",
                 f"sub-block write to '{esc['name']}' only rebinds a view "
                 f"of outer var '{esc['base']}' (aliased at "
                 f"{esc['view_def'].site(paths)}); the base var is never "
                 "updated in this control region",
                 block_idx=esc["block_idx"], op_idx=esc["op_idx"],
                 op_type=esc["op_type"], var=esc["name"],
                 hint=f"write '{esc['base']}' itself (sub-block writes "
                      "propagate by name through the loop carry), or use "
                      "a fresh local name for the rebound value")


def _lint_dead_ops(program, reads, fetch, persistables, emit):
    live = reads | fetch | persistables
    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            if op.type in _STRUCTURAL_OPS or any(
                    key in op.attrs for key in BLOCK_ATTR_KEYS):
                continue
            outs = op.output_vars()
            if not outs:
                continue
            if not fetch and idx == len(block.ops) - 1:
                continue  # a block's final op produces its implicit result
            if not any(n in live for n in outs):
                emit("L001",
                     f"dead op: outputs {outs} are never read, fetched, or "
                     "persisted — the compiled computation drops this op",
                     block_idx=block.idx, op_idx=idx, op_type=op.type,
                     hint="fetch the result, feed it to another op, or "
                          "delete the op")


def _lint_unused_vars(program, reads, fetch, emit):
    touched: Set[str] = set(reads)
    for block in program.blocks:
        for op in block.ops:
            touched.update(op.output_vars())
    for block in program.blocks:
        for name, v in block.vars.items():
            if name in touched or name in fetch or name == "__step__":
                continue
            kind = "feed slot" if v.is_data else "variable"
            emit("L002", f"unused {kind} '{name}' (no op reads or writes it)",
                 block_idx=block.idx, var=name,
                 hint="remove the declaration or wire it into the program")


def _lint_trace_safety(program, emit):
    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            for key, val in op.attrs.items():
                if callable(val) and not (op.type == "fill_init"
                                          and key == "init"):
                    emit("L003",
                         f"attr '{key}' is a host callable "
                         f"({getattr(val, '__name__', type(val).__name__)}): "
                         "it cannot serialize and, if it closes over traced "
                         "arrays, makes the op trace-dependent",
                         block_idx=block.idx, op_idx=idx, op_type=op.type,
                         hint="pass data through inputs and plain attrs; "
                              "host init callables belong on fill_init only")
                elif getattr(val, "shape", None) and hasattr(val, "dtype"):
                    # non-scalar ndarray / tensor baked into the desc
                    emit("L003",
                         f"attr '{key}' holds an array baked into the desc; "
                         "under a CUDA graph its value is frozen at capture "
                         "(shape/data changes will not re-capture)",
                         block_idx=block.idx, op_idx=idx, op_type=op.type,
                         hint="feed arrays through op inputs instead")


#: kind -> allowed name suffixes (None entry = no suffix requirement)
_METRIC_SUFFIXES = {
    "counter": ("_total",),
    "histogram": ("_seconds", "_bytes", "_total"),
}
_RESERVED_SUFFIXES = ("_total", "_seconds", "_bytes", "_bucket", "_sum",
                      "_count")

# label keys whose values are, in practice, unbounded identifier spaces: a
# per-path / per-payload / per-uuid label mints a new time series per value
# and melts whatever stores the metrics (the Prometheus cardinality
# failure mode). Bounded enums — op/type/site/action/rpc/worker — are fine.
_UNBOUNDED_LABEL_KEYS = frozenset((
    "path", "file", "filename", "dir", "payload", "task", "task_id",
    "id", "uuid", "trace", "trace_id", "span", "span_id", "addr",
    "address", "url", "host", "endpoint", "user", "query"))

#: value-shape heuristics (applied when live samples are linted): a label
#: value longer than this, or containing a path separator, is almost
#: certainly a raw identifier rather than a bounded enum
_MAX_LABEL_VALUE_LEN = 64
#: distinct values per (metric, label key) before the series space is
#: called unbounded
_MAX_LABEL_CARDINALITY = 32


def lint_metric_names(catalogue, severity: Severity = None,
                      samples=None) -> List[Diagnostic]:
    """L005: validate metric names against the ``subsystem.noun_qualifier``
    contract (obs.metrics.METRIC_NAME_RE) plus the suffix-per-
    kind conventions, and flag unbounded-cardinality labels.

    ``catalogue`` is a mapping ``name -> (kind, help[, labels])`` (the
    shape of JAX's ``obs.CATALOGUE``), ``name -> kind``, or a
    plain iterable of names (then only the shape is checked). Declared
    label *keys* are checked against the known-unbounded set (a raw path
    or task payload as a label value explodes the series space).

    ``samples`` optionally takes live ``MetricsRegistry.collect()``
    output; label *values* are then also checked — path-like or very long
    values, and per-key cardinality beyond a bounded-enum's plausible
    size, are flagged even when the key name looks innocent.

    Standalone on purpose: metric names live in instrumented *code*, not
    Program IR, so this lint is driven by the CLI and the obs test-suite
    rather than ``lint_program``.
    """
    from ..obs.metrics import METRIC_NAME_RE   # lazy: keeps analysis light
    sev = severity if severity is not None else LINT_CATALOGUE["L005"][1]
    diags: List[Diagnostic] = []

    def emit(msg: str, name: str, hint: str):
        diags.append(Diagnostic("L005", sev, msg, var=name, hint=hint))

    if isinstance(catalogue, dict):
        items = []
        for name, spec in catalogue.items():
            kind = spec[0] if isinstance(spec, (tuple, list)) else spec
            labels = (tuple(spec[2]) if isinstance(spec, (tuple, list))
                      and len(spec) > 2 else ())
            items.append((name, kind, labels))
    else:
        items = [(name, None, ()) for name in catalogue]
    for name, kind, labels in items:
        for key in labels:
            if key in _UNBOUNDED_LABEL_KEYS:
                emit(f"label '{key}' on '{name}' is an unbounded-"
                     "cardinality key (each distinct value mints a new "
                     "series)", name,
                     "put identifiers in span args/logs; keep labels to "
                     "bounded enums (op, type, site, worker, ...)")
        if not METRIC_NAME_RE.match(name):
            emit(f"metric name '{name}' is not subsystem.noun_qualifier "
                 "(exactly one dot, snake_case atoms)", name,
                 "rename to e.g. 'trainer.steps_total'")
            continue
        if kind in _METRIC_SUFFIXES:
            if not name.endswith(_METRIC_SUFFIXES[kind]):
                emit(f"{kind} '{name}' must end with one of "
                     f"{'/'.join(_METRIC_SUFFIXES[kind])}", name,
                     "counters count (suffix _total); histograms measure "
                     "(suffix _seconds/_bytes)")
        elif kind == "gauge" and name.endswith(_RESERVED_SUFFIXES):
            emit(f"gauge '{name}' claims a suffix reserved for "
                 "counters/histograms", name,
                 "drop the suffix — a gauge is a point-in-time value")
    if samples:
        # live-sample pass: catch unbounded label VALUES the static
        # catalogue can't see (a bounded-sounding key fed raw paths)
        seen: Dict[tuple, Set[str]] = {}
        flagged_val: Set[tuple] = set()
        for s in samples:
            if not isinstance(s, dict):
                continue
            mname = s.get("name", "?")
            for key, value in (s.get("labels") or {}).items():
                v = str(value)
                if (key, mname) not in flagged_val and (
                        len(v) > _MAX_LABEL_VALUE_LEN or "/" in v
                        or "\\" in v):
                    flagged_val.add((key, mname))
                    emit(f"label '{key}' on '{mname}' carries a path-like "
                         f"or oversized value ({v[:40]!r}...): unbounded "
                         "cardinality", mname,
                         "record the identifier in span args or logs, not "
                         "a metric label")
                seen.setdefault((mname, key), set()).add(v)
        for (mname, key), values in sorted(seen.items()):
            if len(values) > _MAX_LABEL_CARDINALITY:
                emit(f"label '{key}' on '{mname}' has {len(values)} "
                     f"distinct values (> {_MAX_LABEL_CARDINALITY}): "
                     "series space looks unbounded", mname,
                     "bucket the value or move it out of labels")
    return diags


def _needs_a8(what: str):
    raise NotImplementedError(
        f"{what} waits for the port's obs and tune planes (ROADMAP A.8)")


def lint_catalogue_drift(root=None, catalogue=None,
                         severity: Severity = None) -> List[Diagnostic]:
    """L007: emit sites against the obs metric catalogue. The port has no
    catalogue yet (``obs/catalogue.py``), so this raises naming A.8."""
    _needs_a8("lint_catalogue_drift (L007, the obs metric catalogue)")


def lint_alert_rules(rules=None, catalogue=None,
                     severity: Severity = None) -> List[Diagnostic]:
    """L009: alert rules against the metric catalogue. The port has no
    ``obs/alerts.py`` or catalogue yet, so this raises naming A.8."""
    _needs_a8("lint_alert_rules (L009, obs alert rules)")


def lint_autotune_cache(path=None,
                        severity: Severity = None) -> List[Diagnostic]:
    """L008: the autotune cache against the current plan spaces. The port
    has no ``tune/`` plane yet, so this raises naming A.8."""
    _needs_a8("lint_autotune_cache (L008, the tune plane)")


def _lint_sharding(program, mesh_axes, emit):
    explicit = mesh_axes is not None
    if not explicit:
        mesh_axes = CANONICAL_ORDER
    valid = set(mesh_axes)
    # make_mesh accepts axis names beyond CANONICAL_ORDER, so an unknown
    # name is only a hard error when the caller pinned the axes
    unknown_sev = Severity.ERROR if explicit else Severity.WARNING

    def check(spec, ndim, where, **site):
        if spec is None:
            return
        if isinstance(spec, str):
            spec = (spec,)
        try:
            entries = list(spec)
        except TypeError:
            emit("L004", f"{where} is not a sharding spec "
                         f"({spec!r}); expected a sequence of axis "
                         "names / None", **site)
            return
        axes = [a for a in entries if a is not None]
        for a in axes:
            if not isinstance(a, str):
                emit("L004", f"{where} has non-string entry {a!r}", **site)
            elif a not in valid:
                emit("L004",
                     f"{where} names unknown mesh axis '{a}' "
                     f"(valid: {sorted(valid)})", severity=unknown_sev,
                     **site)
        axes = [a for a in axes if isinstance(a, str)]
        dup = {a for a in axes if axes.count(a) > 1}
        if dup:
            emit("L004",
                 f"{where} repeats mesh axes {sorted(dup)}; an axis may "
                 "shard at most one tensor dim", **site)
        if ndim is not None and len(entries) > ndim:
            emit("L004",
                 f"{where} has {len(entries)} entries for a "
                 f"{ndim}-dim tensor", **site)

    for block in program.blocks:
        for name, v in block.vars.items():
            check(getattr(v, "sharding", None), len(v.shape) or None,
                  f"sharding annotation on var '{name}'",
                  block_idx=block.idx, var=name)
        for idx, op in enumerate(block.ops):
            check(op.attrs.get("sharding"), None,
                  f"op attr 'sharding'",
                  block_idx=block.idx, op_idx=idx, op_type=op.type)
