"""Configurable lint catalogue over Program IR — the port's copy of
``paddle_tpu/analysis/lints.py``.

:func:`lint_catalogue_drift` (L007) runs over the port's tree against
the port's catalogue, and :func:`lint_alert_rules` (L009) over
``obs.alerts``, and :func:`lint_autotune_cache` (L008) over the port's
autotune cache and plan spaces (``tune/``). L004 checks
axis names against the mesh plane's canonical axis order
(``parallel.mesh.CANONICAL_ORDER``).

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
  default ``parallel.mesh.CANONICAL_ORDER`` (``make_mesh`` accepts custom
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
    defaults to ``parallel.mesh.CANONICAL_ORDER``.  ``enable`` — subset of
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


#: metric name: the obs facade's emitters and the registry constructors
_EMIT_ATTRS = frozenset(("count", "gauge_set", "observe",
                         "counter", "gauge", "histogram"))


def _metric_literals(tree):
    """(literals, patterns) of metric names an AST emits: plain string
    constants, plus regexes for f-string names (``f"goodput.{b}_total"``
    -> ``goodput\\..*_total``) so dynamically-assembled families still
    anchor their catalogue entries."""
    import ast
    import re as _re
    literals: Set[str] = set()
    patterns: List = []

    def _collect(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            literals.add(node.value)
        elif isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant):
                    parts.append(_re.escape(str(v.value)))
                else:
                    parts.append(".*")
            patterns.append(_re.compile("^" + "".join(parts) + "$"))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        # `obs.count(...)`, `self._count(...)`, and the imported-alias
        # forms `count(...)` / `_gauge_set(...)` all emit; leading
        # underscores are the module-private alias convention
        fname = (node.func.attr if isinstance(node.func, ast.Attribute)
                 else node.func.id if isinstance(node.func, ast.Name)
                 else "")
        if fname.lstrip("_") in _EMIT_ATTRS and node.args:
            _collect(node.args[0])
        for kw in node.keywords:
            if kw.arg == "metric":            # obs.span(..., metric=...)
                _collect(kw.value)
    return literals, patterns


def lint_catalogue_drift(root=None, catalogue=None,
                         severity: Severity = None) -> List[Diagnostic]:
    """L007: cross-check emit sites in the source tree against the metric
    catalogue — both directions.

    Walks every ``.py`` under ``root`` (default: the installed
    ``paddle_tpu_torch`` package) collecting string-literal metric names passed
    to the obs emitters (``count``/``gauge_set``/``observe``, the
    registry's ``counter``/``gauge``/``histogram``, a span's ``metric=``
    kwarg). A literal that *looks like* a metric name (matches the L005
    shape — guards against ``str.count(...)`` false positives) but is
    missing from the catalogue is flagged with its file; a catalogue
    entry no site ever names (literally or via an f-string family) is
    flagged as an orphan."""
    import ast
    import os

    from ..obs.metrics import METRIC_NAME_RE
    if catalogue is None:
        from ..obs import CATALOGUE as catalogue
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sev = severity if severity is not None else LINT_CATALOGUE["L007"][1]
    diags: List[Diagnostic] = []
    literals: Dict[str, str] = {}          # name -> first file emitting it
    patterns: List = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue                    # unreadable: not this lint's job
            lits, pats = _metric_literals(tree)
            rel = os.path.relpath(path, root)
            for name in lits:
                literals.setdefault(name, rel)
            patterns.extend(pats)
    for name in sorted(literals):
        if not METRIC_NAME_RE.match(name):
            continue                        # not a metric-shaped literal
        if name not in catalogue:
            diags.append(Diagnostic(
                "L007", sev,
                f"emit site passes metric '{name}' "
                f"({literals[name]}) but obs/catalogue.py does not "
                "declare it", var=name,
                hint="add a CATALOGUE entry (kind, help[, labels]) — the "
                     "catalogue is the metrics API surface"))
    for name in sorted(catalogue):
        if name in literals:
            continue
        if any(p.match(name) for p in patterns):
            continue                        # an f-string family emits it
        diags.append(Diagnostic(
            "L007", sev,
            f"catalogue entry '{name}' has no emit site in the tree "
            "(orphan)", var=name,
            hint="delete the entry, or wire the metric where it was "
                 "meant to be observed"))
    return diags


def lint_alert_rules(rules=None, catalogue=None,
                     severity: Severity = None) -> List[Diagnostic]:
    """L009: alert rules vs the metric catalogue — the alerting twin of
    L005/L007.

    Checks every rule (default: the shipped
    :func:`paddle_tpu_torch.obs.alerts.default_rules` set, which is what a
    master aggregator starts with) against the catalogue (default:
    :data:`paddle_tpu_torch.obs.CATALOGUE`):

    * the rule's ``metric`` must be a catalogued name — a rule naming a
      typo'd or renamed metric never fires, silently;
    * every label key the rule filters on must be declared by the
      metric's catalogue entry (``worker`` is always legal: the merged
      cluster view stamps it on every pushed series);
    * ``burn_rate`` rules must target histograms (the math needs
      cumulative buckets); ``threshold`` rules must target counters or
      gauges (a histogram has no single value to compare).
    """
    if catalogue is None:
        from ..obs import CATALOGUE as catalogue
    if rules is None:
        from ..obs.alerts import default_rules
        rules = default_rules()
    sev = severity if severity is not None else LINT_CATALOGUE["L009"][1]
    diags: List[Diagnostic] = []

    def emit(msg: str, rule, hint: str):
        diags.append(Diagnostic("L009", sev, msg, var=rule.name, hint=hint))

    for rule in rules:
        spec = catalogue.get(rule.metric)
        if spec is None:
            emit(f"alert rule '{rule.name}' references metric "
                 f"'{rule.metric}' which obs/catalogue.py does not "
                 "declare — the rule can never fire", rule,
                 "fix the metric name, or catalogue the new metric first")
            continue
        kind = spec[0] if isinstance(spec, (tuple, list)) else spec
        declared = (tuple(spec[2]) if isinstance(spec, (tuple, list))
                    and len(spec) > 2 else ())
        for key in rule.labels:
            if key != "worker" and key not in declared:
                emit(f"alert rule '{rule.name}' filters on label "
                     f"'{key}' which '{rule.metric}' does not declare "
                     f"(declared: {list(declared) or 'none'})", rule,
                     "filter only on declared label keys (or 'worker')")
        if rule.kind == "burn_rate" and kind != "histogram":
            emit(f"alert rule '{rule.name}' is burn_rate over "
                 f"'{rule.metric}' ({kind}); burn-rate math needs a "
                 "histogram's cumulative buckets", rule,
                 "use a threshold rule, or target the _seconds histogram")
        elif rule.kind == "threshold" and kind == "histogram":
            emit(f"alert rule '{rule.name}' thresholds histogram "
                 f"'{rule.metric}' which has no single value", rule,
                 "use burn_rate with an slo_le bucket bound instead")
    return diags


def lint_autotune_cache(path=None,
                        severity: Severity = None) -> List[Diagnostic]:
    """L008: the autotune cache vs the CURRENT plan spaces — staleness.

    An autotune entry is only as good as the candidate set that produced
    it: when a plan space changes (``paddle_tpu.tune.spaces.SPACE_DEFS``),
    previously tuned winners may no longer exist, or better candidates may
    have appeared. Stale entries are IGNORED at consult time (the
    heuristics silently own those decisions again), so the lint is what
    makes the degradation visible: it flags a schema-version mismatch
    (whole file ignored), entries whose ``space_hash`` differs from the
    current space's hash, and entries naming unknown spaces. Fix: re-run
    ``paddle_tpu tune``. ``path=None`` resolves the port's own cache
    (``$PADDLE_TPU_TORCH_AUTOTUNE_CACHE`` /
    ``~/.paddle_tpu_torch/autotune.json``); a missing file is clean
    (nothing tuned, nothing stale). The diagnostics are JAX's, word for
    word, over the port's plan spaces (tune/spaces.py)."""
    import json
    import os

    from ..tune import cache as _tcache
    from ..tune import spaces as _tspaces
    sev = severity if severity is not None else LINT_CATALOGUE["L008"][1]
    diags: List[Diagnostic] = []
    path = path or _tcache.default_cache_path()
    if not os.path.exists(path):
        return diags

    def emit(msg: str, hint: str, **kw):
        diags.append(Diagnostic("L008", sev, msg, hint=hint, **kw))

    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        emit(f"autotune cache {path} is unreadable ({e}); every consult "
             "falls back to heuristics",
             "delete the file or re-run `paddle_tpu tune`")
        return diags
    version = data.get("schema_version") if isinstance(data, dict) else None
    if version != _tcache.SCHEMA_VERSION:
        emit(f"autotune cache {path} has schema_version {version!r} "
             f"(supported: {_tcache.SCHEMA_VERSION}); the whole file is "
             "ignored at consult time",
             "re-run `paddle_tpu tune` to rewrite it")
        return diags
    entries = data.get("entries") or {}
    for key, entry in sorted(entries.items()):
        if not isinstance(entry, dict):
            emit(f"autotune entry {key!r} is not an object",
                 "re-run `paddle_tpu tune`", var=key)
            continue
        space = entry.get("space")
        if space not in _tspaces.SPACE_DEFS:
            emit(f"autotune entry {key!r} names unknown plan space "
                 f"{space!r} (known: {list(_tspaces.SPACE_NAMES)}); "
                 "ignored at consult time",
                 "the space was removed/renamed — re-run `paddle_tpu "
                 "tune` to drop it", var=key)
            continue
        current = _tspaces.space_hash(space)
        if entry.get("space_hash") != current:
            emit(f"autotune entry {key!r} was tuned under plan-space hash "
                 f"{entry.get('space_hash')!r} but the current "
                 f"{space!r} space hashes {current!r}; the entry is "
                 "STALE and ignored at consult time (heuristic applies)",
                 "re-run `paddle_tpu tune` to re-measure under the new "
                 "candidate set", var=key)
            continue
        if space == "fusion":
            _lint_fusion_entry(key, entry, emit)
        elif space == "bucket_grid":
            _lint_bucket_grid_entry(key, entry, emit)
    return diags


def _lint_fusion_entry(key, entry, emit):
    """Per-entry L008 checks specific to the ``fusion`` space: the plan
    must be the binary verdict, the dependence certificate must be
    present, and the family's program/group signature components must
    re-derive from the persisted certificate — a hand-edited or wrongly
    merged cache whose proof no longer matches its key is refused at
    consult time (``cert_invalid``), and this is what makes it visible."""
    from ..tune import fusion as _tfusion
    plan = entry.get("plan")
    if not isinstance(plan, dict) or not isinstance(plan.get("fuse"), bool):
        emit(f"fusion entry {key!r} has plan {plan!r} (expected "
             "{'fuse': true|false}); ignored at consult time",
             "re-run `paddle_tpu tune fusion`", var=key)
        return
    cert = entry.get("certificate")
    if not isinstance(cert, dict):
        emit(f"fusion entry {key!r} carries no dependence certificate; "
             "the consult cannot re-validate it against the current "
             "program and refuses it (cert_invalid)",
             "re-run `paddle_tpu tune fusion`", var=key)
        return
    family = str(entry.get("family") or "")
    parts = family.split(":")
    if len(parts) != 3:
        emit(f"fusion entry {key!r} family {family!r} is not "
             "'program_sig:shape_family:group_sig'",
             "re-run `paddle_tpu tune fusion`", var=key)
        return
    derived = _tfusion.group_signature(cert)
    if derived != parts[2]:
        emit(f"fusion entry {key!r}: group signature {parts[2]!r} in the "
             f"family key does not re-derive from the persisted "
             f"certificate (derived {derived!r}); the key and the proof "
             "disagree — ignored at consult time",
             "the cache was hand-edited or wrongly merged; re-run "
             "`paddle_tpu tune fusion`", var=key)
    prog_sig = entry.get("program_signature")
    if prog_sig is not None and prog_sig != parts[0]:
        emit(f"fusion entry {key!r}: program_signature {prog_sig!r} "
             f"disagrees with the family key's {parts[0]!r}",
             "re-run `paddle_tpu tune fusion`", var=key)


def _lint_bucket_grid_entry(key, entry, emit):
    """Per-entry L008 checks for ``bucket_grid``: the plan's grid must be
    strictly ascending unique positive ints (the same legality the
    consult enforces — an illegal grid silently falls back)."""
    plan = entry.get("plan")
    buckets = plan.get("buckets") if isinstance(plan, dict) else None
    if (not isinstance(buckets, (list, tuple)) or not buckets
            or not all(isinstance(b, int) and not isinstance(b, bool)
                       and b >= 1 for b in buckets)
            or list(buckets) != sorted(set(buckets))):
        emit(f"bucket_grid entry {key!r} has plan {plan!r} (expected "
             "{'buckets': [ascending unique positive ints]}); ignored "
             "at consult time",
             "re-run `paddle_tpu tune bucket_grid`", var=key)


def _lint_sharding(program, mesh_axes, emit):
    explicit = mesh_axes is not None
    if not explicit:
        from ..parallel.mesh import CANONICAL_ORDER
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
