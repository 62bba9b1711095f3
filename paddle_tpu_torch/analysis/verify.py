"""Structural verifier over ``Program``/``Block``/``Operator``.

Checks, per block and in op order (codes are stable):

- **V001** read of an undefined variable — def-before-use with correct
  parent-scope lookup: a sub-block sees (a) names defined in an ancestor
  block *at the point its control-flow op appears*, (b) feed/data and
  persistable vars, and (c) names its own earlier ops wrote.  A var declared
  only in a *sibling* branch block is NOT visible.
- **V002** op type not registered in ``OpRegistry``.  Note
  ``Operator.__init__`` already rejects unregistered types at build /
  ``Program.from_dict`` time, so V002 fires for programs whose op types were
  mutated after construction or built through a bypassing code path.
- **V003** duplicate output write: a var written twice within one block with
  no intervening read (the first write is silently lost), or the same var
  listed twice in one op's outputs.
- **V004** sub-block reference invalid: index out of range, pointing at the
  global block / itself, or cyclic (a block that transitively contains
  itself).  **V007** (warning) sub-block parent index inconsistent with the
  block its op lives in.
- **V005** ``while`` condition var never written inside the loop body
  (would loop forever — the executor's trace-time ValueError, caught
  statically).
- **V006** fetch of a variable the program never defines.

The verifier never imports jax and never traces — it is pure desc-level
analysis, safe to run on any host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, Severity

# attr keys through which an op references a sub-block
BLOCK_ATTR_KEYS = ("sub_block_idx", "true_block_idx", "false_block_idx")

# attr keys whose (string / list-of-string) values name OUTER vars the
# executor reads from env when lowering the op — they are reads even though
# they do not appear in op.inputs
_ATTR_READ_KEYS = {
    "autodiff_grad": ("loss", "params"),
    "static_rnn": ("boot_mems",),
    "beam_search_gen": ("boot_mems", "static_outer", "embed_param"),
}

# attr keys naming sub-block vars the executor BINDS before tracing the
# sub-block (scan carries / step slices) — they are defined-on-entry there
_ATTR_BIND_KEYS = {
    "static_rnn": ("step_in_names", "mem_names"),
    "beam_search_gen": ("mem_names", "static_in_names", "token_embed_name"),
}

# attr keys naming PARENT vars the op defines beyond op.outputs
_ATTR_DEFINE_KEYS = {
    "static_rnn": ("last_mem_outputs",),
}


def _names(value) -> List[str]:
    """Normalize a str-or-list-of-str attr value to a name list."""
    if value is None:
        return []
    if isinstance(value, str):
        return [value]
    return [n for n in value if isinstance(n, str)]


def _attr_names(op, table) -> List[str]:
    out: List[str] = []
    for key in table.get(op.type, ()):
        out.extend(_names(op.attrs.get(key)))
    return out


def _seed_block_vars(block, defined: Set[str]):
    """Feed slots and persistables are available on block entry (feeds come
    from the caller, persistables from the scope)."""
    for name, v in block.vars.items():
        if v.is_data or v.persistable:
            defined.add(name)


def _transitive_writes(program, block, seen: Optional[Set[int]] = None) -> Set[str]:
    """All var names (transitively) written by a block — mirrors the
    executor's loop-carry derivation (executor._sub_block_written)."""
    seen = set() if seen is None else seen
    if block.idx in seen:
        return set()
    seen.add(block.idx)
    written: Set[str] = set()
    for op in block.ops:
        written.update(op.output_vars())
        written.update(_attr_names(op, _ATTR_DEFINE_KEYS))
        for key in BLOCK_ATTR_KEYS:
            idx = op.attrs.get(key)
            if isinstance(idx, int) and 0 < idx < len(program.blocks):
                written |= _transitive_writes(program, program.blocks[idx], seen)
    return written


def verify_program(program, feed: Iterable[str] = (),
                   fetch: Iterable[str] = (),
                   diags: Optional[List[Diagnostic]] = None) -> List[Diagnostic]:
    """Run every structural check; returns the diagnostic list (never raises).

    ``feed`` — extra var names supplied by the caller at run time (actual
    feed dict keys); data vars are always assumed fed.  ``fetch`` — names the
    caller will fetch (checked to exist).
    """
    diags = [] if diags is None else diags
    blocks = program.blocks
    if not blocks:
        diags.append(Diagnostic("V004", Severity.ERROR,
                                "program has no blocks"))
        return diags
    for b in blocks:
        if b.parent_idx >= 0 and (b.parent_idx >= len(blocks)
                                  or b.parent_idx == b.idx):
            diags.append(Diagnostic(
                "V004", Severity.ERROR,
                f"block {b.idx} has invalid parent_idx {b.parent_idx}",
                block_idx=b.idx))
    root = blocks[0]
    defined: Set[str] = set(feed)
    _seed_block_vars(root, defined)
    _verify_ops(program, root, defined, {}, [], diags, visiting=(0,))
    for name in fetch:
        if name not in defined:
            diags.append(Diagnostic(
                "V006", Severity.ERROR,
                f"fetch of undefined variable '{name}'", block_idx=0,
                var=name,
                hint="fetch vars must be produced by an op, fed, or "
                     "persistable in the global block"))
    return diags


def _verify_ops(program, block, defined: Set[str],
                pending: Dict[str, int],
                outer_pendings: List[Dict[str, int]],
                diags: List[Diagnostic], visiting: Tuple[int, ...]):
    """Walk a block's ops in order.

    ``defined`` — names available at the current point (mutated in place).
    ``pending`` — name -> op idx of a write not yet read (duplicate-write
    detection); reads and sub-block activity clear entries.
    """
    from ..fluid.registry import OpRegistry

    for idx, op in enumerate(block.ops):
        site = dict(block_idx=block.idx, op_idx=idx, op_type=op.type)

        if not OpRegistry.has(op.type):
            diags.append(Diagnostic(
                "V002", Severity.ERROR,
                f"op type '{op.type}' is not registered in OpRegistry",
                hint="register a compute with OpRegistry.register"
                     f"('{op.type}') before building this program", **site))
            # still mark outputs defined so later ops don't cascade V001
            for n in op.output_vars():
                defined.add(n)
            continue

        # ---- reads (op.inputs + env-read attr names) --------------------
        reads = op.input_vars() + _attr_names(op, _ATTR_READ_KEYS)
        for n in reads:
            if n not in defined:
                hint = ("define it in this block or an enclosing one before "
                        "this op; vars declared only in a sibling branch "
                        "block are not in scope")
                diags.append(Diagnostic(
                    "V001", Severity.ERROR,
                    f"op reads undefined variable '{n}'",
                    var=n, hint=hint, **site))
            pending.pop(n, None)
            for p in outer_pendings:
                p.pop(n, None)

        # ---- sub-blocks -------------------------------------------------
        for key in BLOCK_ATTR_KEYS:
            if key not in op.attrs:
                continue
            sub_idx = op.attrs[key]
            if sub_idx is None:
                continue  # e.g. an else-less conditional_block
            if (not isinstance(sub_idx, int) or sub_idx <= 0
                    or sub_idx >= len(program.blocks)):
                diags.append(Diagnostic(
                    "V004", Severity.ERROR,
                    f"attr '{key}'={sub_idx!r} is not a valid sub-block "
                    f"index (program has {len(program.blocks)} blocks; "
                    "the global block cannot be a sub-block)", **site))
                continue
            if sub_idx in visiting:
                diags.append(Diagnostic(
                    "V004", Severity.ERROR,
                    f"attr '{key}'={sub_idx} creates a block cycle "
                    f"(path {' -> '.join(map(str, visiting))} -> {sub_idx})",
                    **site))
                continue
            sub = program.blocks[sub_idx]
            if sub.parent_idx != block.idx:
                diags.append(Diagnostic(
                    "V007", Severity.WARNING,
                    f"sub-block {sub_idx} declares parent {sub.parent_idx} "
                    f"but its op lives in block {block.idx} "
                    "(parent-scope lookup may resolve the wrong vars)",
                    **site))
            sub_defined = set(defined)
            for n in _attr_names(op, _ATTR_BIND_KEYS):
                sub_defined.add(n)
            _seed_block_vars(sub, sub_defined)
            _verify_ops(program, sub, sub_defined, {},
                        outer_pendings + [pending], diags,
                        visiting + (sub_idx,))

        # ---- while: the condition must be updated in the body -----------
        if op.type == "while":
            cond = (op.inputs.get("Condition") or [None])[0]
            sub_idx = op.attrs.get("sub_block_idx")
            if (cond is not None and isinstance(sub_idx, int)
                    and 0 < sub_idx < len(program.blocks)
                    and sub_idx not in visiting):
                body_writes = _transitive_writes(
                    program, program.blocks[sub_idx])
                if cond not in body_writes:
                    diags.append(Diagnostic(
                        "V005", Severity.ERROR,
                        f"while condition '{cond}' is never updated in the "
                        "loop body (would loop forever)",
                        var=cond,
                        hint="write it inside the body, e.g. "
                             "less_than(i, n, cond=cond)", **site))

        # ---- writes -----------------------------------------------------
        seen_out: Set[str] = set()
        for n in op.output_vars():
            if n in seen_out:
                diags.append(Diagnostic(
                    "V003", Severity.ERROR,
                    f"op lists output variable '{n}' twice",
                    var=n, **site))
                continue
            seen_out.add(n)
            if n in pending:
                diags.append(Diagnostic(
                    "V003", Severity.ERROR,
                    f"duplicate write to '{n}': op #{pending[n]} in this "
                    "block already wrote it and no op read it in between "
                    "(the first write is lost)",
                    var=n,
                    hint="write to a fresh var, or read the first result "
                         "before overwriting", **site))
        for n in seen_out:
            defined.add(n)
            pending[n] = idx
            for p in outer_pendings:
                p.pop(n, None)
        for n in _attr_names(op, _ATTR_DEFINE_KEYS):
            defined.add(n)
