"""Diagnostic model for the static verifier / linter (analysis subpackage).

Every finding — structural error, shape mismatch, lint — is one
:class:`Diagnostic` carrying a stable code, a severity, the op's location
(block idx + op idx + op type) and a fix hint.  The location string format
``block B, op #I (type)`` is shared verbatim with the executor's trace-time
error notes (fluid/executor.py:_run_ops) so a static diagnostic and the
runtime failure for the same op cite the same site.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


class Severity(enum.IntEnum):
    """Ordered so ``severity >= Severity.WARNING`` style filters work."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name.lower()


def op_site(block_idx: Optional[int], op_idx: Optional[int],
            op_type: Optional[str],
            block_path: Optional[str] = None) -> str:
    """Canonical location string — keep in sync with executor._trace_ops.

    ``block_path`` cites the full parent chain for nested sub-blocks
    (``block 0.2, op #5``); the root block's path is ``"0"``, so root
    sites keep the historical ``block 0, op #I`` form verbatim."""
    if block_idx is None:
        return "program"
    label = block_path if block_path else block_idx
    if op_idx is None:
        return f"block {label}"
    t = f" ({op_type})" if op_type else ""
    return f"block {label}, op #{op_idx}{t}"


def block_paths(program) -> Dict[int, str]:
    """Root-to-leaf parent-chain path per block: ``{0: "0", 2: "0.2",
    5: "0.2.5"}``.  Defensive against malformed parent indices (cycles,
    out-of-range) — the verifier reports those; this must not crash."""
    blocks = getattr(program, "blocks", None) or []
    out: Dict[int, str] = {}
    for b in blocks:
        chain = []
        idx = b.idx
        guard = len(blocks) + 1
        while (isinstance(idx, int) and 0 <= idx < len(blocks)
               and idx not in chain and guard):
            guard -= 1
            chain.append(idx)
            p = blocks[idx].parent_idx
            if not isinstance(p, int) or p < 0:
                break
            idx = p
        out[b.idx] = ".".join(str(i) for i in reversed(chain))
    return out


@dataclass
class Diagnostic:
    """One verifier/linter finding.

    ``code`` is stable across releases (``V0xx`` structural, ``S0xx`` shape,
    ``L0xx`` lint) so tooling can filter/suppress by id.
    """

    code: str
    severity: Severity
    message: str
    block_idx: Optional[int] = None
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    hint: Optional[str] = None
    # which program the finding is in ("main"/"startup") when several are
    # analyzed together, e.g. by the lint CLI; block/op indices alone are
    # ambiguous across programs
    program: Optional[str] = None
    # full parent-chain path for nested sub-blocks ("0.2.5"); filled by
    # analyze_program from block_paths() so every pass cites it for free
    block_path: Optional[str] = None
    # def-use chain text for the var (`lint --explain`); None unless the
    # caller asked for explanations
    explain: Optional[str] = None

    def location(self) -> str:
        site = op_site(self.block_idx, self.op_idx, self.op_type,
                       block_path=self.block_path)
        return f"[{self.program}] {site}" if self.program else site

    def __str__(self):
        parts = [f"{self.severity}", f"[{self.code}]", self.location() + ":",
                 self.message]
        s = " ".join(parts)
        if self.hint:
            s += f"\n    hint: {self.hint}"
        if self.explain:
            s += f"\n    chain: {self.explain}"
        return s

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": str(self.severity),
                "message": self.message, "block_idx": self.block_idx,
                "op_idx": self.op_idx, "op_type": self.op_type,
                "var": self.var, "hint": self.hint, "program": self.program,
                "block_path": self.block_path, "explain": self.explain}


def errors(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity >= Severity.ERROR]


def max_severity(diags: Sequence[Diagnostic]) -> Optional[Severity]:
    return max((d.severity for d in diags), default=None)


def format_diagnostics(diags: Sequence[Diagnostic]) -> str:
    if not diags:
        return "no diagnostics"
    return "\n".join(str(d) for d in diags)


class ProgramVerificationError(ValueError):
    """Raised by ``Executor.run(verify=True)`` / ``check_or_raise`` when a
    program has error-severity diagnostics.  ``.diagnostics`` holds the full
    list (warnings included) for tooling."""

    def __init__(self, diags: Sequence[Diagnostic]):
        self.diagnostics = list(diags)
        errs = errors(diags)
        super().__init__(
            f"program verification failed with {len(errs)} error(s):\n"
            + format_diagnostics(errs))
