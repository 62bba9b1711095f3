"""Wire trace context — the cross-process half of distributed tracing.

One training job is many processes (trainer workers, the master, the coord
server); a span tracer (:mod:`paddle_tpu_torch.obs.trace`) only sees its own. The
context defined here is what crosses the wire: every RPC request envelope
carries a ``"trace"`` key

    {"id": "<hex trace id>", "span": <client span id>, "pid": <client pid>}

attached by :meth:`_RpcClient._call` from inside its live ``rpc.call`` span,
and the serving side (``MasterServer._dispatch`` / ``CoordServer``) opens
its handler span with that context recorded as ``remote``. When the
per-process dumps are merged (:func:`paddle_tpu_torch.obs.export.merge_dumps`)
the ``remote`` field is the cross-process parent edge: the Chrome exporter
turns it into flow arrows from the client's ``rpc.call`` slice to the
server's dispatch slice, and tests assert the parenting directly.

The format is a **public contract** (the JAX package's observability design notes
"Distributed tracing"): the key names above and the sanitation limits in
:func:`sanitize` are what foreign emitters must produce.

Trace id: every process in one job should share it so a stitched timeline
is self-identifying. It is inherited from ``PADDLE_TPU_TRACE_ID`` when the
launcher exports one (``cluster_train`` and the test harness do), otherwise
minted per process — the ``remote`` edges still stitch either way, since
they key on (pid, span id).
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, Optional

#: env var a launcher sets so every process of one job shares a trace id
TRACE_ID_ENV = "PADDLE_TPU_TRACE_ID"

_MAX_ID_LEN = 64

_trace_id: Optional[str] = None


def trace_id() -> str:
    """This process's trace id: inherited from the launcher's env var, or
    minted once and cached. A forked child inherits the cached value —
    one job, one trace, which is what the stitched view wants (per-process
    identity lives in (pid, span id), not the trace id).
    """
    global _trace_id
    if _trace_id is None:
        _trace_id = os.environ.get(TRACE_ID_ENV) or uuid.uuid4().hex[:16]
    return _trace_id


def wire_context(span) -> Optional[Dict[str, Any]]:
    """The envelope dict for a request issued inside ``span``; None when
    the span is the shared NULL_SPAN (no session installed) — the wire
    format then stays byte-identical to the un-instrumented one."""
    sid = getattr(span, "id", None)
    if sid is None:
        return None
    return {"id": trace_id(), "span": int(sid), "pid": os.getpid()}


def sanitize(ctx) -> Optional[Dict[str, Any]]:
    """Validate a context received off the wire.

    Servers parse frames from arbitrary peers: a malformed or hostile
    ``trace`` value must degrade to "no context", never corrupt the trace
    or raise out of a handler. Returns a clean copy or None.
    """
    if not isinstance(ctx, dict):
        return None
    try:
        tid = str(ctx["id"])[:_MAX_ID_LEN]
        span = int(ctx["span"])
        pid = int(ctx["pid"])
    except (KeyError, TypeError, ValueError):
        return None
    if span < 0 or pid < 0:
        return None
    return {"id": tid, "span": span, "pid": pid}
