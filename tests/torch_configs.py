"""Config scripts of the JAX package rewritten for the port: the same
file with ``paddle_tpu`` replaced by ``paddle_tpu_torch`` in its import
lines, and in nothing else (``rewrite_text`` checks that every other
line came through unchanged). torch only: no jax, nothing of
``paddle_tpu``."""

import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: an import statement's head naming the JAX package (not the port)
_IMPORT = re.compile(r"^(\s*(?:import|from)\s+)paddle_tpu(?!_torch)\b")


def rewrite_text(text: str) -> str:
    """``text`` with each ``import paddle_tpu...`` / ``from paddle_tpu...``
    line naming ``paddle_tpu_torch`` instead."""
    src = text.splitlines(keepends=True)
    out = [_IMPORT.sub(r"\1paddle_tpu_torch", line) for line in src]
    for a, b in zip(src, out):
        if a != b:
            assert _IMPORT.match(a) and b == _IMPORT.sub(
                r"\1paddle_tpu_torch", a), (a, b)
    changed = [b for a, b in zip(src, out) if a != b]
    assert all(b.lstrip().startswith(("import paddle_tpu_torch",
                                      "from paddle_tpu_torch"))
               for b in changed), changed
    return "".join(out)


def rewrite(path: str, dest_dir: str) -> str:
    """Write the port's copy of the config at ``path`` (relative to the
    repository or absolute) into ``dest_dir``; returns its path."""
    src = path if os.path.isabs(path) else os.path.join(ROOT, path)
    with open(src) as f:
        text = rewrite_text(f.read())
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(str(dest_dir), os.path.basename(src))
    with open(dest, "w") as f:
        f.write(text)
    return dest
