"""The autotune cache — measured plan winners, persisted and versioned; a
copy of ``paddle_tpu/tune/cache.py`` with the port's own file.

One JSON file holds every tuned decision: ``{schema_version, entries}``
where each entry is keyed ``space|kernel|device_kind|family`` and carries
the winning ``plan``, the ``space_hash`` of the plan space that produced
it, and the measurement evidence (``tuned_ms`` / ``heuristic_ms`` /
``methodology="measured"``). The routing entries
(``ops.rnn_kernels.route_for``, ``ops.cuda_kernels.decode_splits``,
``serving.paged.PagePool``, ``data.feeder.BucketSpec``, the fluid
executor's fusion plan) consult the loaded cache first and fall back to
their heuristics on any miss, so a deleted, corrupt or stale cache
degrades to exactly the untuned behaviour.

Staleness contract, as in JAX:

* ``schema_version`` mismatch -> the whole file is ignored (warn once).
* per-entry ``space_hash`` != the current plan space's hash -> that entry
  is ignored at consult time, and L008 (``analysis.lint_autotune_cache``)
  reports it.
* entries whose plan fails the target's legality check (residency on the
  card, divisibility) are ignored at consult time — a cache written on one
  machine cannot produce an illegal kernel launch on another.

Separation from JAX's cache: the port reads its own file,
``$PADDLE_TPU_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.paddle_tpu_torch/autotune.json``, and every space of the port hashes
apart from JAX's (tune/spaces.py ``TARGET``), so an entry JAX's tuner
wrote is stale here even in a file the port is pointed at.
``PADDLE_TPU_TORCH_AUTOTUNE=0`` disables consultation (heuristics only;
the tuner still writes).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import warnings
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1
CACHE_ENV = "PADDLE_TPU_TORCH_AUTOTUNE_CACHE"
DISABLE_ENV = "PADDLE_TPU_TORCH_AUTOTUNE"


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".paddle_tpu_torch",
                        "autotune.json")


def _entry_key(space: str, kernel: str, device_kind: str,
               family: str) -> str:
    return "|".join((space, kernel, device_kind, family))


class AutotuneCache:
    """In-memory view of one autotune file. Entries are plain dicts so the
    JSON round trip is the identity; :meth:`put`/:meth:`get` own the key
    convention."""

    def __init__(self, entries: Optional[Dict[str, Dict[str, Any]]] = None,
                 schema_version: int = SCHEMA_VERSION):
        self.schema_version = schema_version
        self.entries: Dict[str, Dict[str, Any]] = dict(entries or {})

    def put(self, space: str, kernel: str, device_kind: str, family: str,
            plan: Any, space_hash: str, **meta) -> Dict[str, Any]:
        entry = {"space": space, "kernel": kernel,
                 "device_kind": device_kind, "family": family,
                 "plan": plan, "space_hash": space_hash}
        entry.update(meta)
        self.entries[_entry_key(space, kernel, device_kind, family)] = entry
        return entry

    def get(self, space: str, kernel: str, device_kind: str,
            family: str) -> Optional[Dict[str, Any]]:
        return self.entries.get(_entry_key(space, kernel, device_kind,
                                           family))

    def to_dict(self) -> Dict[str, Any]:
        return {"schema_version": self.schema_version,
                "entries": self.entries}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AutotuneCache":
        if not isinstance(data, dict) or "entries" not in data:
            raise ValueError("autotune cache must be a dict with 'entries'")
        version = data.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"autotune cache schema_version {version!r} != supported "
                f"{SCHEMA_VERSION}; re-run tune.run_tune")
        entries = data["entries"]
        if not isinstance(entries, dict):
            raise ValueError("autotune cache 'entries' must be a dict")
        return cls(entries={k: v for k, v in entries.items()
                            if isinstance(v, dict)}, schema_version=version)

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write (tmp + rename): a crashed tune run never leaves a
        torn file behind for the next process to trip on."""
        path = path or default_cache_path()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


def load_cache(path: Optional[str] = None) -> AutotuneCache:
    """Load (and schema-validate) a cache file; raises OSError /
    ValueError — callers on the consult path go through :func:`get_cache`
    which demotes failures to a once-per-process warning."""
    path = path or default_cache_path()
    with open(path) as f:
        return AutotuneCache.from_dict(json.load(f))


# -- the consult-path singleton ------------------------------------------------
# Loaded lazily on first lookup and cached (including the negative "no
# file" result): the routing entries consult from trace-time hot paths,
# so a consult is a dict get, never filesystem traffic.

_UNSET = object()
_active: Any = _UNSET
_load_lock = threading.Lock()
_warned_load = False


def _disabled() -> bool:
    return os.environ.get(DISABLE_ENV, "").strip() in ("0", "off", "false")


def get_cache() -> Optional[AutotuneCache]:
    """The process's active autotune cache, or None (disabled / no file /
    unreadable file — the heuristics then own every decision)."""
    global _active, _warned_load
    if _active is not _UNSET:
        return _active
    with _load_lock:
        if _active is not _UNSET:
            return _active
        if _disabled():
            _active = None
            return None
        path = default_cache_path()
        if not os.path.exists(path):
            _active = None
            return None
        try:
            _active = load_cache(path)
        except (OSError, ValueError) as e:
            _active = None
            if not _warned_load:
                _warned_load = True
                warnings.warn(
                    f"ignoring unreadable autotune cache {path!r}: {e} "
                    "(heuristic plans apply; re-run tune.run_tune)",
                    RuntimeWarning, stacklevel=2)
    return _active


def set_cache(cache: Optional[AutotuneCache]) -> None:
    """Install ``cache`` as the active consult target (tests, embedders).
    Pass None to force the no-cache/heuristic state without touching env."""
    global _active
    _active = cache


def reset() -> None:
    """Forget the loaded cache so the next consult re-resolves from disk —
    call after changing $PADDLE_TPU_TORCH_AUTOTUNE_CACHE or writing a new
    file."""
    global _active
    _active = _UNSET
