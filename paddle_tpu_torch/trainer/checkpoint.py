"""Checkpoint / resume — the counterpart of
``paddle_tpu/trainer/checkpoint.py``, writing and reading the same files
byte for byte.

* per-pass directories ``output/pass-%05d``;
* tar parameter archives: one ``.npy`` member per tree path (``np.save``
  of the leaf's host copy) and a JSON ``__meta__.json`` member with the
  format version, a CRC32 a member, the member order and the container
  structure (``core.pytree.tree_spec``);
* crash safety: a pass is written as ``pass-%05d.tmp`` (every member
  fsynced, a ``_COMPLETE`` manifest of CRC32 and size a member written
  last), then renamed into place; a torn re-publish swap is rolled
  forward or back; :func:`load_checkpoint` falls back to the newest pass
  that verifies.

**bf16.** numpy has no bfloat16. JAX's leaves are ml_dtypes bf16 arrays,
which ``np.save`` writes with ``descr '<V2'`` (2-byte raw words). The
port writes a bf16 tensor the same way (the header ``np.save`` writes for
such a leaf, then its raw 2-byte words), so the files are identical; on
load a 2-byte void member (``'<V2'`` or ``'|V2'``) becomes a bf16 tensor.
Only ml_dtypes' bf16 saves as ``V2`` (float16 saves as ``'<f2'``), so
the mapping is unambiguous. JAX's own ``from_tar`` gives such a leaf back
as a raw ``|V2`` void array, not as bf16 (ROADMAP C.3).

Loads put the leaves on ``device`` (default: the card). The ``ckpt.*``
spans and counters and the ``ckpt.write`` fault hook of the JAX module
wait for the obs session plane and the fault injector (ROADMAP A.8).
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import tarfile
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.place import DeviceLike, require_device
from ..core.pytree import flatten_path_tree, tree_spec, unflatten_path_tree
from ..utils.logging import get_logger

log = get_logger(__name__)

FORMAT_VERSION = 1
_META = "__meta__.json"
#: completion manifest filename — a pass dir without it is not a checkpoint
COMPLETE_MANIFEST = "_COMPLETE"


def _host(leaf) -> np.ndarray:
    """A leaf's host copy: a bf16 tensor as its raw 2-byte words viewed as
    ``V2``, any other tensor as its numpy array, anything else through
    ``np.asarray`` (as JAX's ``np.asarray(jax.device_get(leaf))``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in flatten_path_tree(tree)}


def _npy(arr: np.ndarray) -> bytes:
    """The bytes ``np.save`` writes; a ``V2`` (bf16) leaf with the header
    ``np.save`` writes for an ml_dtypes bf16 array (``descr '<V2'``)."""
    buf = io.BytesIO()
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<V2", "fortran_order": False,
                  "shape": arr.shape})
        buf.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(buf, arr)
    return buf.getvalue()


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A loaded member as a tensor on ``device``: a 2-byte void array
    (bf16 words) as bf16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


# -- tar serialization ----------------------------------------------------------

def to_tar(f, params) -> None:
    """Serialize a tree (nested dicts, lists and tuples of tensors or
    arrays) into an open binary file object, as JAX's ``to_tar``."""
    flat = _flatten(params)
    # Container structure (incl. empty dicts/lists and tuple-ness) travels in
    # meta so from_tar restores the exact pytree — an SGD state whose per-param
    # slots are {} must round-trip, not collapse to {'step': ...} (ADVICE r1).
    meta = {"version": FORMAT_VERSION, "crc32": {}, "order": list(flat),
            "structure": tree_spec(params)}
    with tarfile.open(fileobj=f, mode="w") as tar:
        for path, arr in flat.items():
            payload = _npy(arr)
            meta["crc32"][path] = zlib.crc32(payload) & 0xFFFFFFFF
            info = tarfile.TarInfo(name=path.replace("/", "%2F") + ".npy")
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
        mb = json.dumps(meta).encode()
        info = tarfile.TarInfo(name=_META)
        info.size = len(mb)
        tar.addfile(info, io.BytesIO(mb))


def from_tar(f, device: DeviceLike = None):
    """Load a tree of tensors on ``device`` (default: the card); verifies
    the version and every member's CRC."""
    device = require_device(device)
    with tarfile.open(fileobj=f, mode="r") as tar:
        meta_m = tar.extractfile(_META)
        if meta_m is None:
            raise ValueError("checkpoint missing metadata member")
        meta = json.loads(meta_m.read().decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
        flat = {}
        for member in tar.getmembers():
            if member.name == _META:
                continue
            path = member.name[:-len(".npy")].replace("%2F", "/")
            payload = tar.extractfile(member).read()
            want = meta["crc32"].get(path)
            got = zlib.crc32(payload) & 0xFFFFFFFF
            if want is not None and got != want:
                raise ValueError(f"CRC mismatch for {path}: {got} != {want}")
            flat[path] = _tensor(np.load(io.BytesIO(payload),
                                         allow_pickle=False), device)
    return unflatten_path_tree(flat, spec=meta.get("structure"))


# -- pass directories -----------------------------------------------------------

def pass_dir(output_dir: str, pass_id: int) -> str:
    """output/pass-%05d naming (ParamUtil.cpp:56)."""
    return os.path.join(output_dir, f"pass-{pass_id:05d}")


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Durability of a rename/create requires fsyncing the containing dir;
    best-effort on filesystems that refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_member(d: str, name: str, payload: bytes) -> Dict[str, int]:
    """Write one checkpoint member, fsynced; returns its manifest entry."""
    entry = {"crc32": zlib.crc32(payload) & 0xFFFFFFFF, "size": len(payload)}
    with open(os.path.join(d, name), "wb") as f:
        f.write(payload)
        _fsync_file(f)
    return entry


def _recover_torn_swap(output_dir: str) -> None:
    """Finish or roll back a pass publication interrupted mid-swap.

    Re-publishing an existing pass moves it aside (``.old``) before renaming
    the ``.tmp`` into place; a crash between those renames leaves the pass
    visible only under suffixed names. Recovery, for each pass whose final
    dir is missing: a ``.tmp`` that carries a *verified* manifest was
    complete — roll it forward; otherwise an ``.old`` is restored. A ``.tmp``
    without a valid manifest is an ordinary torn write and stays ignored.
    Idempotent; called before every discovery scan and publication.
    """
    if not os.path.isdir(output_dir):
        return
    suffixed: Dict[str, Dict[str, str]] = {}
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"(pass-\d{5})\.(old|tmp)", name)
        if m:
            suffixed.setdefault(m.group(1), {})[m.group(2)] = \
                os.path.join(output_dir, name)
    mutated = False
    for base, found in suffixed.items():
        d = os.path.join(output_dir, base)
        try:
            if os.path.exists(d):
                # published pass present: an .old is post-publish garbage
                # from a crash before its rmtree — reclaim it (a .tmp is
                # left to the writer path, which owns the mid-write
                # lifecycle)
                if "old" in found:
                    shutil.rmtree(found["old"], ignore_errors=True)
                    mutated = True
                continue
            tmp, old = found.get("tmp"), found.get("old")
            if tmp is not None and verify_checkpoint(tmp):
                os.rename(tmp, d)
                mutated = True
                log.warning("recovered torn swap: published %s", d)
                if old is not None:
                    shutil.rmtree(old, ignore_errors=True)
            elif old is not None:
                os.rename(old, d)
                mutated = True
                log.warning("recovered torn swap: restored %s", d)
        except OSError as e:
            # lost a race with the writer's own swap, or a read-only
            # mount: discovery must degrade to a pure read, not crash
            log.warning("torn-swap recovery for %s skipped: %s", base, e)
    if mutated:       # keep discovery a pure read in the common case
        _fsync_dir(output_dir)


def publish_members(output_dir: str, pass_id: int,
                    members: Iterable[Tuple[str, bytes]]) -> str:
    """Atomically publish ``output_dir/pass-%05d`` from (name, payload) pairs.

    Write order (each step durable before the next): members into a ``.tmp``
    dir -> ``_COMPLETE`` manifest (per-member CRC32 + size) -> fsync dir ->
    rename to the final name -> fsync parent. A crash anywhere before the
    rename leaves only a ``.tmp`` dir :func:`latest_pass` ignores; a crash
    inside the re-publish swap is healed by :func:`_recover_torn_swap`.
    ``members`` is consumed lazily — one payload in host memory at a time.

    """
    _recover_torn_swap(output_dir)
    d = pass_dir(output_dir, pass_id)
    tmp = d + ".tmp"
    if os.path.exists(tmp):            # leftover from a crashed writer
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"version": FORMAT_VERSION, "pass_id": pass_id, "members": {}}
    for name, payload in members:
        manifest["members"][name] = _write_member(tmp, name, payload)
    with open(os.path.join(tmp, COMPLETE_MANIFEST), "w") as f:
        json.dump(manifest, f)
        _fsync_file(f)
    _fsync_dir(tmp)

    try:
        if os.path.exists(d):
            # re-saving a pass (e.g. completing one previously
            # preempted): move the old dir aside so the rename stays
            # atomic, then drop it
            old = d + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(d, old)
            os.rename(tmp, d)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, d)
    except FileNotFoundError:
        # a concurrent discovery scan's torn-swap recovery can publish our
        # .tmp itself; depending on the interleaving our bytes sit at the
        # final name (scanner won the rename race) or were just moved
        # aside as .old (scanner published BEFORE our exists-check, so we
        # renamed our own fresh dir away). Either way the intended state
        # exists — restore it and succeed rather than crash the save.
        old = d + ".old"
        if not verify_checkpoint(d):
            if os.path.exists(old) and verify_checkpoint(old):
                os.rename(old, d)
            else:
                raise
        else:
            shutil.rmtree(old, ignore_errors=True)
    _fsync_dir(output_dir)
    return d


def save_checkpoint(output_dir: str, pass_id: int, params,
                    opt_state=None, extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically publish ``output_dir/pass-%05d`` (protocol:
    :func:`publish_members`)."""

    def members():
        buf = io.BytesIO()
        to_tar(buf, params)
        yield "params.tar", buf.getvalue()
        if opt_state is not None:
            buf = io.BytesIO()
            to_tar(buf, opt_state)
            yield "opt_state.tar", buf.getvalue()
        state = {"pass_id": pass_id, "version": FORMAT_VERSION,
                 "pass_complete": True}
        if extra:
            state.update(extra)
        yield "state.json", json.dumps(state).encode()

    return publish_members(output_dir, pass_id, members())


def verify_checkpoint(d: str) -> bool:
    """True iff ``d`` has a ``_COMPLETE`` manifest and every member matches
    its recorded size and CRC32 — the resume-safety gate. Members are
    CRC'd in fixed-size chunks: verification of a multi-GB checkpoint must
    not spike host memory by the largest member."""
    try:
        with open(os.path.join(d, COMPLETE_MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("version") != FORMAT_VERSION:
            return False
        for name, entry in manifest["members"].items():
            crc, size = 0, 0
            with open(os.path.join(d, name), "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    size += len(chunk)
                    crc = zlib.crc32(chunk, crc)
            if size != entry["size"] or (crc & 0xFFFFFFFF) != entry["crc32"]:
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def _complete_passes(output_dir: str) -> List[int]:
    """pass ids carrying a ``_COMPLETE`` manifest, ascending."""
    if not os.path.isdir(output_dir):
        return []
    _recover_torn_swap(output_dir)
    out, legacy = [], []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"pass-(\d{5})", name)
        if not m:
            continue
        if os.path.exists(os.path.join(output_dir, name, COMPLETE_MANIFEST)):
            out.append(int(m.group(1)))
        elif os.path.exists(os.path.join(output_dir, name, "params.tar")):
            legacy.append(name)
    if legacy and not out:
        # an upgraded job pointed at a pre-manifest output_dir: those dirs
        # are indistinguishable from torn writes, so resume ignores them —
        # say so LOUDLY, because the first new save of the same pass id
        # will replace them
        log.warning(
            "%s holds %d pass dir(s) without a %s manifest (%s …): "
            "written before crash-safe checkpointing or torn mid-write; "
            "they are ignored for resume and will be replaced when their "
            "pass id is saved again", output_dir, len(legacy),
            COMPLETE_MANIFEST, sorted(legacy)[-1])
    return sorted(out)


def _load_dir(d: str, device: torch.device
              ) -> Tuple[Any, Optional[Any], Dict[str, Any]]:
    with open(os.path.join(d, "params.tar"), "rb") as f:
        params = from_tar(f, device)
    opt_state = None
    op = os.path.join(d, "opt_state.tar")
    if os.path.exists(op):
        with open(op, "rb") as f:
            opt_state = from_tar(f, device)
    with open(os.path.join(d, "state.json")) as f:
        state = json.load(f)
    return params, opt_state, state


def load_checkpoint(output_dir: str, pass_id: Optional[int] = None, *,
                    device: DeviceLike = None
                    ) -> Tuple[Any, Optional[Any], Dict[str, Any]]:
    """Load (params, opt_state_or_None, state), the trees' leaves as
    tensors on ``device`` (default: the card). pass_id None -> the newest
    pass that passes full manifest verification: an unverifiable latest pass
    (torn write that survived the crash window, later bit rot) is skipped
    with a warning and the previous good pass is used instead. An explicit
    pass_id is gated by the same verification — it names a pass, not an
    escape hatch around the safety contract."""
    device = require_device(device)
    if pass_id is not None:
        d = pass_dir(output_dir, pass_id)
        if not verify_checkpoint(d):
            raise ValueError(
                f"checkpoint {d} fails manifest/CRC verification")
        return _load_dir(d, device)
    candidates = _complete_passes(output_dir)
    for pid in reversed(candidates):
        d = pass_dir(output_dir, pid)
        if not verify_checkpoint(d):
            log.warning("checkpoint %s fails CRC/manifest verification; "
                        "falling back to the previous pass", d)
            continue
        try:
            return _load_dir(d, device)
        except (OSError, ValueError) as e:
            log.warning("checkpoint %s unreadable (%s); falling back", d, e)
    raise FileNotFoundError(f"no verifiable checkpoints under {output_dir}")


def latest_pass(output_dir: str, *, verify: bool = False) -> Optional[int]:
    """Largest pass-%05d carrying a ``_COMPLETE`` manifest (resume point —
    the --start_pass discovery, ParamUtil.h:108-111). Mere existence of
    ``params.tar`` is NOT enough: a dir without the manifest is a torn
    write. ``verify=True`` additionally demands CRC validation."""
    candidates = _complete_passes(output_dir)
    for pid in reversed(candidates):
        if not verify or verify_checkpoint(pass_dir(output_dir, pid)):
            return pid
    return None
