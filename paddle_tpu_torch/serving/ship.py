"""KV-page shipping — the disaggregation wire format (prefill → decode), a
counterpart of ``paddle_tpu/serving/ship.py`` whose manifests and payloads
are JAX's byte for byte for the same rows.

A prefill worker admits a prompt into its own :class:`~.paged.PagePool`
(first token emitted), then ships the slot's page contents to a decode
worker where the request finishes its life. This module owns the
serialization contract both ends agree on:

* :func:`pack` — the slot's per-layer ``k{i}``/``v{i}`` page rows (and the
  int8 ``*_scale`` planes when the pool is quantized) concatenate into one
  payload in sorted-name order, described by a manifest carrying every
  array's name/shape/dtype, the pool geometry (``page_block``,
  ``kv_dtype``), the request state (``plen``, ``first``) and a CRC32 over
  the whole payload.
* :func:`unpack` — the decode side re-slices the payload against the
  manifest as CPU tensors, refusing structurally (``ShipError``) on a CRC
  mismatch, a short/long payload, or a malformed manifest — a damaged
  shipment is never adopted into a live pool.
* chunking — payloads can exceed the RPC frame guard
  (``runtime.master_service._MAX_FRAME``), so they travel as numbered
  chunks (:func:`iter_chunks` / :class:`ChunkAssembler`), each base64-clean
  for the JSON frame protocol and carrying its OWN CRC32: one corrupted
  chunk is refused on arrival instead of poisoning the reassembly.

bf16. JAX writes a bf16 array's dtype as ``"bfloat16"`` (ml_dtypes' name)
and its raw 2-byte words. numpy has no bfloat16 of its own, so the port
writes a ``torch.bfloat16`` tensor's words under that name and
:func:`unpack` views them as ``torch.bfloat16`` again: the bytes cross in
both directions unchanged.

Chaos: the ``srv.ship`` fault site filters every raw chunk on the send
edge AFTER its CRC was stamped — an injected corrupt/truncate produces
exactly the damage the receiver-side CRC exists to catch, and the refusal
path (not silent adoption) is what tests/test_torch_ship.py pins. Each
chunk counts into ``serving.ship_chunks_total`` and
``serving.ship_chunk_bytes_total``, as in JAX.

Bit-exactness is the whole point: the decode worker's pool rows after
adoption are byte-identical to the prefill worker's, so wire-greedy tokens
across the process boundary equal solo single-engine decode for bf16/f32
AND int8 KV.
"""

from __future__ import annotations

import base64
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import faults, obs

#: raw bytes per shipped chunk. Base64 inflates by 4/3 and the JSON frame
#: adds envelope overhead, so 4 MiB raw stays far under the 64 MiB frame
#: guard while keeping chunk counts small for realistic page loads.
CHUNK_BYTES = 4 << 20

#: wire-format version stamped into every manifest; a receiver refuses a
#: version it does not speak instead of misreading the payload layout
SHIP_VERSION = 1


#: the wire's dtype names of the tensors a pool holds (numpy's names, and
#: ml_dtypes' "bfloat16")
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.int32: "int32", torch.int64: "int64"}
_FROM_WIRE = {name: dt for dt, name in _WIRE_DTYPES.items()}


def _raw(a: torch.Tensor) -> Tuple[str, bytes, tuple]:
    """(wire dtype name, raw bytes, shape) of a tensor."""
    t = a.detach().to("cpu").contiguous()
    if t.dtype not in _WIRE_DTYPES:
        raise ValueError(f"cannot ship dtype {t.dtype}")
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return _WIRE_DTYPES[t.dtype], words.numpy().tobytes(), tuple(t.shape)


class ShipError(ValueError):
    """A shipment that must not be adopted: CRC mismatch, short payload,
    malformed manifest, or pool-geometry disagreement. Maps to the
    structured ``code="data_loss"`` refusal on the wire."""


def pack(arrays: Dict[str, torch.Tensor], *, plen: int, first: int,
         page_block: int, kv_dtype: Optional[str]) -> Tuple[dict, bytes]:
    """Serialize a slot's page arrays into ``(manifest, payload)``.

    ``arrays`` maps pool-array names (``k0``, ``v0``, ``k0_scale``, ...)
    to the slot's gathered page rows ``[n_pages, page_block, ...]``; the
    payload is their raw bytes concatenated in sorted-name order (the
    order the manifest's ``entries`` list records)."""
    entries: List[dict] = []
    parts: List[bytes] = []
    for name in sorted(arrays):
        dtype, raw, shape = _raw(arrays[name])
        entries.append({"name": name, "shape": list(shape),
                        "dtype": dtype, "nbytes": len(raw)})
        parts.append(raw)
    payload = b"".join(parts)
    manifest = {"version": SHIP_VERSION, "plen": int(plen),
                "first": int(first), "page_block": int(page_block),
                "kv_dtype": kv_dtype or "",
                "entries": entries, "nbytes": len(payload),
                "crc": zlib.crc32(payload) & 0xFFFFFFFF}
    return manifest, payload


def unpack(manifest: dict, payload: bytes) -> Dict[str, torch.Tensor]:
    """Verify + deserialize a shipment into CPU tensors (over a copy of
    the payload's bytes); raises :class:`ShipError` rather than ever
    returning damaged arrays."""
    if not isinstance(manifest, dict) or \
            manifest.get("version") != SHIP_VERSION:
        raise ShipError(f"unsupported ship manifest version "
                        f"{manifest.get('version') if isinstance(manifest, dict) else manifest!r} "
                        f"(this end speaks {SHIP_VERSION})")
    entries = manifest.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ShipError("ship manifest carries no payload entries")
    declared = int(manifest.get("nbytes", -1))
    if declared != len(payload):
        raise ShipError(f"ship payload is {len(payload)} bytes but the "
                        f"manifest declares {declared} — a chunk was lost "
                        "or truncated in flight")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(manifest.get("crc", -1)):
        raise ShipError(f"ship payload CRC {crc:#010x} != manifest "
                        f"{int(manifest.get('crc', -1)):#010x} — refusing "
                        "to adopt corrupted pages")
    out: Dict[str, torch.Tensor] = {}
    off = 0
    buf = bytearray(payload)          # writable: the tensors view it
    for e in entries:
        try:
            name = str(e["name"])
            shape = tuple(int(d) for d in e["shape"])
            dtype = _FROM_WIRE[str(e["dtype"])]
            nbytes = int(e["nbytes"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ShipError(f"malformed ship manifest entry {e!r}") from exc
        itemsize = torch.empty((), dtype=dtype).element_size()
        if nbytes != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ShipError(f"entry {name!r}: nbytes {nbytes} disagrees "
                            f"with shape {shape} x dtype {dtype}")
        if off + nbytes > len(payload):
            raise ShipError(f"entry {name!r} overruns the payload")
        flat = (torch.frombuffer(buf, dtype=dtype, count=nbytes // itemsize,
                                 offset=off) if nbytes
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(shape)
        off += nbytes
    if off != len(payload):
        raise ShipError(f"{len(payload) - off} trailing payload bytes not "
                        "described by the manifest")
    return out


# -- chunking (the frame-guard discipline) ----------------------------------

def iter_chunks(payload: bytes,
                chunk_bytes: int = CHUNK_BYTES
                ) -> Iterator[Tuple[int, int, dict]]:
    """Yield ``(seq, total, frame)`` wire chunks for ``payload``. Each
    frame dict is JSON-clean: base64 data + the RAW chunk's CRC32, stamped
    BEFORE the ``srv.ship`` fault filter runs — injected corruption is
    therefore detectable, exactly like real wire damage."""
    total = max(1, -(-len(payload) // chunk_bytes))
    for seq in range(total):
        raw = payload[seq * chunk_bytes:(seq + 1) * chunk_bytes]
        crc = zlib.crc32(raw) & 0xFFFFFFFF
        raw = faults.filter_bytes("srv.ship", raw)
        # send-edge wire accounting: what the ship phase's duration in
        # the request timeline is spent on (obs/requests.py)
        obs.count("serving.ship_chunks_total")
        obs.count("serving.ship_chunk_bytes_total", len(raw))
        yield seq, total, {"seq": seq, "total": total,
                           "data": base64.b64encode(raw).decode("ascii"),
                           "crc": crc}


class ChunkAssembler:
    """Receiver-side reassembly of one shipment's chunk stream. Chunks may
    arrive retried (idempotent: a seq already held is re-verified, not
    duplicated); :meth:`payload` refuses until every chunk landed."""

    def __init__(self, total: int):
        if total < 1:
            raise ShipError(f"chunk stream declares total={total}")
        self.total = int(total)
        self._parts: Dict[int, bytes] = {}

    def add(self, seq: int, data_b64: str, crc: int) -> None:
        seq = int(seq)
        if not (0 <= seq < self.total):
            raise ShipError(f"chunk seq {seq} outside declared total "
                            f"{self.total}")
        try:
            raw = base64.b64decode(data_b64, validate=True)
        except Exception as exc:
            raise ShipError(f"chunk {seq} is not valid base64") from exc
        got = zlib.crc32(raw) & 0xFFFFFFFF
        if got != int(crc) & 0xFFFFFFFF:
            raise ShipError(f"chunk {seq} CRC {got:#010x} != declared "
                            f"{int(crc) & 0xFFFFFFFF:#010x} — corrupted or "
                            "truncated in flight")
        self._parts[seq] = raw

    @property
    def complete(self) -> bool:
        return len(self._parts) == self.total

    def payload(self) -> bytes:
        if not self.complete:
            missing = sorted(set(range(self.total)) - set(self._parts))
            raise ShipError(f"shipment incomplete: missing chunk(s) "
                            f"{missing[:8]} of {self.total}")
        return b"".join(self._parts[i] for i in range(self.total))
