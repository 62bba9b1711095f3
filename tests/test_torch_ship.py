"""KV-page shipping in the port (paddle_tpu_torch/serving/ship.py,
``PagePool.export_slot``/``adopt_slot``, ``ServingEngine.submit_prefilled``)
against the JAX package's, both on the CPU.

The wire contract is JAX's byte for byte: for the same page rows the
port's manifest and payload equal JAX's (f32, bf16 carried as raw 2-byte
words under ml_dtypes' name "bfloat16", int8 with its ``*_scale``
planes); a JAX shipment unpacks and adopts into the port's pool with its
rows byte-identical, and the port's unpacks and adopts in JAX's. Damage
(a flipped byte, a short payload, a corrupted chunk, a ``srv.ship``
fault) is refused with ShipError and never adopted. End to end, a slot
prefilled in one port pool and adopted by another engine decodes the
tokens of the solo plain decode, and of JAX's engine.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagePool as JPagePool
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import ship as jship
from paddle_tpu_torch import faults
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.serving import (PagePool, Request, ServingEngine,
                                      ShipError)
from paddle_tpu_torch.serving import ship

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
POOL = dict(segment=8, page_block=8, cache_bucket=32)


def _rows(kv_dtype, seed=0, pages=3):
    """A slot shipment as numpy (ml_dtypes bf16 for "bf16") and as the
    port's tensors, with the same bytes."""
    rs = np.random.RandomState(seed)
    jx, pt = {}, {}
    for i in range(L):
        for nm in (f"k{i}", f"v{i}"):
            shape = (pages, 8, H, D // H)
            if kv_dtype == "int8":
                a = rs.randint(-127, 128, shape).astype(np.int8)
                s = rs.rand(pages, 8, H).astype(np.float32)
                jx[f"{nm}_scale"] = s
                pt[f"{nm}_scale"] = torch.from_numpy(s.copy())
            elif kv_dtype == "bf16":
                a = rs.randn(*shape).astype(ml_dtypes.bfloat16)
            else:
                a = rs.randn(*shape).astype(np.float32)
            jx[nm] = a
            if kv_dtype == "bf16":
                pt[nm] = torch.from_numpy(
                    a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                pt[nm] = torch.from_numpy(a.copy())
    return jx, pt


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
def test_pack_bytes_equal_jax_in_both_directions(kv_dtype):
    """The port's (manifest, payload) equal JAX's for the same rows, and
    each side's unpack of the other's gives the rows back bit for bit."""
    jx, pt = _rows(kv_dtype)
    wire_kv = "int8" if kv_dtype == "int8" else None
    jm, jp = jship.pack(jx, plen=17, first=42, page_block=8,
                        kv_dtype=wire_kv)
    pm, pp = ship.pack(pt, plen=17, first=42, page_block=8,
                       kv_dtype=wire_kv)
    assert pm == jm
    assert pp == jp
    if kv_dtype == "bf16":
        assert {e["dtype"] for e in pm["entries"]} == {"bfloat16"}
    got = ship.unpack(jm, jp)
    assert set(got) == set(pt)
    for nm, t in pt.items():
        assert got[nm].dtype == t.dtype and got[nm].shape == t.shape
        assert torch.equal(got[nm].view(torch.uint8)
                           if t.dtype != torch.bfloat16
                           else got[nm].view(torch.int16),
                           t.view(torch.uint8) if t.dtype != torch.bfloat16
                           else t.view(torch.int16))
    back = jship.unpack(pm, pp)
    for nm, a in jx.items():
        assert back[nm].dtype == a.dtype
        assert back[nm].tobytes() == a.tobytes()


def test_refusals_crc_short_payload_and_manifest():
    _, pt = _rows(None)
    m, p = ship.pack(pt, plen=9, first=1, page_block=8, kv_dtype=None)
    bad = bytearray(p)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(ShipError, match="CRC"):
        ship.unpack(m, bytes(bad))
    with pytest.raises(ShipError, match="truncated|lost"):
        ship.unpack(m, p[:-4])
    with pytest.raises(ShipError, match="version"):
        ship.unpack(dict(m, version=99), p)
    e0 = m["entries"][0]
    with pytest.raises(ShipError, match="disagrees"):
        ship.unpack(dict(m, entries=[dict(e0, nbytes=e0["nbytes"] - 1)]), p)
    with pytest.raises(ShipError, match="malformed"):
        ship.unpack(dict(m, entries=[dict(e0, dtype="complex7")]), p)


def test_chunks_round_trip_retry_and_refuse_corruption():
    """Chunks re-assemble (a retried chunk re-verifies), and a corrupted
    chunk — by hand, or by a ``srv.ship`` corrupt fault after the CRC —
    is refused at arrival: the payload is never complete."""
    _, pt = _rows(None)
    m, p = ship.pack(pt, plen=9, first=1, page_block=8, kv_dtype=None)
    frames = list(ship.iter_chunks(p, chunk_bytes=1024))
    assert len(frames) > 1
    # the frames are JAX's: its assembler takes them
    jasm = jship.ChunkAssembler(frames[0][1])
    asm = ship.ChunkAssembler(frames[0][1])
    for seq, _t, fr in frames:
        asm.add(seq, fr["data"], fr["crc"])
        jasm.add(seq, fr["data"], fr["crc"])
    asm.add(frames[0][0], frames[0][2]["data"], frames[0][2]["crc"])
    assert asm.payload() == p == jasm.payload()
    asm = ship.ChunkAssembler(frames[0][1])
    seq, _t, fr = frames[1]
    with pytest.raises(ShipError, match="CRC"):
        asm.add(seq, fr["data"], fr["crc"] ^ 0x1)
    with pytest.raises(ShipError, match="base64"):
        asm.add(seq, "!!! not base64 !!!", fr["crc"])
    with pytest.raises(ShipError, match="outside"):
        asm.add(99, fr["data"], fr["crc"])
    with pytest.raises(ShipError, match="incomplete"):
        asm.payload()
    plan = faults.FaultPlan(seed=7).add("srv.ship", "corrupt", nth=2)
    with plan.installed():
        frames = list(ship.iter_chunks(p, chunk_bytes=1024))
    assert plan.fired == [("srv.ship", 2, "corrupt")]
    asm = ship.ChunkAssembler(frames[0][1])
    refused = 0
    for seq, _t, fr in frames:
        try:
            asm.add(seq, fr["data"], fr["crc"])
        except ShipError:
            refused += 1
    assert refused == 1 and not asm.complete


@pytest.fixture(scope="module")
def models(paged_model_and_params):
    jmodel, jparams = paged_model_and_params
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = params_from_numpy(tree, TransformerLM(
        VOCAB, d_model=D, n_heads=H, n_layers=L, max_len=MAX_LEN), "cpu")
    return jmodel, jparams, port


def _prefill_and_export(pool, prompt, max_new, slot=0):
    """Admit ``prompt`` into ``pool`` (JAX's or the port's: the same
    surface), export the slot, free it: (manifest, payload)."""
    req = Request if isinstance(pool, PagePool) else JRequest
    r = req(-1, np.asarray(prompt, np.int32), int(max_new))
    pool.validate(r)
    plan = pool.plan_admission(r.prompt,
                               pool.effective_budget(r.prompt.size, max_new))
    assert pool.evict_for(plan.need_pages, 0, protect=[plan])
    first = int(pool.admit([(slot, plan)])[slot])
    out = pool.export_slot(slot, first)
    pool.free_slot(slot)
    return out


def _drain(eng, rid, steps=400):
    for _ in range(steps):
        eng.step()
        toks, done, reason = eng.poll(rid)
        if done:
            return np.asarray(toks, np.int32), reason
    raise AssertionError("engine never finished the adopted request")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_shipments_cross_between_the_packages(models, kv_dtype):
    """JAX's prefill pool exports, the port's engine adopts (rows landed
    byte-identical) and decodes JAX's solo tokens; the port's pool
    exports, JAX's engine adopts and decodes the same tokens."""
    jmodel, jparams, port = models
    rs = np.random.RandomState(11)
    prompt, max_new = rs.randint(0, VOCAB, 13), 20
    jsolo = JEngine(jmodel, jparams, slots=2, kv_dtype=kv_dtype, **POOL)
    want, wreason = _drain(jsolo, jsolo.submit(prompt.astype(np.int32),
                                               max_new))

    jm, jp = _prefill_and_export(
        JPagePool(jmodel, jparams, slots=2, kv_dtype=kv_dtype, **POOL),
        prompt, max_new)
    arrays = ship.unpack(jm, jp)
    eng = ServingEngine(port, slots=2, kv_dtype=kv_dtype, device="cpu",
                        **POOL)
    rid = eng.submit_prefilled(jm["plen"], jm["first"], arrays,
                               max_new=max_new)
    eng.admit_prefill()
    slot = eng._recs[rid].slot
    npg = -(-jm["plen"] // 8)
    pages = torch.from_numpy(eng.pool.tables[slot, :npg].astype(np.int64))
    for nm, rows in arrays.items():     # adopted rows: the shipped bytes
        assert torch.equal(eng.pool.pools[nm][pages], rows)
    got, reason = _drain(eng, rid)
    np.testing.assert_array_equal(got, want)
    assert reason == wreason

    pm, pp = _prefill_and_export(
        PagePool(port, slots=2, kv_dtype=kv_dtype, device="cpu", **POOL),
        prompt, max_new)
    jeng = JEngine(jmodel, jparams, slots=2, kv_dtype=kv_dtype, **POOL)
    jrid = jeng.submit_prefilled(pm["plen"], pm["first"],
                                 jship.unpack(pm, pp), max_new=max_new)
    got, reason = _drain(jeng, jrid)
    np.testing.assert_array_equal(got, want)


def test_shipped_decode_equals_solo_plain_decode_and_refuses_mismatch(models):
    """A port pool ships to a port engine through the real chunk framing:
    the adopted request's tokens equal the solo plain decode; a shipment
    missing a plane, or in another dtype, is a ValueError at submit."""
    _, _, port = models
    rs = np.random.RandomState(13)
    prompt, max_new = rs.randint(0, VOCAB, 9), 24
    m, p = _prefill_and_export(PagePool(port, slots=2, device="cpu", **POOL),
                               prompt, max_new, slot=1)
    frames = list(ship.iter_chunks(p, chunk_bytes=2048))
    asm = ship.ChunkAssembler(frames[0][1])
    for seq, _t, fr in frames:
        asm.add(seq, fr["data"], fr["crc"])
    arrays = ship.unpack(m, asm.payload())
    eng = ServingEngine(port, slots=2, device="cpu", **POOL)
    missing = dict(arrays)
    missing.pop("k0")
    with pytest.raises(ValueError, match="disagree"):
        eng.submit_prefilled(m["plen"], m["first"], missing, max_new=max_new)
    f64 = {nm: a.double() for nm, a in arrays.items()}
    with pytest.raises(ValueError, match="lossy cast"):
        eng.submit_prefilled(m["plen"], m["first"], f64, max_new=max_new)
    got, reason = _drain(eng, eng.submit_prefilled(
        m["plen"], m["first"], arrays, max_new=max_new))
    want = port.generate_fused(torch.as_tensor(prompt[None]), max_new,
                               route="plain")[0, prompt.size:].numpy()
    np.testing.assert_array_equal(got, want)
    assert reason == "length" and eng.pool.pages_used == 0
