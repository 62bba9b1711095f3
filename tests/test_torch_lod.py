"""The rest of the port's LoD family (paddle_tpu_torch/core/lod.py:
``lod_from_lengths``/``lengths_from_lod``, ``NestedSeqBatch`` with
``pack_nested_sequences``, ``LoDBatch`` with ``pack_lod``/``unpack_lod``
and the offsets converters) and the nested feeder slot against the JAX
package's, on the CPU.

Mirrors tests/test_lod_nlevel.py (apart from its op pipeline, :93: the
nested sequence ops wait for ROADMAP A.4), tests/test_nested_seq.py:27
and tests/test_data.py:85-96, each case through both packages. Packing
only moves values, so every comparison is exact (dtype, shape and
values). The graph cache keys a body over a ``NestedSeqBatch`` on all
three tensors' shapes; the body runs on ``meta`` tensors, so it reads
nothing back to the host (the card's graph against eager is in
tests/test_torch_gpu.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.core.lod as J
import paddle_tpu.data as JD
import paddle_tpu_torch.core.lod as P
import paddle_tpu_torch.data as PD
from paddle_tpu_torch.core import graphs as G

META = torch.device("meta")


def _rand_nested(rs, depth, fanout=3, feat=(2,), dtype=np.float32):
    """A random ragged structure of ``depth`` levels (>= 1 child a node;
    innermost lengths 0..4)."""
    if depth == 1:
        return rs.randn(int(rs.randint(0, 5)), *feat).astype(dtype)
    return [_rand_nested(rs, depth - 1, fanout, feat, dtype)
            for _ in range(int(rs.randint(1, fanout + 1)))]


def _eq(a, b):
    """A port tensor (or structure) equal to a JAX array (or structure)."""
    if isinstance(a, torch.Tensor):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_lod(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, P.LoDBatch):
        _eq(got.data, want.data)
        _eq(list(got.level_lengths), list(want.level_lengths))
    elif isinstance(got, P.NestedSeqBatch):
        for f in ("data", "sub_lengths", "seq_lengths"):
            _eq(getattr(got, f), getattr(want, f))
    else:
        _eq(got.data, want.data)
        _eq(got.lengths, want.lengths)


def test_offsets_from_lengths_and_back():
    for lens in ([], [3], [2, 0, 5, 1]):
        off = P.lod_from_lengths(lens)
        assert off == J.lod_from_lengths(lens)
        assert P.lengths_from_lod(off) == J.lengths_from_lod(off) \
            == tuple(lens)


# -- NestedSeqBatch -----------------------------------------------------------

def _toy_nested():
    r = np.random.RandomState(0)
    return [[r.randn(3, 4).astype(np.float32),
             r.randn(2, 4).astype(np.float32)],
            [r.randn(1, 4).astype(np.float32)]]


def test_pack_nested_roundtrip_matches_jax():
    nested = _toy_nested()
    nb = P.pack_nested_sequences(nested, bucket=False, device="cpu")
    _same_lod(nb, J.pack_nested_sequences(nested, bucket=False))
    assert nb.data.shape == (2, 2, 3, 4)
    assert nb.seq_lengths.tolist() == [2, 1]
    assert nb.sub_lengths.tolist() == [[3, 2], [1, 0]]
    np.testing.assert_array_equal(nb.data[0, 1, :2].numpy(), nested[0][1])
    assert float(nb.inner_mask().sum()) == 3 + 2 + 1
    assert float(nb.outer_mask().sum()) == 2 + 1
    assert (nb.batch_size, nb.max_subseqs, nb.max_sublen) == (2, 2, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"bucket": False},
                                {"max_subseqs": 2, "max_sublen": 3},
                                {"pad_value": -1}])
def test_pack_nested_sequences_matches_jax(seed, kw):
    rs = np.random.RandomState(seed)
    nested = [_rand_nested(rs, 2, fanout=5) for _ in range(4)]
    got = P.pack_nested_sequences(nested, device="cpu", **kw)
    want = J.pack_nested_sequences(nested, **kw)
    _same_lod(got, want)
    for dt in (torch.float32, torch.int32):
        _eq(got.inner_mask(dt), want.inner_mask(
            {torch.float32: np.float32, torch.int32: np.int32}[dt]))
    _eq(got.outer_mask(), want.outer_mask())
    _same_lod(got.inner_flat(), want.inner_flat())
    per = torch.arange(got.batch_size * got.max_subseqs * 3,
                       dtype=torch.float32).reshape(-1, 3)
    _same_lod(got.outer(per), want.outer(per.numpy()))


def test_pack_nested_ids_and_edge_cases_match_jax():
    ids = [[np.array([1, 2], np.int32), np.array([3], np.int32)],
           [np.zeros(0, np.int32), np.array([4, 5, 6], np.int32)]]
    _same_lod(P.pack_nested_sequences(ids, device="cpu"),
              J.pack_nested_sequences(ids))
    # an empty leading sub-sequence does not set the layout
    empty_first = [[np.zeros((0, 3), np.float32),
                    np.ones((2, 3), np.float32)]]
    _same_lod(P.pack_nested_sequences(empty_first, device="cpu"),
              J.pack_nested_sequences(empty_first))
    for M in (P, J):
        with pytest.raises(ValueError, match="empty batch"):
            M.pack_nested_sequences([])
        with pytest.raises(ValueError, match="no sub-sequences"):
            M.pack_nested_sequences([[], []])


def test_the_nested_feeder_slot_matches_jax():
    rows = [([[1, 2], [3]],), ([[4]],)]
    (nb,) = PD.DataFeeder([PD.SeqSlot(nested=True)], device="cpu").feed(rows)
    (jb,) = JD.DataFeeder([JD.SeqSlot(nested=True)]).feed(rows)
    _same_lod(nb, jb)
    assert nb.data.shape[:2] == (2, 2)
    assert nb.seq_lengths.tolist() == [2, 1]
    assert nb.sub_lengths.tolist() == [[2, 1], [1, 0]]
    assert nb.data[0, 0, :2].tolist() == [1, 2]
    # vector elements, a float dtype, other slots beside it
    rs = np.random.RandomState(4)
    rows = [([rs.randn(int(rs.randint(1, 4)), 3).tolist()
              for _ in range(int(rs.randint(1, 4)))], int(rs.randint(5)))
            for _ in range(6)]
    slots = lambda m: [m.SeqSlot(elem_dim=3, nested=True), m.IndexSlot()]
    got = PD.DataFeeder(slots(PD), device="cpu")(rows)
    want = JD.DataFeeder(slots(JD))(rows)
    _same_lod(got[0], want[0])
    _eq(got[1], want[1])
    assert got[0].data.dtype == torch.float32


def test_a_graphed_body_keys_on_all_three_shapes():
    """The graph cache's key of a call over a ``NestedSeqBatch`` holds the
    shapes of data, sub_lengths and seq_lengths; two batches that differ
    only in the bucket of the sub-sequence axis get two keys."""
    a = P.pack_nested_sequences([[[1, 2]], [[3]]], device="cpu")
    b = P.pack_nested_sequences([[[1, 2]], [[3], [4], [5]]], device="cpu")
    assert a.data.shape[2] == b.data.shape[2]
    assert a.seq_lengths.shape == b.seq_lengths.shape
    ka, _, la = G.signature("f", {"nb": a}, {})
    kb, _, lb = G.signature("f", {"nb": b}, {})
    assert len(la) == len(lb) == 3 and ka != kb
    assert [tuple(t.shape) for t in la] == [(2, 2, 8), (2, 2), (2,)]
    assert [tuple(t.shape) for t in lb] == [(2, 4, 8), (2, 4), (2,)]
    # the structure round-trips through the cache's flattening
    spec_leaves = []
    spec = G._flatten({"nb": a}, spec_leaves)
    back = G._unflatten(spec, iter(spec_leaves))["nb"]
    assert isinstance(back, P.NestedSeqBatch) and back.data is a.data


def _nested_body(w, nb):
    """Per sub-sequence masked mean, then the masked sum over the outer
    sequence, then a product: what a nested model's head does."""
    inner = nb.inner_flat()
    m = inner.mask()
    mean = (inner.data * m[..., None]).sum(1) / m.sum(-1, keepdim=True
                                                      ).clamp(min=1.0)
    outer = nb.outer(mean)
    return (outer.data * outer.mask()[..., None]).sum(1) @ w


def test_a_nested_body_runs_on_meta_and_through_the_cache():
    rs = np.random.RandomState(5)
    nested = [_rand_nested(rs, 2, feat=(3,)) for _ in range(4)]
    nb = P.pack_nested_sequences(nested, device="cpu")
    w = torch.from_numpy(rs.randn(3, 2).astype(np.float32))
    cache = G.GraphCache("test", "cpu")
    got = cache.run("nested", _nested_body, {"w": w, "nb": nb})
    want = _nested_body(w, nb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the plain-python reference over the ragged lists
    ref = np.stack([sum((s.mean(0) for s in sample if len(s)),
                        np.zeros(3, np.float32)) for sample in nested]) \
        @ w.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    meta = P.NestedSeqBatch(*(torch.empty_like(t, device=META) for t in
                              (nb.data, nb.sub_lengths, nb.seq_lengths)))
    out = _nested_body(torch.empty_like(w, device=META), meta)
    assert out.device == META and tuple(out.shape) == (4, 2)


# -- N-level LoD --------------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_pack_unpack_roundtrip_matches_jax(levels):
    rs = np.random.RandomState(7)
    nested = [_rand_nested(rs, levels) for _ in range(4)]
    batch = P.pack_lod(nested, levels, device="cpu")
    _same_lod(batch, J.pack_lod(nested, levels))
    assert batch.nlevels == levels and batch.batch_size == 4
    assert batch.data.ndim == levels + 2
    for i, lens in enumerate(batch.level_lengths):
        assert tuple(lens.shape) == tuple(batch.data.shape[:i + 1])
    back = P.unpack_lod(batch)

    def _exact(a, b):
        if isinstance(a, list):
            assert isinstance(b, list) and len(a) == len(b)
            for x, y in zip(a, b):
                _exact(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    _exact(back, nested)
    _exact(back, J.unpack_lod(J.pack_lod(nested, levels)))


def test_three_level_offsets_roundtrip_matches_reference_form():
    lod = [(0, 2, 3), (0, 2, 5, 7), (0, 3, 5, 9, 11, 12, 15, 17)]
    flat = np.random.RandomState(7).randn(17, 4).astype(np.float32)
    batch = P.lod_batch_from_offsets(flat, lod, device="cpu")
    _same_lod(batch, J.lod_batch_from_offsets(flat, lod))
    assert batch.nlevels == 3 and batch.batch_size == 2
    assert tuple(batch.data.shape) == (2, 2, 3, 4, 4)
    flat2, lod2 = P.lod_batch_to_offsets(batch)
    assert [tuple(l) for l in lod2] == [tuple(l) for l in lod]
    np.testing.assert_array_equal(flat2, flat)
    jflat, jlod = J.lod_batch_to_offsets(J.lod_batch_from_offsets(flat, lod))
    assert lod2 == jlod
    np.testing.assert_array_equal(flat2, jflat)


def test_from_offsets_rejects_inconsistent_lod():
    for M in (P, J):
        kw = {"device": "cpu"} if M is P else {}
        with pytest.raises(ValueError, match="covers 3"):
            M.lod_batch_from_offsets(np.zeros((2, 4), np.float32), [(0, 3)],
                                     **kw)
        with pytest.raises(ValueError, match="level 0 covers"):
            M.lod_batch_from_offsets(np.zeros((5, 4), np.float32),
                                     [(0, 1), (0, 2, 5)], **kw)
        with pytest.raises(ValueError, match="non-decreasing"):
            M.lod_batch_from_offsets(np.zeros((2, 4), np.float32),
                                     [(0, 2, 1, 2)], **kw)
        with pytest.raises(ValueError, match="start at 0"):
            M.lod_batch_from_offsets(np.zeros((2, 4), np.float32), [(1, 2)],
                                     **kw)
        with pytest.raises(ValueError, match="need >= 1"):
            M.lod_batch_from_offsets(np.zeros((2, 4), np.float32), [], **kw)
    with pytest.raises(ValueError, match="levels must be"):
        P.pack_lod([[1]], 0, device="cpu")
    with pytest.raises(ValueError, match="empty batch"):
        P.pack_lod([], 1, device="cpu")


def test_three_level_masks_and_flat_view_match_jax():
    lod = [(0, 2, 3), (0, 2, 5, 7), (0, 3, 5, 9, 11, 12, 15, 17)]
    flat = np.random.RandomState(7).randn(17, 4).astype(np.float32)
    b = P.lod_batch_from_offsets(flat, lod, device="cpu")
    jb = J.lod_batch_from_offsets(flat, lod)
    for level in (0, 1, 2, -1):
        _eq(b.mask(level), jb.mask(level))
    assert b.mask(0).tolist() == [[1, 1], [1, 0]]
    assert int(b.mask(2).sum()) == 17
    inner = b.innermost_flat()
    assert isinstance(inner, P.SeqBatch)
    _same_lod(inner, jb.innermost_flat())
    assert int(inner.lengths.sum()) == 17
    per = torch.arange(12 * 5, dtype=torch.float32).reshape(12, 5)
    _same_lod(b.lift(per), jb.lift(per.numpy()))
    two = b.lift(per)
    _same_lod(two.as_nested(), jb.lift(per.numpy()).as_nested())
    one = two.lift(torch.ones(4, 5))
    _same_lod(one.as_seq_batch(),
              jb.lift(per.numpy()).lift(np.ones((4, 5), np.float32))
              .as_seq_batch())
    with pytest.raises(ValueError, match="lift"):
        one.lift(torch.ones(2, 5))
    with pytest.raises(ValueError, match="not a SeqBatch"):
        b.as_seq_batch()
    with pytest.raises(ValueError, match="not a NestedSeqBatch"):
        b.as_nested()


def test_as_nested_matches_the_two_level_packer():
    rs = np.random.RandomState(8)
    nested = [_rand_nested(rs, 2) for _ in range(3)]
    a = P.pack_lod(nested, 2, device="cpu").as_nested()
    b = P.pack_nested_sequences(nested, bucket=False, device="cpu")
    for f in ("data", "sub_lengths", "seq_lengths"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    _same_lod(a, J.pack_lod(nested, 2).as_nested())


def test_packers_put_their_tensors_on_the_device():
    nested = [[np.ones((2, 3), np.float32)]]
    for out in (P.pack_nested_sequences(nested, device=META),
                P.pack_lod(nested, 2, device=META)):
        tensors = ([out.data, out.sub_lengths, out.seq_lengths]
                   if isinstance(out, P.NestedSeqBatch)
                   else [out.data, *out.level_lengths])
        assert all(t.device == META for t in tensors)
    if not torch.cuda.is_available():
        for pack in (P.pack_nested_sequences, lambda n: P.pack_lod(n, 2)):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                pack(nested)
