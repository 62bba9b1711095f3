"""The port's data layer (paddle_tpu_torch/data/: the reader decorators,
``DoubleBuffer``, the synthetic datasets and ``DataFeeder``) against the
JAX package's, on the CPU, on the same rows. Everything here is exact:
readers must yield the same samples in the same order, and the feeder
the same arrays (the JAX side's converted with ``np.asarray``)."""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.data as JD
import paddle_tpu.data.feeder as JF
import paddle_tpu_torch.data as PD
import paddle_tpu_torch.data.feeder as PF
from paddle_tpu_torch.core import SeqBatch


def _rows(n=10):
    return lambda: iter(range(n))


def _canon(x):
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


# name -> callable(module) -> reader creator
READERS = {
    "map_readers": lambda m: m.map_readers(lambda a, b: a * 10 + b, _rows(),
                                           _rows(8)),
    "shuffle": lambda m: m.shuffle(_rows(23), 5, seed=3),
    "chain": lambda m: m.chain(_rows(3), _rows(4)),
    "compose": lambda m: m.compose(_rows(4), lambda: iter([(1, 2)] * 4)),
    "buffered": lambda m: m.buffered(_rows(20), 3),
    "firstn": lambda m: m.firstn(_rows(), 4),
    "xmap_ordered": lambda m: m.xmap_readers(lambda x: x * x, _rows(15), 3,
                                             4, order=True),
    "cache": lambda m: m.cache(_rows(5)),
    "batch": lambda m: m.batch(_rows(11), 4),
    "batch_drop_last": lambda m: m.batch(_rows(11), 4, drop_last=True),
    "mix": lambda m: m.mix([(_rows(6), 1.0), (lambda: iter("abcd"), 2.0)],
                           seed=2),
    "mnist": lambda m: m.firstn(m.dataset.mnist.train(64), 5),
    "imdb": lambda m: m.firstn(m.dataset.imdb.train(), 5),
    "uci_housing": lambda m: m.firstn(m.dataset.uci_housing.test(), 5),
}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_yields_what_jax_yields(name):
    want = _canon(list(READERS[name](JD)()))
    got = _canon(list(READERS[name](PD)()))
    assert got == want and len(got) > 0
    if name == "cache":          # a second pass replays
        r = READERS[name](PD)
        assert _canon(list(r())) == _canon(list(r()))


def test_unordered_xmap_yields_the_same_multiset():
    got = sorted(PD.xmap_readers(lambda x: -x, _rows(30), 4, 3)())
    want = sorted(JD.xmap_readers(lambda x: -x, _rows(30), 4, 3)())
    assert got == want


def test_compose_checks_alignment():
    with pytest.raises(ValueError):
        list(PD.compose(_rows(3), _rows(4))())


def test_double_buffer_transforms_on_its_thread_and_times_out():
    seen = []

    def transform(x):
        seen.append(threading.current_thread() is threading.main_thread())
        return x + 1

    got = list(PD.DoubleBuffer(_rows(7), depth=2, transform=transform))
    want = list(JD.DoubleBuffer(_rows(7), depth=2, transform=lambda x: x + 1))
    assert got == want == list(range(1, 8)) and not any(seen)

    def stalled():
        yield 1
        time.sleep(5)
        yield 2

    it = iter(PD.DoubleBuffer(stalled, timeout=0.2))
    assert next(it) == 1
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="prefetch watchdog"):
        next(it)
    assert time.perf_counter() - t0 < 2.0


def test_double_buffer_reraises_the_producers_error():
    def bad():
        yield 1
        raise KeyError("source")

    it = iter(PD.DoubleBuffer(bad))
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def _feed_rows(rs, B=7):
    rows = []
    for i in range(B):
        n = int(rs.randint(1, 40))
        rows.append((rs.randn(3).astype(np.float32).tolist(),
                     int(rs.randint(0, 5)),
                     rs.randint(0, 100, n).tolist(),
                     rs.randn(int(rs.randint(1, 9)), 2).astype(np.float32),
                     rs.randint(0, 50, int(rs.randint(0, 20))).tolist(),
                     [(int(j), float(v)) for j, v in
                      zip(rs.randint(0, 50, 3), rs.rand(3))]))
    return rows


SLOTS = lambda m: [m.DenseSlot(3), m.IndexSlot(), m.SeqSlot(),
                   m.SeqSlot(elem_dim=2), m.SparseSlot(50),
                   m.SparseSlot(50, with_values=True)]


def _flat(x):
    if isinstance(x, SeqBatch) or type(x).__name__ == "SeqBatch":
        return [_flat(x.data), _flat(x.lengths)]
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return (a.dtype.str, a.shape, a.tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_feeder_converts_as_jax_does(seed):
    rows = _feed_rows(np.random.RandomState(seed))
    got = PF.DataFeeder(SLOTS(PF), device="cpu")(rows)
    want = JF.DataFeeder(SLOTS(JF))(rows)
    assert _flat(got) == _flat(want)
    assert isinstance(got[2], SeqBatch) and got[2].data.shape[1] == 64


def test_feeder_device_and_nested_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            PF.DataFeeder([PF.IndexSlot()])
    # the nested slot packs a NestedSeqBatch as JAX's does
    rows = [([[1, 2], [3]],), ([[4]],)]
    (nb,) = PF.DataFeeder([PF.SeqSlot(nested=True)], device="cpu")(rows)
    (jb,) = JF.DataFeeder([JF.SeqSlot(nested=True)])(rows)
    for f in ("data", "sub_lengths", "seq_lengths"):
        np.testing.assert_array_equal(getattr(nb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
        assert getattr(nb, f).dtype == torch.int32
    with pytest.raises(ValueError, match="sample width"):
        PF.DataFeeder([PF.IndexSlot()], device="cpu")([(1, 2)])


def test_buckets_and_padding_follow_jax():
    for n in (1, 5, 8, 9, 100, 129, 600):
        for buckets in ((), (8, 16, 128)):
            assert PF.next_bucket(n, buckets) == JF.next_bucket(n, buckets)
    a = np.arange(30, dtype=np.float32).reshape(3, 10)
    for axis in (0, 1):
        want, wn = JF.pad_to_bucket(a, axis, (4, 16))
        got, gn = PF.pad_to_bucket(a, axis, (4, 16))
        tgot, tn = PF.pad_to_bucket(torch.from_numpy(a), axis, (4, 16))
        assert gn == wn == tn
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(tgot.numpy(), np.asarray(want))
    spec = {"words": (32, 64), "img": {"axis": 2, "buckets": (8,)}}
    js, ps = JF.BucketSpec(spec), PF.BucketSpec(spec)
    x = np.ones((2, 3, 5), np.float32)
    for name in ("words", "img"):
        assert ps.pinned_axis(name) == js.pinned_axis(name)
        (g, gn), (w, wn) = ps.pad(name, x), js.pad(name, x)
        assert gn == wn and np.array_equal(g, np.asarray(w))
    # int32 ids: JAX (x64 off) narrows an int64 array to int32 on the
    # device, the port keeps the dtype it is given
    seqs = [np.arange(3, dtype=np.int32), np.arange(20, dtype=np.int32)]
    g, w = PF.to_lod_batch(seqs, device="cpu"), JF.to_lod_batch(seqs)
    assert _flat(g) == _flat(w)
