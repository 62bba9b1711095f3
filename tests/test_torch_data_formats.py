"""The port's file formats and row sources (paddle_tpu_torch/data:
``parsers``, ``format``, ``provider``, ``image``) against the JAX
package's, on the CPU.

Inputs are the checked-in fixtures (tests/fixtures/: the mnist-10 idx
files, cifar-tiny, tiny.conll, tiny.src/trg) or rows made from a seed.
Host code throughout: rows, dicts, arrays and files must be equal (files
byte for byte), apart from the one training check at the end, the
fixture's MNIST through ``DataFeeder`` into a ``MnistMLP`` trained by
each package's ``Trainer``: costs atol 1e-5 and parameters atol 1e-5
(both sides f32 and the same ops; only the summation order of the
products differs). PIL is used here only; the port's ``image`` module
imports without it.
"""

import importlib
import io
import os
import random
import tarfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.data as JD
import paddle_tpu.data.format as JFMT
import paddle_tpu.data.image as JI
import paddle_tpu.data.parsers as JP
import paddle_tpu_torch.data as PD
import paddle_tpu_torch.data.format as PFMT
import paddle_tpu_torch.data.image as PI
import paddle_tpu_torch.data.parsers as PP
from paddle_tpu.models import MnistMLP as JMLP
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.trainer import Trainer as JTrainer
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import MnistMLP as PMLP
from paddle_tpu_torch.optimizer import Adam as PAdam
from paddle_tpu_torch.trainer import Trainer as PTrainer

# the packages' ``data.provider`` attribute is the decorator, not the module
JPV = importlib.import_module("paddle_tpu.data.provider")
PPV = importlib.import_module("paddle_tpu_torch.data.provider")
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MNIST = (os.path.join(FIX, "mnist-10-images.idx3.gz"),
         os.path.join(FIX, "mnist-10-labels.idx1.gz"))


def _same(a, b):
    """Rows equal: numpy arrays by dtype, shape and values, the rest ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and a == b


# -- parsers -----------------------------------------------------------------

def test_mnist_idx_parsing_matches_jax():
    got = list(PP.mnist_reader(*MNIST)())
    _same(got, list(JP.mnist_reader(*MNIST)()))
    assert len(got) == 10 and got[3][0].shape == (784,)
    assert got[3][0].dtype == np.float32
    assert [l for _, l in got] == list(range(10))
    _same(PP.parse_idx_images(MNIST[0]), JP.parse_idx_images(MNIST[0]))
    _same(PP.parse_idx_labels(MNIST[1]), JP.parse_idx_labels(MNIST[1]))


@pytest.mark.parametrize("body, match", [
    ((1234, 1, 28, 28), "magic"), ((2051, 10, 28, 28), "truncated")])
def test_idx_errors_are_loud(tmp_path, body, match):
    import struct
    p = tmp_path / "bad.idx3"
    p.write_bytes(struct.pack(">IIII", *body) + b"\0" * 100)
    for P in (PP, JP):
        with pytest.raises(IOError, match=match):
            P.parse_idx_images(str(p))
    q = tmp_path / "bad.idx1"
    q.write_bytes(struct.pack(">II", 7, 3) + b"\0")
    with pytest.raises(IOError, match="magic"):
        PP.parse_idx_labels(str(q))
    q.write_bytes(struct.pack(">II", 2049, 3) + b"\0")
    with pytest.raises(IOError, match="truncated"):
        PP.parse_idx_labels(str(q))


def test_mnist_count_mismatch_is_loud(tmp_path):
    import gzip
    import struct
    p = tmp_path / "one.idx1"
    p.write_bytes(struct.pack(">II", 2049, 1) + b"\x03")
    with pytest.raises(IOError, match="count mismatch"):
        list(PP.mnist_reader(MNIST[0], str(p))())
    # gzip or plain: the same labels
    g = tmp_path / "one.idx1.gz"
    g.write_bytes(gzip.compress(p.read_bytes()))
    _same(PP.parse_idx_labels(str(g)), PP.parse_idx_labels(str(p)))


def test_cifar_pickled_tar_matches_jax(tmp_path):
    path = os.path.join(FIX, "cifar-tiny.tar.gz")
    got = list(PP.cifar_reader(path)())
    _same(got, list(JP.cifar_reader(path)()))
    assert len(got) == 8 and got[0][0].shape == (3072,)
    with pytest.raises(IOError, match="no members"):
        list(PP.cifar_reader(path, member_prefix="nothing")())
    # a batch dict without labels is refused
    import pickle
    bad = tmp_path / "bad.tar"
    with tarfile.open(bad, "w") as tar:
        raw = pickle.dumps({b"data": np.zeros((1, 3072), np.uint8)})
        info = tarfile.TarInfo("data_batch_1")
        info.size = len(raw)
        tar.addfile(info, io.BytesIO(raw))
    with pytest.raises(IOError, match="neither"):
        list(PP.cifar_reader(str(bad))())


def test_conll_columns_and_dicts_match_jax():
    path = os.path.join(FIX, "tiny.conll")
    got, want = PP.conll_reader(path), JP.conll_reader(path)
    assert list(got()) == list(want()) and len(list(got())) == 3
    assert got.word_dict == want.word_dict
    assert got.tag_dict == want.tag_dict
    assert got.word_dict["."] == 1 and got.word_dict["<unk>"] == 0
    r2 = PP.conll_reader(path, word_dict={"<unk>": 0, "The": 1},
                         tag_dict=got.tag_dict)
    assert next(iter(r2()))[0] == [1, 0, 0, 0]
    assert list(PP.parse_conll_columns(path)) == \
        list(JP.parse_conll_columns(path))
    with pytest.raises(ValueError, match="no '<unk>' entry"):
        list(PP.conll_reader(path, word_dict={"The": 0},
                             tag_dict=got.tag_dict)())
    with pytest.raises(ValueError, match="not in the supplied tag_dict"):
        list(PP.conll_reader(path, tag_dict={})())


def test_parallel_text_matches_jax():
    src, trg = (os.path.join(FIX, "tiny.src"), os.path.join(FIX, "tiny.trg"))
    got, want = PP.parallel_text_reader(src, trg), \
        JP.parallel_text_reader(src, trg)
    rows = list(got())
    assert rows == list(want()) and len(rows) == 3
    assert got.src_dict == want.src_dict and got.trg_dict == want.trg_dict
    _, tin, tout = rows[1]
    assert tin[0] == got.trg_dict["<s>"] and tout[-1] == got.trg_dict["<e>"]
    assert tin[1:] == tout[:-1]
    with pytest.raises(IOError, match="misaligned"):
        PP.parallel_text_reader(src, os.path.join(FIX, "tiny.conll"))


def test_build_dict_and_md5_match_jax():
    toks = "b a c a b a d".split()
    for kw in ({}, {"min_count": 1}, {"specials": ()}):
        assert PP.build_dict(iter(toks), **kw) == \
            JP.build_dict(iter(toks), **kw)
    for f in os.listdir(FIX):
        p = os.path.join(FIX, f)
        assert PP.md5file(p) == JP.md5file(p)


def test_download_cache_and_md5_discipline(tmp_path, monkeypatch):
    # both packages read the same cache (PADDLE_TPU_DATA_HOME)
    assert PP.DATA_HOME == JP.DATA_HOME
    data = tmp_path / "corpus.bin"
    data.write_bytes(b"hello dataset")
    good = PP.md5file(str(data))
    monkeypatch.setattr(PP, "DATA_HOME", str(tmp_path / "cache"))
    assert PP.download(f"file://{data}", "m", good) == str(data)
    with pytest.raises(IOError, match="md5 mismatch"):
        PP.download(f"file://{data}", "m", "0" * 32)
    with pytest.raises(IOError, match="no network egress"):
        PP.download("http://example.com/x.tgz", "m")
    # a file placed in the cache is found, with or without an md5
    cached = tmp_path / "cache" / "m" / "x.tgz"
    cached.write_bytes(b"placed by hand")
    assert PP.download("http://example.com/x.tgz", "m") == str(cached)
    assert PP.download("http://example.com/x.tgz", "m",
                       PP.md5file(str(cached))) == str(cached)


# -- DataFormat ---------------------------------------------------------------

def _schema(F):
    return [F.SlotDef(F.DENSE, 3), F.SlotDef(F.INDEX),
            F.SlotDef(F.SPARSE_NON_VALUE, 50),
            F.SlotDef(F.SPARSE_VALUE, 50), F.SlotDef(F.STRING),
            F.SlotDef(F.INDEX, 0, F.SEQ), F.SlotDef(F.DENSE, 2, F.SEQ),
            F.SlotDef(F.INDEX, 0, F.SUB_SEQ),
            F.SlotDef(F.SPARSE_VALUE, 9, F.SUB_SEQ)]


def _samples(seed=0, n=6):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append((
            rs.randn(3).astype(np.float32),
            int(rs.randint(-5, 100)),
            rs.randint(0, 50, int(rs.randint(0, 6))).tolist(),
            [(int(i), float(np.float32(v))) for i, v in
             zip(rs.randint(0, 50, 3), rs.rand(3))],
            "row-%d" % rs.randint(1000),
            rs.randint(0, 30, int(rs.randint(1, 8))).tolist(),
            [rs.randn(2).astype(np.float32)
             for _ in range(int(rs.randint(0, 4)))],
            [rs.randint(0, 30, int(rs.randint(0, 5))).tolist()
             for _ in range(int(rs.randint(1, 4)))],
            [[[(int(i), 0.5), (int(i) // 2, -1.25)]]
             for i in rs.randint(0, 9, int(rs.randint(1, 3)))],
        ))
    return out


def _write(F, samples):
    buf = io.BytesIO()
    w = F.DataWriter(buf, _schema(F))
    for s in samples:
        w.write(s)
    return buf.getvalue()


def test_dataformat_files_are_byte_identical_and_cross_read(tmp_path):
    samples = _samples()
    raw = _write(PFMT, samples)
    assert raw == _write(JFMT, samples)
    assert raw.startswith(b"PTDF1\n")
    got = list(PFMT.DataReader(io.BytesIO(raw)))
    want = list(JFMT.DataReader(io.BytesIO(raw)))
    _same(got, want)
    assert len(got) == len(samples)
    for g, s in zip(got, samples):
        np.testing.assert_array_equal(g[0], s[0])
        assert g[1:6] == tuple(s[1:6]) and g[7] == s[7] and g[8] == s[8]
        assert len(g[6]) == len(s[6])
    r = PFMT.DataReader(io.BytesIO(raw))
    assert r.slots == _schema(PFMT)
    assert [repr(s) for s in r.slots] == [repr(s) for s in _schema(JFMT)]
    path = tmp_path / "rows.ptdf"
    path.write_bytes(raw)
    _same(list(PFMT.reader_creator(str(path))()), want)


def test_dataformat_errors_are_loud():
    with pytest.raises(IOError, match="bad magic"):
        PFMT.DataReader(io.BytesIO(b"PTDF0\n"))
    with pytest.raises(IOError, match="truncated header"):
        PFMT.DataReader(io.BytesIO(b"PTDF1\n\x02\x00"))
    with pytest.raises(IOError, match="truncated header"):
        PFMT.DataReader(io.BytesIO(b"PTDF1\n\x01\x00\x00\x00\x00"))
    raw = _write(PFMT, _samples(n=1))
    with pytest.raises(IOError, match="truncated record"):
        list(PFMT.DataReader(io.BytesIO(raw[:-3])))
    # a corrupt sequence count inside a record
    buf = io.BytesIO()
    w = PFMT.DataWriter(buf, [PFMT.SlotDef(PFMT.INDEX, 0, PFMT.SEQ)])
    w.write(([1, 2],))
    bad = bytearray(buf.getvalue())
    bad[len(PFMT.MAGIC) + 4 + 6 + 4] = 0xFF
    for F in (PFMT, JFMT):
        with pytest.raises(IOError, match="corrupt record"):
            list(F.DataReader(io.BytesIO(bytes(bad))))
    w = PFMT.DataWriter(io.BytesIO(), [PFMT.SlotDef(PFMT.DENSE, 3),
                                       PFMT.SlotDef(PFMT.SPARSE_NON_VALUE,
                                                    4)])
    with pytest.raises(ValueError, match="dense slot dim 3 got 2"):
        w.write(([1.0, 2.0], [0]))
    with pytest.raises(ValueError, match="sparse id 4 >= dim 4"):
        w.write(([1.0, 2.0, 3.0], [4]))
    with pytest.raises(ValueError, match="sample has 1 values"):
        w.write(([1.0, 2.0, 3.0],))


def test_dataformat_rows_feed_the_nested_slot_as_jax(tmp_path):
    """A DataFormat file with dense, index, sequence and nested-sequence
    slots through ``reader_creator`` -> ``batch`` -> ``DataFeeder``: the
    port's tensors equal JAX's arrays."""
    F = PFMT
    schema = [F.SlotDef(F.DENSE, 3), F.SlotDef(F.INDEX),
              F.SlotDef(F.INDEX, 0, F.SEQ),
              F.SlotDef(F.INDEX, 0, F.SUB_SEQ)]
    rs = np.random.RandomState(3)
    path = tmp_path / "nested.ptdf"
    with open(path, "wb") as f:
        w = F.DataWriter(f, schema)
        for _ in range(10):
            w.write((rs.randn(3).astype(np.float32), int(rs.randint(2)),
                     rs.randint(0, 20, int(rs.randint(1, 9))).tolist(),
                     [rs.randint(0, 20, int(rs.randint(0, 7))).tolist()
                      for _ in range(int(rs.randint(1, 6)))]))
    slots = lambda m: [m.DenseSlot(3), m.IndexSlot(), m.SeqSlot(),
                       m.SeqSlot(nested=True)]
    pf, jf = PD.DataFeeder(slots(PD), device="cpu"), JD.DataFeeder(slots(JD))
    pb = list(PD.batch(PFMT.reader_creator(str(path)), 4)())
    jb = list(JD.batch(JFMT.reader_creator(str(path)), 4)())
    assert len(pb) == len(jb) == 3
    for prow, jrow in zip(pb, jb):
        dense, idx, seq, nested = pf(prow)
        jd, ji, js, jn = jf(jrow)
        for a, b in ((dense, jd), (idx, ji), (seq.data, js.data),
                     (seq.lengths, js.lengths), (nested.data, jn.data),
                     (nested.sub_lengths, jn.sub_lengths),
                     (nested.seq_lengths, jn.seq_lengths)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype


# -- @provider ----------------------------------------------------------------

@pytest.mark.parametrize("V", [PPV, JPV], ids=["port", "jax"])
def test_provider_init_hook_and_settings(V):
    calls = []

    def init_hook(settings, vocab=None):
        settings.vocab = vocab
        calls.append("init")

    @V.provider(input_types=["dense(3)", "int(2)"], init_hook=init_hook,
                vocab=7)
    def process(settings, src):
        assert settings.vocab == 7
        for i in range(4):
            yield np.full((3,), float(i), np.float32), i % 2

    reader = process("fileA")
    assert calls == ["init"]
    rows = list(reader())
    assert len(rows) == 4 and rows[2][1] == 0
    assert reader.settings.input_types == ["dense(3)", "int(2)"]
    assert reader.settings.slots is reader.settings.input_types
    assert process.__name__ == "process"
    assert process.settings_factory().input_types == ["dense(3)", "int(2)"]


def _cached(V):
    loads = []

    @V.provider(cache=V.CacheType.CACHE_PASS_IN_MEM)
    def process(settings, src):
        loads.append(src)
        for i in range(2):
            yield (src, i)

    reader = process("a", "b")
    return list(reader()), list(reader()), loads


def _double_fill(V):
    """Two passes started against an empty cache: the cache is filled
    once (JAX's guard, provider.py:69-74)."""
    @V.provider(cache=V.CacheType.CACHE_PASS_IN_MEM)
    def process(settings, src):
        yield from range(3)

    r = process()
    g1, g2 = r(), r()
    first = next(g1)
    return first, list(g2), list(g1), list(r())


def test_provider_pass_cache_matches_jax():
    got = _cached(PPV)
    assert got == _cached(JPV)
    assert got[0] == got[1] == [("a", 0), ("a", 1), ("b", 0), ("b", 1)]
    assert got[2] == ["a", "b"]                 # each source read once
    got = _double_fill(PPV)
    assert got == _double_fill(JPV)
    assert got == (0, [0, 1, 2], [1, 2], [0, 1, 2])


def test_provider_shuffle_matches_jax():
    def rows(V, cache):
        @V.provider(should_shuffle=True, cache=cache)
        def process(settings, src):
            yield from range(20)
        random.seed(5)
        r = process()
        return [list(r()) for _ in range(2)]

    for cache in (0, 1):
        got = rows(PPV, cache)
        assert got == rows(JPV, cache)
        assert all(sorted(p) == list(range(20)) for p in got)
        assert got[0] != list(range(20)) and got[0] != got[1]


# -- image transforms ---------------------------------------------------------

def _image(seed=0, shape=(40, 50, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape).astype(
        np.uint8)


def test_image_transforms_match_jax():
    im = _image()
    for size in (16, 32, 64):
        _same(PI.resize_short(im, size), JI.resize_short(im, size))
        _same(PI.resize_short(im.transpose(1, 0, 2), size),
              JI.resize_short(im.transpose(1, 0, 2), size))
    _same(PI.resize_short(im[..., 0], 20), JI.resize_short(im[..., 0], 20))
    _same(PI.center_crop(im, 24), JI.center_crop(im, 24))
    _same(PI.random_crop(im, 24, np.random.RandomState(1)),
          JI.random_crop(im, 24, np.random.RandomState(1)))
    _same(PI.left_right_flip(im), JI.left_right_flip(im))
    _same(PI.normalize(im, [1.0, 2.0, 3.0], [2.0, 4.0, 8.0]),
          JI.normalize(im, [1.0, 2.0, 3.0], [2.0, 4.0, 8.0]))
    for train in (True, False):
        for seed in range(4):
            _same(PI.simple_transform(im, 32, 24, train, mean=[127.5] * 3,
                                      rng=np.random.RandomState(seed)),
                  JI.simple_transform(im, 32, 24, train, mean=[127.5] * 3,
                                      rng=np.random.RandomState(seed)))
    chw = PI.to_chw(im)
    assert chw.shape == (3, 40, 50)
    _same(chw, JI.to_chw(im))


def test_image_decode_and_tar_batches_match_jax(tmp_path):
    from PIL import Image
    im = _image()
    p = str(tmp_path / "im.png")
    Image.fromarray(im).save(p)
    back = PI.load_image(p)
    np.testing.assert_array_equal(back, im)
    _same(back, JI.load_image(p))
    assert PI.load_image(p, is_color=False).shape == (40, 50, 1)
    _same(PI.load_image(p, is_color=False), JI.load_image(p, is_color=False))
    _same(PI.load_and_transform(p, 32, 24, False, mean=[127.5] * 3),
          JI.load_and_transform(p, 32, 24, False, mean=[127.5] * 3))
    tar_p = str(tmp_path / "imgs.tar")
    with tarfile.open(tar_p, "w") as tf:
        for i in range(5):
            q = str(tmp_path / f"i{i}.png")
            Image.fromarray(im).save(q)
            tf.add(q, arcname=f"i{i}.png")
    labels = {f"i{i}.png": i for i in range(5)}
    lists = {}
    for name, I in (("port", PI), ("jax", JI)):
        lists[name] = I.batch_images_from_tar(
            tar_p, "toy", labels, num_per_batch=2,
            out_path=str(tmp_path / name))
    got = open(lists["port"]).read().splitlines()
    want = open(lists["jax"]).read().splitlines()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
    import pickle
    b0 = pickle.load(open(got[0], "rb"))
    assert len(b0["data"]) == 2 and b0["label"] == [0, 1]
    assert PI.load_image_bytes(b0["data"][0]).shape == (40, 50, 3)


# -- the mnist fixture into a training step -----------------------------------

def test_the_mnist_fixture_trains_an_mlp_as_jax():
    """The idx fixture through ``batch`` and ``DataFeeder`` into a
    ``MnistMLP`` trained with Adam for 10 passes of 2 batches by each
    package's ``Trainer`` from the same weights."""
    jm = JMLP(in_dim=784, hidden=16, classes=10)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           PMLP(in_dim=784, hidden=16, classes=10), "cpu")
    reader = PD.batch(PP.mnist_reader(*MNIST), 5)
    pfeed = PD.DataFeeder([PD.DenseSlot(784), PD.IndexSlot()], device="cpu")
    jfeed = JD.DataFeeder([JD.DenseSlot(784), JD.IndexSlot()])
    x, y = pfeed(next(iter(reader())))
    assert x.shape == (5, 784) and x.dtype == torch.float32
    assert y.dtype == torch.int32

    def costs(t, params, feed):
        out = []
        p, _ = t.train(reader, params, num_passes=10, feeder=feed,
                       handle_signals=False,
                       event_handler=lambda e: out.append(e.cost)
                       if type(e).__name__ == "EndIteration" else None)
        return out, p

    got, gp = costs(PTrainer(lambda p, x, y: pm.call(p, x, y, method="loss"),
                             PAdam(1e-2), device="cpu"), pm.tree(), pfeed)
    want, wp = costs(JTrainer(jm.loss, JAdam(1e-2)), jp, jfeed)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert len(got) == 20 and got[-1] < got[0]
    for layer in ("fc1", "fc2", "out"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(gp[layer][leaf].numpy(),
                                       np.asarray(wp[layer][leaf]),
                                       atol=1e-5, rtol=0)
