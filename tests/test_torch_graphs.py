"""The port's graph cache (``paddle_tpu_torch/core/graphs.py``) on the CPU:
the direct route it takes for CPU and meta tensors, how it keys a call
and what it hands back from a replay, the optimizer's in-place apply that
the trainer's graph runs, and every graphed body on ``meta`` tensors.

A body captured into a CUDA graph must not read the card from the host:
``.item()``, ``.cpu()``, ``int(t)`` and boolean-mask indexing raise on
``meta`` tensors, so a body that runs on them end to end reads nothing
back. The graphs themselves, their replays and their counts are held
against the eager bodies on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import SeqBatch
from paddle_tpu_torch.core import graphs as G
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.models import (AttentionSeq2Seq, LSTMTextCls,
                                     TransformerLM)
from paddle_tpu_torch.models.seq2seq import DecoderState
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.serving import (ContinuousBatcher, PagePool,
                                      SpeculativeDecoder)
from paddle_tpu_torch.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")


# -- the cache --------------------------------------------------------------

def test_cpu_cache_copies_a_donated_input_it_does_not_own():
    """The body runs directly; a donated input of the caller's is copied
    first (and never written), the copy it returns is the cache's and
    comes back without a copy, and a cache buffer is written in place."""
    cache = G.GraphCache("test", "cpu")
    x = torch.zeros(3)
    seen = []

    def body(x, *, n):
        seen.append(x)
        x.add_(n)
        return x, x * 2

    G.reset_dispatch_counts()
    a, b = cache.run("f", body, {"x": x}, static={"n": 1.0},
                     donate=("x",))
    assert seen == [a] and a is not x and torch.equal(x, torch.zeros(3))
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, 2 * a)
    a2, _ = cache.run("f", body, {"x": a}, static={"n": 1.0},
                      donate=("x",))
    assert a2 is a and torch.equal(a, torch.full((3,), 2.0))
    buf = cache.buffer("state", lambda: {"s": torch.zeros(2)})
    assert cache.buffer("state", lambda: 1 / 0) is buf
    out, _ = cache.run("f", body, {"x": buf["s"]}, static={"n": 3.0},
                       donate=("x",))
    assert out is buf["s"] and torch.equal(buf["s"], torch.full((2,), 3.0))
    c, _ = cache.run("f", body, {"x": x}, static={"n": 1.0})
    assert c is x                   # not donated: the body gets it as it is
    assert cache._graphs == {} and G.DISPATCHES == {}


def test_cache_moves_tensors_from_another_device_to_its_own():
    cache = G.GraphCache("test", META)
    out = cache.run("f", lambda x, y: (x.device, y), {"x": torch.ones(2),
                                                      "y": 3})
    assert out == (META, 3)


@pytest.mark.parametrize("change", ["shape", "dtype", "static", "tree",
                                    "constant", "name"])
def test_signature_separates_what_jit_separates(change):
    base = dict(name="decode",
                inputs={"cell": {"k0": torch.zeros(2, 8), "pos":
                                 torch.zeros(2, dtype=torch.int32)},
                        "cur": torch.zeros(2, dtype=torch.int32), "n": 4},
                static={"cache_len": 256})
    same = G.signature(base["name"], base["inputs"], base["static"])[0]
    assert same == G.signature(
        "decode", {"cell": {"k0": torch.ones(2, 8), "pos": torch.ones(
            2, dtype=torch.int32)}, "cur": torch.ones(2, dtype=torch.int32),
            "n": 4}, {"cache_len": 256})[0]
    other = {"shape": lambda c: c["inputs"]["cell"].update(
                 k0=torch.zeros(2, 16)),
             "dtype": lambda c: c["inputs"].update(
                 cur=torch.zeros(2, dtype=torch.int64)),
             "static": lambda c: c["static"].update(cache_len=512),
             "tree": lambda c: c["inputs"]["cell"].update(
                 k0_scale=torch.ones(2, 8)),
             "constant": lambda c: c["inputs"].update(n=5),
             "name": lambda c: c.update(name="prefill")}
    other[change](base)
    assert G.signature(base["name"], base["inputs"],
                       base["static"])[0] != same


def test_a_generator_keys_by_kind_not_by_object():
    """A fresh generator for each call hits the same key, as JAX passes
    its PRNG key as a traced input; the label names no generator."""
    inputs = {"cur": torch.zeros(2, dtype=torch.int32)}
    key = lambda g: G.signature("decode", inputs, {"k": 3, "generator": g})[0]
    assert key(torch.Generator()) == key(torch.Generator().manual_seed(7))
    assert key(torch.Generator()) != key(None)
    assert G.label("decode", inputs, {"k": 3, "generator": torch.Generator()}
                   ) == "decode(k=3,2)"


def test_label_names_static_arguments_and_the_shapes_of_non_dict_inputs():
    inputs = {"pools": {"k0": torch.zeros(9, 4)},
              "tables": torch.zeros(8, 5, dtype=torch.int32),
              "batch": (torch.zeros(2, 7), torch.zeros(())), "n": 3}
    assert G.label("segment", inputs, {"cache_len": 64}) == \
        "segment(cache_len=64,8x5,2x7,scalar)"


def test_flatten_round_trips_nested_trees():
    state = DecoderState(torch.ones(2), torch.ones(2, 3), torch.ones(2, 1),
                         torch.ones(2))
    tree = {"a": (torch.ones(1), [torch.zeros(2), None]),
            "b": {"c": torch.ones(3), "d": "x"}, "s": state}
    leaves = []
    spec = G._flatten(tree, leaves)
    assert len(leaves) == 7
    back = G._unflatten(spec, iter(leaves))
    assert back["a"][0] is leaves[0] and back["a"][1][1] is None
    assert back["b"]["d"] == "x" and isinstance(back["a"], tuple)
    assert isinstance(back["s"], DecoderState) and back["s"].h is state.h
    hash(spec)


def test_a_replay_returns_static_buffers_as_they_are_and_clones_the_rest():
    static, own = torch.arange(3.0), torch.arange(4.0)
    entry = G._Graph()
    entry.out_spec = G._flatten({"cell": static, "tok": own}, [])
    entry.outs = [(static, True), (own, False)]
    out = entry.outputs()
    assert out["cell"] is static
    assert out["tok"] is not own and torch.equal(out["tok"], own)
    own.add_(1)                       # the next replay writes its memory
    assert torch.equal(out["tok"], torch.arange(4.0))


def test_disabled_nests():
    assert G._disabled == 0
    with G.disabled():
        with G.disabled():
            assert G._disabled == 2
        assert G._disabled == 1
    assert G._disabled == 0


def test_the_graph_cache_imports_no_jax():
    code = ("import sys; import paddle_tpu_torch.core.graphs, "
            "paddle_tpu_torch.trainer, paddle_tpu_torch.serving; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# -- the optimizer's in-place apply -----------------------------------------

def _tree(seed):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)
    return {"w": r(4, 3), "fc": {"w": r(3, 2), "b": r(2)},
            "bn": {"stats": {"mean": r(2)}}}


@pytest.mark.parametrize("make", [
    lambda: SGD(0.1), lambda: SGD(lambda s: 0.1 / s, weight_decay=0.01),
    lambda: Adam(2e-3), lambda: Adam(lambda s: 1e-2 / s, weight_decay=0.1)],
    ids=["sgd", "sgd_decay_schedule", "adam", "adam_decay_schedule"])
def test_in_place_apply_is_bit_equal_to_update(make):
    opt = make()
    params = _tree(0)
    state = opt.init(params)
    mine = tree_map(torch.clone, params)
    mine_state = {"step": state["step"].clone(),
                  "slots": tree_map(lambda p, slot: {
                      k: v.clone() for k, v in slot.items()},
                      params, state["slots"])}
    leaves = [t for _, t in tree_items(mine)]
    for i in range(3):
        grads = tree_map(lambda p: p * 0.0, params)
        grads.update(tree_map(lambda p: torch.randn(
            p.shape, generator=torch.Generator().manual_seed(i)),
            {k: v for k, v in params.items() if k != "bn"}))
        params, state = opt.update(grads, state, params)
        opt.apply_(grads, mine_state, mine)
    assert all(a is b for (_, a), b in zip(tree_items(mine), leaves))
    for (_, a), (_, b) in zip(tree_items(mine), tree_items(params)):
        assert torch.equal(a, b)
    for (pa, a), (pb, b) in zip(tree_items(mine_state["slots"]),
                                tree_items(state["slots"]), strict=True):
        assert pa == pb and torch.equal(a, b)
    assert int(mine_state["step"]) == int(state["step"]) == 3
    assert mine_state["step"].dtype == torch.int32


# -- every graphed body on meta tensors ---------------------------------------

def test_a_host_read_raises_on_meta():
    t = torch.zeros(2, device=META)
    for read in (lambda: t.sum().item(), lambda: t.cpu(),
                 lambda: int(t[0]), lambda: t[t > 0]):
        with pytest.raises((RuntimeError, NotImplementedError)):
            read()


def _z(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device=META)


def _lm():
    return TransformerLM(vocab=50, d_model=32, n_heads=2, n_layers=2,
                         max_len=64)


def _decode(kv, sample):
    m = _lm()
    draw = dict(sample=sample, top_k=3 if sample == "topk" else None,
                temperature=0.7, generator=None, route=None)
    cell = m.empty_cell(2, kv)
    cur, tok = m._prefill_body(cell, _z(2, 5, dtype=torch.long),
                               kv_dtype=kv, **draw)
    cur, tok = m._decode_body(cell, cur, cache_len=32, kv_dtype=kv, **draw)
    return tok, (2,)


def _paged(kv):
    pool = PagePool(_lm(), slots=2, segment=3, page_block=8, kv_dtype=kv,
                    device=META)
    _, first = pool._admit_body(pool.pools, _z(2, 16), _z(2),
                                _z(2, 2, dtype=torch.int64))
    _, block = pool._segment_body(pool.pools, _z(2, 4), _z(2), _z(2))
    return torch.cat([block, first[:, None].int()], 1), (2, 5)


def _batcher(kv):
    m = _lm()
    cb = ContinuousBatcher(m, slots=2, segment=3, kv_dtype=kv, device=META)
    cell, _ = m.prefill(_z(2, 8), _z(2), kv_dtype=kv)
    cell, cur = cb._admit_body(cell, _z(2), _z(2, 8), _z(2),
                               _z(2, dtype=torch.bool))
    return cb._segment_body(cell, cur, cache_len=32)[2], (2, 3)


def _speculative(k):
    m = _lm()
    cell, _ = m.prefill(_z(2, 8))
    dcell, _ = m.prefill(_z(2, 8), kv_dtype="int8")
    sd = SpeculativeDecoder(m, m, k=k, draft_kv_dtype="int8")
    return sd._round_body(cell, dcell, _z(2), _z(2))[2], (2, 2 * k - 1)


def _step(kind):
    if kind == "lm":
        m = _lm()
        loss, batch = (lambda p, ids: m.call(p, ids, method="loss")), (
            _z(2, 9),)
    elif kind == "seq2seq":
        m = AttentionSeq2Seq(40, 40, 16, 16)
        loss = lambda p, s, sl, ti, to, tl: m.call(
            p, SeqBatch(s, sl), SeqBatch(ti, tl), SeqBatch(to, tl),
            method="loss")
        batch = (_z(3, 6), _z(3), _z(3, 5), _z(3, 5), _z(3))
    else:
        m = LSTMTextCls(50, 16, 16, 2, pool="last")
        loss = lambda p, d, ln, y: m.call(
            p, SeqBatch(d, ln), y.long())
        batch = (_z(3, 6), _z(3), _z(3))
    bf16 = lambda p, *b: loss(tree_map(lambda a: a.to(torch.bfloat16), p),
                              *b).float()
    tr = Trainer(bf16, Adam(1e-3), device=META)
    params = m.tree()
    state = tr.opt.init(params)
    p, s, cost = tr._step_body(params, state, batch)
    assert p is params and s is state
    return cost, ()


def _search(kind):
    m = AttentionSeq2Seq(40, 40, 16, 16)
    if kind == "beam":
        toks, scores = m._beam_body(_z(3, 6), _z(3), beam_size=2, max_len=5,
                                    bos_id=0, eos_id=1, length_penalty=0.5,
                                    route=None)
        return toks, (3, 2, 5)
    toks, scores = m._greedy_body(_z(3, 6), _z(3), max_len=5, bos_id=0,
                                  eos_id=1, route=None)
    return toks, (3, 5)


BODIES = {
    "decode f32 greedy": lambda: _decode(None, "greedy"),
    "decode int8 greedy": lambda: _decode("int8", "greedy"),
    "decode f32 topk": lambda: _decode(None, "topk"),
    "decode int8 topk": lambda: _decode("int8", "topk"),
    "paged admission and segment f32": lambda: _paged(None),
    "paged admission and segment int8": lambda: _paged("int8"),
    "batcher admission and segment f32": lambda: _batcher(None),
    "batcher admission and segment int8": lambda: _batcher("int8"),
    "speculative round k4": lambda: _speculative(4),
    "speculative round k1": lambda: _speculative(1),
    "trainer step lm": lambda: _step("lm"),
    "trainer step seq2seq": lambda: _step("seq2seq"),
    "trainer step lstm": lambda: _step("lstm"),
    "beam search": lambda: _search("beam"),
    "greedy search": lambda: _search("greedy"),
}


@pytest.mark.parametrize("name", list(BODIES))
def test_graphed_body_runs_on_meta_without_a_host_read(name):
    out, shape = BODIES[name]()
    assert out.device == META and tuple(out.shape) == shape


def test_trainer_test_loss_body_runs_on_meta():
    m = _lm()
    tr = Trainer(lambda p, ids: m.call(p, ids, method="loss"), Adam(1e-3),
                 device=META)
    assert tr._loss_body(m.tree(), (_z(2, 9),)).device == META


# -- the carried state: a decode cell made once, a trainer's own trees --------

def _cpu_lm():
    return TransformerLM(vocab=50, d_model=32, n_heads=2, n_layers=2,
                         max_len=24).init(seed=1, device="cpu")


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_into_a_used_cell_equals_a_new_prefill(kv):
    m = _cpu_lm()
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 50, (3, 7)))
    want, want_last = m.prefill(ids, kv_dtype=kv)
    cell = m.empty_cell(3, kv)
    for t in cell.values():                 # what an earlier call left
        t.copy_(torch.randint(-5, 5, t.shape).to(t.dtype))
    mine = {k: v for k, v in cell.items()}
    got, last = m.prefill(ids, kv_dtype=kv, into=cell)
    assert got is not cell and torch.equal(last, want_last)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t is mine[k] and t.dtype == want[k].dtype
        assert torch.equal(t, want[k]), k


def test_generate_fused_keeps_one_cell_for_fresh_generators_and_lengths():
    """Calls with a fresh generator and another prompt length each reuse
    the model's one cell of that batch and kv_dtype, and draw what a
    generator of the same seed draws on the first call."""
    m = _cpu_lm()
    outs = []
    for T0 in (5, 9, 5, 3):
        ids = torch.as_tensor(np.random.RandomState(T0).randint(0, 50,
                                                                (2, T0)))
        outs.append(m.generate_fused(
            ids, 6, sample="topk", top_k=4, temperature=0.8,
            generator=torch.Generator().manual_seed(T0)))
        assert list(m.graph_cache()._buffers) == [("cell", 2, None,
                                                   torch.float32)]
    assert torch.equal(outs[0], outs[2])


def test_train_writes_neither_the_callers_trees_nor_an_earlier_result():
    m = _cpu_lm()
    rs = np.random.RandomState(3)
    batches = [(torch.as_tensor(rs.randint(0, 50, (2, 8))),)
               for _ in range(2)]
    tr = Trainer(lambda p, ids: m.call(p, ids, method="loss"), Adam(1e-2),
                 device="cpu")
    init = tree_map(torch.clone, m.tree())
    first, state = tr.train(lambda: batches, m.tree())
    kept = tree_map(torch.clone, first)
    for (_, a), (_, b) in zip(tree_items(m.tree()), tree_items(init)):
        assert torch.equal(a, b)
    second, _ = tr.train(lambda: batches[:1], m.tree())
    for (_, a), (_, b) in zip(tree_items(first), tree_items(kept)):
        assert torch.equal(a, b)
    assert int(state["step"]) == 2
    assert not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_items(first), tree_items(second)))
