"""The port's prefix cache (paddle_tpu_torch/serving/prefix.py, paged.py,
engine.py, models/transformer.py ``prefill_paged``) against the JAX
package's, both on the CPU, on the tiny serving model of
tests/conftest.py with the JAX weights carried across.

The cases of tests/test_serving_prefix.py, each run through the JAX
``PagedBatcher``/``ServingEngine`` and the port's on the same requests
in the same waves: greedy tokens equal to JAX's (and so to JAX's solo
decode, which its own suite holds), and the same host tallies (hits,
misses, copies on write, cached nodes and partials, evictions, pages
held). Plus ``schedule="fifo"`` against ``"longest_first"`` (the same
outputs), ``pending_results``, and ``prefill_paged`` against JAX's at a
zero and a nonzero offset (f32, atol 1e-5: the same op order, the
products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedBatcher as JBatcher
from paddle_tpu.serving import PrefixIndex as JPrefixIndex
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.serving import (ContinuousBatcher, PagedBatcher,
                                      Request, ServingEngine)
from paddle_tpu_torch.serving.prefix import PrefixIndex

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
BS = 8
POOL = dict(segment=8, page_block=BS, cache_bucket=32)
STATS = ("prefix_hits", "prefix_misses", "prefix_nodes", "prefix_partials",
         "prefix_evictions", "prefix_pages", "cow_copies", "prompt_tokens",
         "prefill_tokens")


@pytest.fixture(scope="module")
def models(paged_model_and_params):
    jmodel, jparams = paged_model_and_params
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = params_from_numpy(tree, TransformerLM(
        VOCAB, d_model=D, n_heads=H, n_layers=L, max_len=MAX_LEN), "cpu")
    return jmodel, jparams, port


def _refs_drained(index):
    stack = [index.root]
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        if n is not index.root:
            assert n.refs == 0


def _waves(models, waves, slots=4, **kw):
    """Serve each wave (a list of Requests) through a JAX and a port
    PagedBatcher with the prefix cache on; after each wave the tokens and
    the prefix tallies must agree. Returns the port's pool."""
    jmodel, jparams, port = models
    kw = dict(POOL, slots=slots, prefix_cache=True, **kw)
    jb = JBatcher(jmodel, jparams, **kw)
    pb = PagedBatcher(port, device="cpu", **kw)
    for wave in waves:
        want = jb.serve([JRequest(r.rid, r.prompt.copy(), r.max_new,
                                  prefix_len=r.prefix_len) for r in wave])
        got = pb.serve([Request(r.rid, r.prompt.copy(), r.max_new,
                                prefix_len=r.prefix_len) for r in wave])
        assert sorted(got) == sorted(want)
        for r in wave:
            np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                          err_msg=f"request {r.rid}")
        js, ps = jb.pool.prefix_stats(), pb.pool.prefix_stats()
        for k in STATS:
            assert ps.get(k) == js.get(k), k
        assert pb.pool.index_pages == jb.pool.index_pages
        assert pb.pool.pages_used == jb.pool.pages_used
        assert pb.pool.reserved == jb.pool.reserved == 0
    _refs_drained(pb.pool.index)
    return pb.pool


def test_prefix_index_is_the_jax_index():
    """The copied radix index replays the JAX unit case step for step."""
    for cls in (PrefixIndex, JPrefixIndex):
        idx = cls(4, page_bytes=100.0, half_life=2)
        toks = list(range(13))
        n0, _ = idx.insert_full(idx.root, tuple(toks[0:4]), 5)
        n1, _ = idx.insert_full(n0, tuple(toks[4:8]), 6)
        p = idx.insert_partial(n1, tuple(toks[8:12]), 7, owner=3)
        m = idx.match(toks, 9)
        assert [n.page for n in m.nodes] == [5, 6] and m.shared_len == 9
        idx.acquire(m)
        assert idx.evict_one() is None
        idx.adopt(p)
        assert idx.evict_one() == 7
        idx.release(m.nodes)
        idx.tick += 10
        idx._credit(n0, 100.0)
        assert [idx.evict_one(), idx.evict_one()] == [6, 5]
        assert idx.total_pages == 0 and idx.evictions == 3


def test_full_hit(models):
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, VOCAB, 27)
    pool = _waves(models, [[Request(0, prompt.copy(), 11)],
                           [Request(1, prompt.copy(), 11)]])
    assert pool.prefix_stats()["prefix_hits"] == 1
    assert pool.hit_admissions_total == 1


def test_partial_block_hit_copies_on_write(models):
    rs = np.random.RandomState(5)
    shared = rs.randint(0, VOCAB, 21)
    c = np.concatenate([shared[:19], rs.randint(0, VOCAB, 6)])
    pool = _waves(models, [[Request(0, shared.copy(), 9)],
                           [Request(1, c, 13)]], slots=2)
    assert pool.prefix_stats()["cow_copies"] >= 1


def test_concurrent_admits_share_then_diverge(models):
    rs = np.random.RandomState(7)
    shared = rs.randint(0, VOCAB, 16)
    w1 = [Request(0, np.concatenate([shared, rs.randint(0, VOCAB, 5)]), 10),
          Request(1, np.concatenate([shared, rs.randint(0, VOCAB, 3)]), 12)]
    w2 = [Request(2, np.concatenate([shared, rs.randint(0, VOCAB, 7)]), 8)]
    pool = _waves(models, [w1, w2])
    st = pool.prefix_stats()
    assert st["prefix_misses"] == 2 and st["prefix_hits"] == 1


def test_eviction_then_readmit(models):
    rs = np.random.RandomState(11)
    pa, pb = rs.randint(0, VOCAB, 16), rs.randint(0, VOCAB, 24)
    pool = _waves(models, [[Request(0, pa.copy(), 8)],
                           [Request(1, pb.copy(), 24)],
                           [Request(2, pa.copy(), 8)]], slots=2, pages=9)
    assert pool.prefix_stats()["prefix_evictions"] >= 1
    pool.clear_prefix_cache()
    assert pool.pages_used == 0


def test_same_wave_eviction_cannot_steal_matched_pages(models):
    rs = np.random.RandomState(17)
    pa = rs.randint(0, VOCAB, 16)
    hit = Request(1, np.concatenate([pa, rs.randint(0, VOCAB, 4)]), 8)
    big = Request(2, rs.randint(0, VOCAB, 24), 16)
    _waves(models, [[Request(0, pa.copy(), 8)], [hit, big]], slots=3,
           pages=9, schedule="fifo")


def test_int8_hits(models):
    rs = np.random.RandomState(13)
    shared = rs.randint(0, VOCAB, 24)
    r0 = Request(0, np.concatenate([shared, rs.randint(0, VOCAB, 5)]), 12)
    r1 = Request(1, r0.prompt.copy(), 10)
    r2 = Request(2, np.concatenate([shared[:20], rs.randint(0, VOCAB, 6)]),
                 9)
    pool = _waves(models, [[r0], [r1, r2]], slots=2, kv_dtype="int8")
    assert pool.prefix_stats()["prefix_hits"] == 2


def test_declared_prefix_len_caps_the_cache(models):
    rs = np.random.RandomState(19)
    shared = rs.randint(0, VOCAB, 30)
    _waves(models, [[Request(0, shared.copy(), 6, prefix_len=12)],
                    [Request(1, shared.copy(), 6)]])


def test_engine_cancel_with_shared_pages(models):
    """A request reading shared prefix pages cancelled mid-decode, on the
    JAX engine and the port's driven by step(): the survivor's tokens
    equal, the pins released, the drained pool holds the cached pages
    only, and clear_prefix_cache() empties it."""
    jmodel, jparams, port = models
    rs = np.random.RandomState(21)
    shared = rs.randint(0, VOCAB, 16)
    pa = np.concatenate([shared, rs.randint(0, VOCAB, 4)])
    pv = np.concatenate([shared, rs.randint(0, VOCAB, 3)])
    ps = np.concatenate([shared, rs.randint(0, VOCAB, 5)])
    kw = dict(slots=2, segment=8, page_block=BS, cache_bucket=32,
              queue_cap=8, prefix_cache=True)
    outs = []
    for eng in (JEngine(jmodel, jparams, **kw),
                ServingEngine(port, device="cpu", **kw)):
        first = eng.submit(pa, 8)
        while not eng.poll(first)[1]:
            eng.step()
        victim = eng.submit(pv, 100)
        survivor = eng.submit(ps, 9)
        eng.step()
        assert eng.pool.index.live_pages() == 2
        assert eng.cancel(victim) is True
        eng.step()
        assert eng.poll(victim)[1:] == (True, "cancelled")
        while not eng.poll(survivor)[1]:
            eng.step()
        toks, done, reason = eng.poll(survivor)
        assert done and reason == "length"
        outs.append((eng.poll(first)[0], toks))
        _refs_drained(eng.pool.index)
        assert eng.pool.reserved == 0
        assert eng.pool.pages_used == eng.pool.index_pages
        assert eng.stats()["prefix_hits"] == 2
        eng.pool.clear_prefix_cache()
        assert eng.pool.pages_used == 0
    assert outs[0] == outs[1]


def test_fifo_and_longest_first_give_the_same_outputs(models):
    jmodel, jparams, port = models
    rs = np.random.RandomState(25)
    reqs = [Request(i, rs.randint(0, VOCAB, int(rs.randint(3, 30))),
                    int(rs.randint(1, 25))) for i in range(7)]
    res = {}
    for schedule in ("fifo", "longest_first"):
        b = ContinuousBatcher(port, slots=3, segment=8, cache_bucket=32,
                              schedule=schedule, device="cpu")
        res[("pinned", schedule)] = b.serve(
            [Request(r.rid, r.prompt.copy(), r.max_new) for r in reqs])
        pb = PagedBatcher(port, slots=3, schedule=schedule, device="cpu",
                          **POOL)
        res[("paged", schedule)] = pb.serve(
            [Request(r.rid, r.prompt.copy(), r.max_new) for r in reqs])
    base = res[("paged", "longest_first")]
    for got in res.values():
        assert sorted(got) == sorted(base)
        for rid in base:
            np.testing.assert_array_equal(got[rid], base[rid])
    with pytest.raises(ValueError, match="schedule"):
        ContinuousBatcher(port, schedule="random", device="cpu")


def test_pending_results_counts_the_uncollected(models):
    _, _, port = models
    eng = ServingEngine(port, device="cpu", slots=2, **POOL)
    rs = np.random.RandomState(27)
    rids = [eng.submit(rs.randint(0, VOCAB, 9), 5) for _ in range(3)]
    assert eng.pending_results() == 0
    while not all(eng._recs[r].done for r in rids):
        eng.step()
    assert eng.pending_results() == 3
    eng.poll(rids[1])
    assert eng.pending_results() == 2
    eng.poll(rids[0], cursor=2)
    eng.poll(rids[2])
    assert eng.pending_results() == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_paged_matches_jax(models, kv_dtype):
    """Over pools with a prefix already written: a suffix prefill from
    offsets 0, 5 and 16 (one sample idle) writes the same pool rows and
    gives the same last logits as JAX's."""
    jmodel, jparams, port = models
    rs = np.random.RandomState(29)
    P, NB, B, S = 12, 5, 4, 9
    Hh, Dh = H, D // H
    pools = {}
    for i in range(L):
        for nm in (f"k{i}", f"v{i}"):
            if kv_dtype == "int8":
                pools[nm] = rs.randint(-127, 128, (P, BS, Hh, Dh)).astype(
                    np.int8)
                pools[nm + "_scale"] = (rs.rand(P, BS, Hh) * 0.02
                                        + 0.001).astype(np.float32)
            else:
                pools[nm] = (rs.randn(P, BS, Hh, Dh) * 0.5).astype(
                    np.float32)
    tables = np.array([[1, 2, 3, 0, 0], [4, 5, 0, 0, 0], [6, 7, 8, 9, 0],
                       [10, 0, 0, 0, 0]], np.int32)
    offsets = np.array([0, 5, 16, 0], np.int32)
    lengths = np.array([9, 4, 7, 0], np.int32)
    tokens = rs.randint(0, VOCAB, (B, S)).astype(np.int32)
    jp, jl = jmodel.prefill_paged(
        jparams, {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(tokens), jnp.asarray(offsets), jnp.asarray(lengths),
        jnp.asarray(tables))
    tp = {k: torch.tensor(v) for k, v in pools.items()}
    pp, pl = port.prefill_paged(tp, torch.tensor(tokens),
                                torch.tensor(offsets), torch.tensor(lengths),
                                torch.tensor(tables))
    assert pp["k0"] is tp["k0"]                    # written in place
    np.testing.assert_allclose(pl[:3].numpy(), np.asarray(jl)[:3],
                               atol=1e-5, rtol=1e-5)
    for k in pools:
        got, want = pp[k].numpy()[1:], np.asarray(jp[k])[1:]  # not page 0
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, k
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_zero_offset_suffix_prefill_reproduces_the_full_prefill(models):
    _, _, port = models
    rs = np.random.RandomState(31)
    prompt = torch.tensor(rs.randint(0, VOCAB, (2, 13)))
    lens = torch.tensor([13, 7])
    _, want = port.prefill(prompt, lens, route="plain")
    pools = {f"{n}{i}": torch.zeros(6, BS, H, D // H) for i in range(L)
             for n in ("k", "v")}
    tables = torch.tensor([[1, 2], [3, 4]])
    _, got = port.prefill_paged(pools, prompt, torch.zeros(2), lens, tables)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
