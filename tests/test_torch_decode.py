"""The port's dense decode path and int8 KV (paddle_tpu_torch: the decode
reads of ops/cuda_kernels.py, TransformerLM's decode methods, the int8
pools and the pinned and speculative batchers) against the JAX package,
both on the CPU, on the tiny serving model of tests/conftest.py (vocab 97,
d_model 32, 4 heads, 2 layers, max_len 128) with the JAX weights carried
across by ``convert.params_from_numpy``. On the CPU the port's wrappers
take their kernels' plain versions; the JAX reads run their Pallas kernels
in interpret mode or their dense route.

Tolerances, with the reason:

* ``quantize_kv``: bit-equal (the same f32 division, round half to even);
* the decode reads: atol 1e-5 — f32 on both sides on the same inputs
  (int8 codes and scales handed over as they are), summation order only;
* logits: atol 1e-4 — f32 through two blocks, matmul summation order;
* int8 caches written by the two frameworks: codes within 1 and
  dequantized rows within one scale step — the k/v rows they quantize
  differ by f32 rounding, which can move a value across a rounding edge;
* tokens of every decode loop and batcher: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from paddle_tpu.serving import PagedBatcher as JaxPagedBatcher
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import SpeculativeDecoder as JaxSpeculativeDecoder
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.serving import (ContinuousBatcher, PagedBatcher,
                                      Request, ServingEngine,
                                      SpeculativeDecoder)

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
READ_ATOL = 1e-5
LOGIT_ATOL = 1e-4
POOL = dict(segment=8, page_block=8, cache_bucket=32)


@pytest.fixture(scope="module")
def pair(paged_model_and_params):
    jmodel, jparams = paged_model_and_params
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = params_from_numpy(tree, TransformerLM(
        VOCAB, d_model=D, n_heads=H, n_layers=L, max_len=MAX_LEN), "cpu")
    return jmodel, jparams, port


def _t(a):
    return torch.from_numpy(np.array(a))


def _cell_to_torch(jcell):
    return {nm: _t(a) for nm, a in jcell.items()}


def _close_int8(got: torch.Tensor, want):
    """Codes within 1: f32 rounding of the rows the two frameworks quantize
    can move a value across a rounding edge, which is rare."""
    d = (got.int() - _t(want).int()).abs()
    assert int(d.max()) <= 1
    assert d.float().mean() < 0.01          # a flip is a rare edge case


# ---------------------------------------------------------------------------
# quantize_kv and the decode reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 4, 16) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0                                 # an all-zero row: 1.0
    # amax 127 gives scale 1.0, so x / scale lands on the .5 ties, which
    # round half to even on both sides
    x[1, 2, 0, :8] = [127.0, 2.5, -2.5, 3.5, -0.5, 0.5, 126.5, -126.5]
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = pk.quantize_kv(jx)
    tq, ts = ck.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 2] == 1.0 and not tq[0, 1, 2].any()
    assert tq[1, 2, 0, :8].tolist() == [127, 2, -2, 4, 0, 0, 126, -126]


def _dense_case(seed, kind):
    """q [3, H, 64], a [3, 40, H, 64] cache read as its [:, :24] view, pos
    with 0, L-1 and a drained value past L; int8 caches as codes + scales
    from ``quantize_kv``."""
    rs = np.random.RandomState(seed)
    B, Lmax, Lr, Hh, Dh = 3, 40, 24, 2, 64
    q = rs.randn(B, Hh, Dh).astype(np.float32)
    k = rs.randn(B, Lmax, Hh, Dh).astype(np.float32)
    v = rs.randn(B, Lmax, Hh, Dh).astype(np.float32)
    pos = np.array([0, Lr - 1, Lr + 9], np.int32)
    dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    tq = torch.from_numpy(q).to(dt)
    if kind == "int8":
        (tk, tks), (tv, tvs) = (ck.quantize_kv(torch.from_numpy(a))
                                for a in (k, v))
        scales = (tks[:, :Lr], tvs[:, :Lr])
    else:
        tk, tv = (torch.from_numpy(a).to(dt) for a in (k, v))
        scales = (None, None)
    tk, tv = tk[:, :Lr], tv[:, :Lr]
    assert not tk.is_contiguous()               # the strided cache view
    return tq, tk, tv, _t(pos), scales


def _to_jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("route", ["kernel", "dense"])
def test_decode_attention_plain_matches_pallas(kind, route):
    q, k, v, pos, (ks, vs) = _dense_case(1, kind)
    kw = {"interpret": True} if route == "kernel" else {}
    want = pk.decode_attention(_to_jax(q), _to_jax(k), _to_jax(v),
                               _to_jax(pos), k_scale=_to_jax(ks),
                               v_scale=_to_jax(vs), route=route, **kw)
    got = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=READ_ATOL, rtol=0)


@pytest.mark.parametrize("route", ["kernel", "dense"])
def test_paged_int8_plain_matches_pallas(route):
    rs = np.random.RandomState(2)
    B, Hh, Dh, bs, NB, P = 3, 2, 16, 8, 4, 14
    (kp, ksp), (vp, vsp) = (ck.quantize_kv(torch.from_numpy(
        rs.randn(P, bs, Hh, Dh).astype(np.float32))) for _ in range(2))
    tables = np.stack([rs.choice(np.arange(1, P), NB, replace=False)
                       for _ in range(B)]).astype(np.int32)
    tables[0, 1:] = 0                     # past the live pages: null page
    q = torch.from_numpy(rs.randn(B, Hh, Dh).astype(np.float32))
    pos = np.array([3, 17, 30], np.int32)
    kw = {"interpret": True} if route == "kernel" else {}
    want = pk.paged_decode_attention(
        _to_jax(q), _to_jax(kp), _to_jax(vp), jnp.asarray(tables),
        jnp.asarray(pos), k_scale=_to_jax(ksp), v_scale=_to_jax(vsp),
        route=route, **kw)
    got = ck.paged_decode_attention(q, kp, vp, _t(tables), _t(pos),
                                    k_scale=ksp, v_scale=vsp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=READ_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# TransformerLM: prefill, decode_step, verify_step
# ---------------------------------------------------------------------------

def _ragged_prompt(seed, B=3, T=16, lens=(16, 5, 9)):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (B, T)).astype(np.int32),
            np.array(lens, np.int32))


def test_prefill_int8_cells_match_jax(pair):
    jmodel, jparams, model = pair
    prompt, lens = _ragged_prompt(3)
    jcell, jlast = jmodel.prefill(jparams, jnp.asarray(prompt),
                                  jnp.asarray(lens), kv_dtype="int8",
                                  pad_to=32)
    cell, last = model.prefill(_t(prompt), _t(lens), kv_dtype="int8",
                               pad_to=32)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_ATOL, rtol=0)
    for i in range(L):
        for nm in (f"k{i}", f"v{i}"):
            codes, scale = cell[nm], cell[nm + "_scale"]
            assert codes.dtype == torch.int8 and codes.shape == (3, 32, H,
                                                                 D // H)
            assert scale.shape == (3, 32, H)
            _close_int8(codes, jcell[nm])
            np.testing.assert_allclose(scale.numpy(),
                                       np.asarray(jcell[nm + "_scale"]),
                                       rtol=1e-5, atol=0)
            deq = codes.float() * scale[..., None]
            jdeq = (np.asarray(jcell[nm], np.float32)
                    * np.asarray(jcell[nm + "_scale"])[..., None])
            assert (np.abs(deq.numpy() - jdeq)
                    <= 1.001 * scale.numpy()[..., None]).all()
            # the padding: codes 0, scales exactly 1.0
            assert not codes[:, 16:].any()
            assert bool((scale[:, 16:] == 1.0).all())
    with pytest.raises(ValueError, match="kv_dtype"):
        model.prefill(_t(prompt), kv_dtype="fp8")


def _decode_both(jmodel, jparams, model, kv_dtype, prompt, lens, steps,
                 cache_len):
    """A JAX prefill cell handed to both frameworks, then ``steps`` decode
    steps each; asserts logits and tokens each step, returns both cells."""
    jcell, jlast = jmodel.prefill(jparams, jnp.asarray(prompt),
                                  jnp.asarray(lens), kv_dtype=kv_dtype)
    cell = _cell_to_torch(jcell)
    jtok = jnp.argmax(jlast, -1).astype(jnp.int32)
    tok = _t(jtok)
    for _ in range(steps):
        jlog, jcell = jmodel.decode_step(jparams, jcell, jtok,
                                         cache_len=cache_len,
                                         attn_route="dense")
        logits, cell = model.decode_step(cell, tok, cache_len=cache_len)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=0)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(cell["pos"].numpy(),
                                  np.asarray(jcell["pos"]))
    return jcell, cell


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_step_matches_jax(pair, kv_dtype):
    """Three bucketed steps from a ragged prefill: logits, tokens and the
    caches written in place equal JAX's functional updates."""
    jmodel, jparams, model = pair
    prompt, lens = _ragged_prompt(4)
    jcell, cell = _decode_both(jmodel, jparams, model, kv_dtype, prompt,
                               lens, 3, cache_len=32)
    for nm, a in jcell.items():
        if nm == "pos":
            continue
        if cell[nm].dtype == torch.int8:
            _close_int8(cell[nm], a)
        else:
            np.testing.assert_allclose(cell[nm].numpy(), np.asarray(a),
                                       atol=LOGIT_ATOL, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_step_clamps_at_the_end_of_the_cache(pair, kv_dtype):
    """Positions 126 .. 129 of a max_len-128 cache: the writes past the
    last row land on row 127 and the position embedding clamps, as JAX's
    dynamic_update_slice and gather clamp; the read covers every row."""
    jmodel, jparams, model = pair
    prompt, lens = _ragged_prompt(5, B=2, T=126, lens=(126, 40))
    jcell, cell = _decode_both(jmodel, jparams, model, kv_dtype, prompt,
                               lens, 4, cache_len=None)
    assert cell["pos"].tolist() == [130, 44]
    for nm in ("k1", "v1"):
        if kv_dtype == "int8":
            _close_int8(cell[nm][0, 120:], np.asarray(jcell[nm])[0, 120:])
        else:
            np.testing.assert_allclose(cell[nm][0, 120:].numpy(),
                                       np.asarray(jcell[nm])[0, 120:],
                                       atol=LOGIT_ATOL, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_verify_step_matches_jax(pair, kv_dtype):
    """A 5-token span from a ragged prefill (and sample 0's span crossing
    the end of the cache, its write clamped to the last 5 rows): span
    logits equal JAX's verify_step."""
    jmodel, jparams, model = pair
    prompt, lens = _ragged_prompt(6, T=125, lens=(125, 7, 60))
    jcell, _ = jmodel.prefill(jparams, jnp.asarray(prompt),
                              jnp.asarray(lens), kv_dtype=kv_dtype)
    cell = _cell_to_torch(jcell)
    span = np.random.RandomState(7).randint(0, VOCAB, (3, 5)).astype(
        np.int32)
    jlog, jcell2 = jmodel.verify_step(jparams, jcell, jnp.asarray(span))
    logits, cell2 = model.verify_step(cell, _t(span))
    assert logits.shape == (3, 5, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(cell2["pos"].numpy(), lens + 5)
    if kv_dtype is None:
        np.testing.assert_allclose(cell2["k0"].numpy(),
                                   np.asarray(jcell2["k0"]),
                                   atol=LOGIT_ATOL, rtol=1e-5)
    else:
        _close_int8(cell2["k0"], jcell2["k0"])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_verify_step_close_to_sequential_decode(pair, kv_dtype):
    """verify_step's span logits against running decode_step over the same
    tokens one at a time: allclose (atol 1e-4; the JAX package's own
    bit-exact test of this does not hold, so neither side is held to the
    bit) and the same greedy tokens."""
    _, _, model = pair
    prompt, lens = _ragged_prompt(8)
    cell, last = model.prefill(_t(prompt), _t(lens), kv_dtype=kv_dtype)
    seq_cell, _ = model.prefill(_t(prompt), _t(lens), kv_dtype=kv_dtype)
    toks, logits = [torch.argmax(last, -1).to(torch.int32)], []
    for _ in range(6):
        lg, seq_cell = model.decode_step(seq_cell, toks[-1])
        logits.append(lg)
        toks.append(torch.argmax(lg, -1).to(torch.int32))
    vlg, _ = model.verify_step(cell, torch.stack(toks[:6], dim=1))
    torch.testing.assert_close(vlg, torch.stack(logits, dim=1),
                               atol=LOGIT_ATOL, rtol=0)
    assert torch.equal(torch.argmax(vlg, -1), torch.stack(toks[1:], dim=1))


# ---------------------------------------------------------------------------
# the decode loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("bucket", [None, 32])
def test_generate_cached_and_fused_match_jax(pair, kv_dtype, bucket):
    """A 26-token prompt and 12 new tokens: the bucketed reads cross from
    32 to 64 rows. Tokens equal JAX's generate_cached at the same
    kv_dtype, through both of the port's loops."""
    jmodel, jparams, model = pair
    prompt = np.random.RandomState(9).randint(0, VOCAB, (2, 26)).astype(
        np.int32)
    want = np.asarray(jmodel.generate_cached(jparams, jnp.asarray(prompt),
                                             12, bucket=bucket,
                                             kv_dtype=kv_dtype))
    for fn in (model.generate_cached, model.generate_fused):
        got = fn(_t(prompt), 12, bucket=bucket, kv_dtype=kv_dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="max_len"):
        model.generate_fused(_t(prompt), MAX_LEN)


def test_generate_fused_topk_sampling(pair):
    """top_k=1 is greedy; top-k draws lie in the top-k set of the model's
    logits at each step and repeat under one generator seed."""
    _, _, model = pair
    prompt = _t(np.random.RandomState(10).randint(0, VOCAB, (2, 6)))
    greedy = model.generate_fused(prompt, 8)
    one = model.generate_fused(prompt, 8, sample="topk", top_k=1,
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(one, greedy)
    runs = [model.generate_fused(prompt, 8, sample="topk", top_k=5,
                                 temperature=0.7,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    ids = runs[0]
    logits = model(ids[:, :-1])                      # teacher-forced
    for j in range(6, ids.shape[1]):
        top = torch.topk(logits[:, j - 1], 5).indices
        assert bool((top == ids[:, j:j + 1]).any(dim=1).all()), j
    with pytest.raises(ValueError, match="top_k and generator"):
        model.generate_fused(prompt, 2, sample="topk", top_k=5)


# ---------------------------------------------------------------------------
# the batchers
# ---------------------------------------------------------------------------

def _requests(seed, n, plen=(3, 30), gen=(1, 25)):
    rs = np.random.RandomState(seed)
    return [Request(rid, rs.randint(0, VOCAB, int(rs.randint(*plen))),
                    int(rs.randint(*gen))) for rid in range(n)]


def _jax_reqs(reqs):
    return [JaxRequest(r.rid, r.prompt.copy(), r.max_new, eos_id=r.eos_id)
            for r in reqs]


def _port_reqs(reqs):
    return [Request(r.rid, r.prompt.copy(), r.max_new, eos_id=r.eos_id)
            for r in reqs]


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_continuous_batcher_matches_jax(pair, kv_dtype):
    """7 requests through 3 pinned slots (churn, two prompt buckets): every
    continuation equals the JAX batcher's (its default longest-first
    schedule, the port's one) at the same kv_dtype."""
    jmodel, jparams, model = pair
    reqs = _requests(11, 7, plen=(3, 40))
    kw = dict(slots=3, segment=8, cache_bucket=32, kv_dtype=kv_dtype)
    want = JaxContinuousBatcher(jmodel, jparams, **kw).serve(_jax_reqs(reqs))
    got = ContinuousBatcher(model, device="cpu", **kw).serve(_port_reqs(reqs))
    _assert_same(got, want)


def test_continuous_batcher_parks_idle_slots_and_caps_budgets(pair):
    """A run as long as max_len allows beside drained slots (parked before
    they reach max_len) and a budget capped by max_len: tokens equal the
    solo generate_cached decode, as the JAX batcher's do."""
    _, _, model = pair
    rs = np.random.RandomState(12)
    reqs = [Request(0, rs.randint(0, VOCAB, 5), MAX_LEN - 6),
            Request(1, rs.randint(0, VOCAB, MAX_LEN - 5), 1000),
            Request(2, rs.randint(0, VOCAB, 4), 3)]
    b = ContinuousBatcher(model, slots=3, segment=8, cache_bucket=32,
                          kv_dtype="int8", device="cpu")
    got = b.serve(_port_reqs(reqs))
    assert len(got[1]) == 5                     # capped at max_len - prompt
    for r in reqs:
        n = min(r.max_new, MAX_LEN - r.prompt.size)
        want = model.generate_cached(_t(r.prompt[None]), n,
                                     kv_dtype="int8")[0, r.prompt.size:]
        np.testing.assert_array_equal(got[r.rid], want.numpy())
    assert b.segments_by_len.keys() >= {32, 128}
    with pytest.raises(ValueError, match="empty prompt"):
        b.serve([Request(3, np.zeros((0,), np.int32), 4)])


def test_paged_batcher_int8_matches_jax(pair):
    """int8 pools: tokens equal the JAX PagedBatcher's, and the pool's
    tallies too, read bytes counted at H*(Dh+4) a row."""
    jmodel, jparams, model = pair
    reqs = _requests(13, 6, plen=(3, 40), gen=(1, 30))
    jb = JaxPagedBatcher(jmodel, jparams, slots=3, kv_dtype="int8", **POOL)
    want = jb.serve(_jax_reqs(reqs))
    b = PagedBatcher(model, slots=3, kv_dtype="int8", device="cpu", **POOL)
    got = b.serve(_port_reqs(reqs))
    _assert_same(got, want)
    pool, jpool = b.pool, jb.pool
    assert pool.pools["k0"].dtype == torch.int8
    assert pool.pools["k0_scale"].shape == (pool.pages, 8, H)
    # pages start at scale 1.0; the null page absorbs drained writes
    assert bool((pool.pools["v1_scale"] > 0).all())
    for name in ("segments_total", "occupancy_num", "prompt_tokens_total",
                 "read_bytes_total"):
        assert getattr(pool, name) == getattr(jpool, name), name
    assert pool.read_bytes_total == (2.0 * 3 * H * (D // H + 4) * L * 8
                                     * sum(n * 8 * c for n, c in
                                           pool.segments_by_pages.items()))


def test_engine_int8_matches_jax_engine(pair):
    """ServingEngine(kv_dtype="int8").step() on both sides: same tokens and
    reasons, every page back."""
    jmodel, jparams, model = pair
    rs = np.random.RandomState(14)
    work = [(rs.randint(0, VOCAB, int(rs.randint(3, 30))),
             int(rs.randint(2, 20))) for _ in range(4)]
    outs = []
    for eng in (JaxServingEngine(jmodel, jparams, slots=2, queue_cap=8,
                                 kv_dtype="int8", **POOL),
                ServingEngine(model, slots=2, queue_cap=8, kv_dtype="int8",
                              device="cpu", **POOL)):
        rids = [eng.submit(p, n) for p, n in work]
        while not all(eng.poll(r)[1] for r in rids):
            eng.step()
        outs.append([([int(t) for t in eng.poll(r)[0]], eng.poll(r)[2])
                     for r in rids])
        assert eng.pool.pages_used == 0
    assert outs[0] == outs[1]


class _ScriptedDraft:
    """A draft that always proposes one token no greedy row emits."""

    max_len = MAX_LEN

    def __init__(self, token, torch_side):
        self.token, self.torch_side = token, torch_side

    def prefill(self, *args):
        prompt = args[-1]
        if self.torch_side:
            return {"pos": torch.zeros(prompt.shape[0], dtype=torch.int32)}, \
                None
        return {"pos": jnp.zeros((prompt.shape[0],), jnp.int32)}, None

    def decode_step(self, *args):
        cell, tokens = args[-2:]
        if self.torch_side:
            out = torch.full((tokens.shape[0], VOCAB), -1.0)
            out[:, self.token] = 1.0
            return out, cell
        return jax.nn.one_hot(jnp.full_like(tokens, self.token), VOCAB), cell


def test_speculative_decoder_matches_jax(pair):
    """The int8 self-draft (partial or full acceptance) and a draft that is
    never accepted: tokens and stats equal the JAX decoder's, and tokens
    equal the target's greedy decode."""
    jmodel, jparams, model = pair
    prompt = np.random.RandomState(15).randint(0, VOCAB, (2, 7)).astype(
        np.int32)
    greedy = model.generate_cached(_t(prompt), 14).numpy()[:, 7:]
    jsd = JaxSpeculativeDecoder(jmodel, jparams, jmodel, jparams, k=4,
                                draft_kv_dtype="int8")
    sd = SpeculativeDecoder(model, model, k=4, draft_kv_dtype="int8")
    (jt, js), (t, s) = jsd.generate(prompt, 14), sd.generate(prompt, 14)
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_array_equal(t, greedy)
    assert s == js
    bad = int((greedy.max() + 1) % VOCAB)
    jsd = JaxSpeculativeDecoder(jmodel, jparams, _ScriptedDraft(bad, False),
                                None, k=4)
    sd = SpeculativeDecoder(model, _ScriptedDraft(bad, True), k=4)
    (jt, js), (t, s) = jsd.generate(prompt, 9), sd.generate(prompt, 9)
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_array_equal(t, greedy[:, :9])
    assert s == js and s["accepted"] == 0 and s["rounds"] == 8
    with pytest.raises(ValueError, match="max_len"):
        sd.generate(np.zeros((1, MAX_LEN - 6), np.int32), 10)
