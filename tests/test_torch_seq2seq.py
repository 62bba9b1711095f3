"""The port's beam search (paddle_tpu_torch/ops/beam_search.py) and
attention seq2seq NMT (models/seq2seq.py ``AttentionSeq2Seq``) against the
JAX package's, on the CPU, with the JAX weights carried across by
``convert.params_from_numpy``.

The model is small (vocab 50/40, embed 8, hidden 16, sources of length 0,
1 and the full width). On the CPU the encoder GRU runs the plain versions
of the GRU kernels, with the bias added to x@W before the recurrence; JAX
off the TPU runs its masked scan, which adds it after the product, so the
two round differently in the last bits. Tolerances: logits and loss atol
1e-5, gradients atol/rtol 2e-5 (f32, summation order and that rounding);
parameters after Adam steps atol 1e-5 and Adam moments 2e-5, as in
tests/test_torch_transformer_train.py. Generated tokens are equal, and
the scores agree to 1e-5. The beam search is held on a scripted decoder
step, the same numpy tables on both sides, token for token.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import SeqBatch as JSeqBatch
from paddle_tpu.models import AttentionSeq2Seq as JSeq2Seq
from paddle_tpu.ops import beam_search as JBS
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu_torch.convert import params_from_numpy, tree_from_numpy
from paddle_tpu_torch.core import SeqBatch
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.models import AttentionSeq2Seq, DecoderState
from paddle_tpu_torch.ops import beam_search as BS
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.trainer import Trainer

ATOL = 1e-5
GRAD_TOL = 2e-5
SRC_V, TRG_V, E, H = 50, 40, 8, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {"/".join(p): np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v) for p, v in tree_items(tree)}


def _assert_trees(got, want_jax, atol):
    g, w = _flat(got), _flat(_np(want_jax))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# beam and greedy search on a scripted decoder step
# ---------------------------------------------------------------------------

class _Cell(NamedTuple):
    h: object
    ctx: object


V, D = 9, 5


def _tables(seed=0):
    rs = np.random.RandomState(seed)
    return dict(emb=rs.randn(V, D).astype(np.float32),
                proj=rs.randn(D, V).astype(np.float32) * 1.5,
                ctx=rs.randn(3, 4, D).astype(np.float32) * 0.3,
                h0=rs.randn(3, D).astype(np.float32) * 0.5)


def _step(lib, t):
    """The same decoder step in JAX (lib=jnp) and in torch: h' = tanh(h +
    emb[tok] + mean(ctx)), log_softmax(h' @ proj); the cell is a
    NamedTuple with a [B, D] and a [B, 4, D] leaf."""
    if lib is jnp:
        emb, proj = jnp.asarray(t["emb"]), jnp.asarray(t["proj"])

        def step(cell, tokens):
            h = jnp.tanh(cell.h + emb[tokens] + cell.ctx.mean(1))
            return jax.nn.log_softmax(h @ proj), _Cell(h, cell.ctx)
        return step
    emb, proj = torch.tensor(t["emb"]), torch.tensor(t["proj"])

    def step(cell, tokens):
        h = torch.tanh(cell.h + emb[tokens.long()] + cell.ctx.mean(1))
        return torch.log_softmax(h @ proj, -1), _Cell(h, cell.ctx)
    return step


def _no_token_3_on_even_steps(lib):
    def fn(logits, step):
        if lib is jnp:
            return jnp.where((step % 2 == 0) & (jnp.arange(V) == 3), -1e9,
                             logits)
        return torch.where((step % 2 == 0) & (torch.arange(V) == 3),
                           torch.tensor(-1e9), logits)
    return fn


@pytest.mark.parametrize("beam,lp,constrained", [
    (3, 0.0, False), (4, 0.6, True), (1, 1.0, False), (5, 0.0, True)])
def test_beam_search_matches_jax(beam, lp, constrained):
    """Tokens equal, scores allclose, on a scripted step with a NamedTuple
    cell, an EOS that some beams reach, a constraint and the GNMT length
    penalty; the result is sorted best-first."""
    t = _tables()
    kw = dict(batch_size=3, beam_size=beam, max_len=7, vocab_size=V,
              bos_id=0, eos_id=1, length_penalty=lp)
    jt, js = JBS.beam_search(
        _Cell(jnp.asarray(t["h0"]), jnp.asarray(t["ctx"])), _step(jnp, t),
        constraint_fn=(_no_token_3_on_even_steps(jnp) if constrained
                       else None), **kw)
    pt, ps = BS.beam_search(
        _Cell(torch.tensor(t["h0"]), torch.tensor(t["ctx"])),
        _step(torch, t),
        constraint_fn=(_no_token_3_on_even_steps(torch) if constrained
                       else None), **kw)
    assert pt.dtype == torch.int32 and pt.shape == (3, beam, 7)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL,
                               rtol=ATOL)
    assert bool((ps[:, :-1] >= ps[:, 1:]).all())
    if constrained:
        assert not (pt[:, :, 0::2] == 3).any()


def test_greedy_search_matches_jax():
    t = _tables(1)
    kw = dict(batch_size=3, max_len=8, bos_id=0, eos_id=1)
    jt, js = JBS.greedy_search(
        _Cell(jnp.asarray(t["h0"]), jnp.asarray(t["ctx"])), _step(jnp, t),
        **kw)
    pt, ps = BS.greedy_search(
        _Cell(torch.tensor(t["h0"]), torch.tensor(t["ctx"])),
        _step(torch, t), **kw)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)


def test_search_helpers():
    """Constraint registry as in JAX; the tree map keeps NamedTuples,
    tuples, lists and dicts; the top-k keeps lower indices first among
    equal values and the beam gather reindexes axis 1 of every leaf."""
    fn = BS.register_constraint("test_id", lambda lg, s: lg)
    assert BS.CONSTRAINTS["test_id"] is fn

    @BS.register_constraint("test_deco")
    def deco(lg, s):
        return lg
    assert BS.CONSTRAINTS["test_deco"] is deco
    tree = {"a": _Cell(torch.ones(2), [torch.zeros(1), None])}
    out = BS.tree_map(lambda x: x + 1, tree)
    assert isinstance(out["a"], _Cell) and out["a"].ctx[1] is None
    assert out["a"].h.tolist() == [2.0, 2.0]
    with pytest.raises(TypeError):
        BS.tree_map(lambda x: x, {"a": 3})
    vals, idx = BS._top_k(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]
    x = torch.arange(12.0).reshape(2, 3, 2)
    g = BS._gather_beams({"x": x}, torch.tensor([[2, 0], [1, 1]]))["x"]
    assert g.tolist() == [[[4, 5], [0, 1]], [[8, 9], [8, 9]]]


# ---------------------------------------------------------------------------
# AttentionSeq2Seq
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s2s():
    jmodel = JSeq2Seq(SRC_V, TRG_V, embed_dim=E, hidden=H)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = AttentionSeq2Seq(SRC_V, TRG_V, embed_dim=E, hidden=H)
    return jmodel, jparams, params_from_numpy(_np(jparams), model, "cpu")


def _batch(seed, B=4, S=9, T=7):
    """(src, src_lens, trg_in, trg_out, trg_lens): sources of length 1,
    the full width and 0 (no encoder step: uniform attention over
    padding, as in JAX)."""
    rs = np.random.RandomState(seed)
    src = rs.randint(3, SRC_V, (B, S)).astype(np.int32)
    tin = rs.randint(3, TRG_V, (B, T)).astype(np.int32)
    tout = rs.randint(3, TRG_V, (B, T)).astype(np.int32)
    slen = rs.randint(1, S + 1, B).astype(np.int32)
    slen[:3] = (1, S, 0)
    tlen = rs.randint(1, T + 1, B).astype(np.int32)
    return src, slen, tin, tout, tlen


def _jargs(b):
    src, slen, tin, tout, tlen = (jnp.asarray(a) for a in b)
    return (JSeqBatch(src, slen), JSeqBatch(tin, tlen),
            JSeqBatch(tout, tlen))


def _targs(b):
    src, slen, tin, tout, tlen = (torch.from_numpy(a) for a in b)
    return SeqBatch(src, slen), SeqBatch(tin, tlen), SeqBatch(tout, tlen)


def test_params_carry_the_jax_tree(s2s):
    _, jparams, model = s2s
    assert set(_flat(model.tree())) == set(_flat(_np(jparams)))
    assert {"enc_w_f", "enc_u_b", "init_fc/w", "att_enc/w", "att_v",
            "dec_w", "out/b"} <= set(_flat(model.tree()))


def test_encode_logits_loss_and_grads_match_jax(s2s):
    jmodel, jparams, model = s2s
    batch = _batch(0)
    jsrc, jtin, jtout = _jargs(batch)
    src, tin, tout = _targs(batch)
    js, ps = jmodel.encode(jparams, jsrc), model.encode(src)
    assert isinstance(ps, DecoderState)
    for name, g, w in zip(DecoderState._fields, ps, js):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(model(src, tin).numpy(),
                               np.asarray(jmodel(jparams, jsrc, jtin)),
                               atol=ATOL, rtol=0)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jsrc, jtin, jtout))(jparams)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, src, tin, tout, method="loss")
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
    want = _flat(_np(jg))
    got = {"/".join(p): g.numpy()
           for (p, _), g in zip(tree_items(leaves), grads)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)
    # the scan route of the encoder (fused=False) is not what the model
    # runs: the kernels' route is; the plain route equals the default here
    np.testing.assert_allclose(
        model.loss(src, tin, tout, route="plain").item(), loss.item(),
        atol=0)


def test_decode_step_matches_jax(s2s):
    jmodel, jparams, model = s2s
    batch = _batch(1)
    jstate = jmodel.encode(jparams, _jargs(batch)[0])
    state = model.encode(_targs(batch)[0])
    tok = np.asarray([3, 7, 0, 39], np.int32)
    jl, jn = jmodel.decode_step(jparams, jstate, jmodel.trg_embed(
        jparams["trg_embed"], jnp.asarray(tok)))
    pl, pn = model.decode_step(state, model.trg_embed(torch.from_numpy(tok)))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pn.h.numpy(), np.asarray(jn.h), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("beam,lp", [(4, 0.0), (3, 0.6)])
def test_generate_matches_jax(s2s, beam, lp):
    jmodel, jparams, model = s2s
    batch = _batch(2)
    jt, js = jmodel.generate(jparams, _jargs(batch)[0], beam_size=beam,
                             max_len=8, length_penalty=lp)
    pt, ps = model.generate(_targs(batch)[0], beam_size=beam, max_len=8,
                            length_penalty=lp)
    assert not pt.requires_grad and pt.shape == (4, beam, 8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL,
                               rtol=ATOL)
    assert bool((ps[:, :-1] >= ps[:, 1:]).all())


def test_greedy_generate_matches_jax(s2s):
    jmodel, jparams, model = s2s
    batch = _batch(3)
    jt, js = jmodel.greedy_generate(jparams, _jargs(batch)[0], max_len=8)
    pt, ps = model.greedy_generate(_targs(batch)[0], max_len=8)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)


def test_trainer_adam_steps_match_jax(s2s):
    """One JAX Adam step, then the params and the Adam state carried
    across by ``convert``; two ``Trainer.step`` steps continue as two JAX
    steps do, at the benchmark's learning rate (benchmarks/seq2seq_nmt.py
    Adam 1e-3)."""
    jmodel, jparams, _ = s2s
    lr = 1e-3
    batches = [_batch(10 + i) for i in range(3)]
    jloss = lambda p, *b: jmodel.loss(p, *_jargs(b))
    jopt = JAdam(lr)
    js = jopt.init(jparams)
    jp, js = jopt.update(jax.grad(jloss)(jparams, *batches[0]), js, jparams)
    model = params_from_numpy(
        _np(jp), AttentionSeq2Seq(SRC_V, TRG_V, embed_dim=E, hidden=H), "cpu")
    state = tree_from_numpy(_np(js), "cpu")
    trainer = Trainer(lambda p, *b: model.call(p, *_targs(b), method="loss"),
                      Adam(lr), device="cpu")
    params = model.tree()
    for batch in batches[1:]:
        jp, js = jopt.update(jax.grad(jloss)(jp, *batch), js, jp)
        params, state, _ = trainer.step(params, state, *batch)
    assert int(state["step"]) == int(js["step"]) == 3
    _assert_trees(params, jp, ATOL)
    _assert_trees(state["slots"], js["slots"], GRAD_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_loss_matches_jax(s2s, seed):
    """The benchmark's bf16 recipe (benchmarks/seq2seq_nmt.py: float
    params cast to bf16): JAX takes ``log_softmax`` and the masked mean in
    the logits' dtype, and so does the port. Tolerance atol 1e-5: the two
    sides' bf16 logits agree to ~1e-5, far below the bf16 ulp of the
    per-token nll (2**-6 near log(40)), so every nll rounds to the same
    bf16 value and only the f32 mean's summation order is left. Taking
    the loss in f32 from the same bf16 logits (``token_cross_entropy``,
    which the transformer models use) lands over 1e-3 away, so the
    tolerance tells the two apart."""
    from paddle_tpu_torch.models.transformer import token_cross_entropy
    jmodel, jparams, model = s2s
    batch = _batch(20 + seed)
    j16 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        jparams)
    jl = float(jmodel.loss(j16, *_jargs(batch)).astype(jnp.float32))
    p16 = tree_map(lambda p: p.to(torch.bfloat16), model.tree())
    src, tin, tout = _targs(batch)
    loss = model.call(p16, src, tin, tout, method="loss")
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), jl, atol=1e-5, rtol=0)
    f32_way = token_cross_entropy(model.call(p16, src, tin), tout.data,
                                  tout.mask()).item()
    assert abs(f32_way - jl) > 1e-4
