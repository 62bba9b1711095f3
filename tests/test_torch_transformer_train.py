"""Training the port's transformers (paddle_tpu_torch/models/transformer.py
``loss``/``shifted_loss``, models/transformer_nmt.py ``TransformerSeq2Seq``)
against the JAX models, on the CPU, with the JAX weights and Adam state
carried across by ``convert``.

The LM is the tiny serving model of tests/conftest.py (vocab 97, D 32,
H 4, L 2, max_len 128); the NMT model has 2+2 layers (D 32, H 4, vocab
50/60, max_len 16) and short source lengths, among them 0 and 1. On the CPU
attention runs the plain versions of the flash kernels (forward and
backward); JAX differentiates its dense route at these lengths, which
computes the same function. Tolerances: f32 losses and logits atol 1e-5,
gradients atol 2e-5 (both sides f32, summation order only); parameters
after Adam steps atol 1e-5 and Adam moments atol 2e-5, as in
tests/test_torch_text_cls.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import SeqBatch as JSeqBatch
from paddle_tpu.models import TransformerSeq2Seq as JSeq2Seq
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu_torch.convert import (params_from_numpy, port_tree,
                                      tree_from_numpy)
from paddle_tpu_torch.core import SeqBatch
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.models import TransformerLM, TransformerSeq2Seq
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.trainer import Trainer

ATOL = 1e-5
GRAD_ATOL = 2e-5
VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
SRC_V, TRG_V, NMT_LEN = 50, 60, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{"a/b": numpy} of a port tree (tensors) or a JAX tree in the port's
    layout."""
    return {"/".join(p): np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v) for p, v in tree_items(tree)}


def _assert_trees(got, want_jax, atol):
    g, w = _flat(got), _flat(port_tree(_np(want_jax)))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=atol,
                                   err_msg=k)


def _grads(loss, leaves):
    gs = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
    return {"/".join(p): g for (p, _), g in zip(tree_items(leaves), gs)}


def _value_and_grad(model, *args, method="loss"):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, *args, method=method)
    return loss, _grads(loss, leaves)


def _assert_grads(got, want_jax):
    want = _flat(port_tree(_np(want_jax)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm(paged_model_and_params):
    jmodel, jparams = paged_model_and_params
    model = TransformerLM(VOCAB, d_model=D, n_heads=H, n_layers=L,
                          max_len=MAX_LEN)
    return jmodel, jparams, params_from_numpy(_np(jparams), model, "cpu")


def _ids(seed, B=3, T=21):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("lengths", [None, [21, 9, 2]])
def test_lm_loss_and_grads_match_jax(lm, lengths):
    jmodel, jparams, model = lm
    ids = _ids(0)
    lens_j = None if lengths is None else jnp.asarray(lengths)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jnp.asarray(ids), lens_j))(jparams)
    lens_t = None if lengths is None else torch.tensor(lengths)
    loss, grads = _value_and_grad(model, torch.from_numpy(ids), lens_t)
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    _assert_grads(grads, jg)
    # the method run directly equals the functional call
    np.testing.assert_allclose(model.loss(torch.from_numpy(ids),
                                          lens_t).item(), loss.item(),
                               atol=0)


def test_lm_shifted_loss_with_a_mask_matches_jax(lm):
    jmodel, jparams, model = lm
    ids = _ids(1, T=18)
    mask = np.random.RandomState(2).rand(3, 17) > 0.3
    args = (ids[:, :-1], ids[:, 1:])

    def jloss(p):
        return jmodel.shifted_loss(p, *(jnp.asarray(a) for a in args),
                                   mask=jnp.asarray(mask))
    jl, jg = jax.value_and_grad(jloss)(jparams)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, *(torch.from_numpy(a) for a in args),
                      mask=torch.from_numpy(mask), method="shifted_loss")
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    _assert_grads(_grads(loss, leaves), jg)


def test_lm_all_masked_loss_is_zero_not_nan(lm):
    """The mean divides by max(mask sum, 1), as in JAX."""
    _, _, model = lm
    ids = torch.from_numpy(_ids(3))
    loss = model.loss(ids, torch.tensor([1, 1, 0]))
    assert loss.item() == 0.0


def test_lm_loss_refuses_sequence_sharding(lm):
    _, _, model = lm
    ids = torch.from_numpy(_ids(4))
    with pytest.raises(ValueError, match="sequence sharding"):
        model.loss(ids, seq_axis="seq")
    # explicit positions alone are JAX's default ones: the same loss
    torch.testing.assert_close(
        model.shifted_loss(ids[:, :-1], ids[:, 1:],
                           positions=torch.arange(20)),
        model.shifted_loss(ids[:, :-1], ids[:, 1:]), rtol=0, atol=0)


def test_lm_forward_is_differentiable_and_serving_is_not(lm):
    _, _, model = lm
    ids = torch.from_numpy(_ids(5))
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    logits = model.call(leaves, ids)
    assert logits.requires_grad and logits.shape == (3, 21, VOCAB)
    cell, last = model.prefill(ids)
    assert not last.requires_grad


# ---------------------------------------------------------------------------
# the NMT model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nmt():
    jmodel = JSeq2Seq(SRC_V, TRG_V, d_model=D, n_heads=H, n_enc=2, n_dec=2,
                      max_len=NMT_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    model = TransformerSeq2Seq(SRC_V, TRG_V, d_model=D, n_heads=H, n_enc=2,
                               n_dec=2, max_len=NMT_LEN)
    return jmodel, jparams, params_from_numpy(_np(jparams), model, "cpu")


def _nmt_batch(seed, B=4, S=12, T=10):
    """(src, src_lens, trg_in, trg_out, trg_lens) numpy arrays; sources of
    length 0 (no key: its attention outputs are zeroed), 1 and the full
    width."""
    rs = np.random.RandomState(seed)
    src = rs.randint(3, SRC_V, (B, S)).astype(np.int32)
    tin = rs.randint(3, TRG_V, (B, T)).astype(np.int32)
    tout = rs.randint(3, TRG_V, (B, T)).astype(np.int32)
    slen = rs.randint(1, S + 1, B).astype(np.int32)
    slen[:3] = (1, S, 0)
    tlen = rs.randint(1, T + 1, B).astype(np.int32)
    return src, slen, tin, tout, tlen


def _jnmt_args(b):
    src, slen, tin, tout, tlen = (jnp.asarray(a) for a in b)
    return (JSeqBatch(src, slen), JSeqBatch(tin, tlen),
            JSeqBatch(tout, tlen))


def _nmt_args(b):
    src, slen, tin, tout, tlen = (torch.from_numpy(a) for a in b)
    return SeqBatch(src, slen), SeqBatch(tin, tlen), SeqBatch(tout, tlen)


def test_nmt_params_carry_the_jax_tree(nmt):
    _, jparams, model = nmt
    names = set(_flat(model.tree()))
    assert names == set(_flat(port_tree(_np(jparams))))
    assert {"enc_blocks/1/qkv/w", "dec_blocks/0/kv_x/w", "src_pos",
            "trg_embed/w", "ln_enc/gamma"} <= names


def test_nmt_logits_loss_and_grads_match_jax(nmt):
    jmodel, jparams, model = nmt
    batch = _nmt_batch(0)
    jsrc, jtin, jtout = _jnmt_args(batch)
    src, tin, tout = _nmt_args(batch)
    np.testing.assert_allclose(model(src, tin).numpy(),
                               np.asarray(jmodel(jparams, jsrc, jtin)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(model.encode(src).numpy(),
                               np.asarray(jmodel.encode(jparams, jsrc)),
                               atol=ATOL, rtol=0)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jsrc, jtin, jtout))(jparams)
    loss, grads = _value_and_grad(model, src, tin, tout)
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    _assert_grads(grads, jg)


def test_nmt_greedy_generate_matches_jax(nmt):
    jmodel, jparams, model = nmt
    batch = _nmt_batch(1)
    want = jmodel.greedy_generate(jparams, _jnmt_args(batch)[0], max_len=6)
    got = model.greedy_generate(_nmt_args(batch)[0], max_len=6)
    assert got.dtype == torch.int32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Adam through Trainer from a carried-across JAX state
# ---------------------------------------------------------------------------

def _lm_case(lm):
    jmodel, jparams, _ = lm
    batches = [(_ids(10 + i),) for i in range(4)]
    jloss = lambda p, ids: jmodel.loss(p, jnp.asarray(ids))
    model = TransformerLM(VOCAB, d_model=D, n_heads=H, n_layers=L,
                          max_len=MAX_LEN)
    loss = lambda p, ids: model.call(p, ids, method="loss")
    to_t = lambda b: tuple(torch.from_numpy(a) for a in b)
    return jparams, jloss, model, loss, batches, to_t, 3e-4


def _nmt_case(nmt):
    jmodel, jparams, _ = nmt
    batches = [_nmt_batch(10 + i) for i in range(4)]
    jloss = lambda p, *b: jmodel.loss(p, *_jnmt_args(b))
    model = TransformerSeq2Seq(SRC_V, TRG_V, d_model=D, n_heads=H, n_enc=2,
                               n_dec=2, max_len=NMT_LEN)
    loss = lambda p, *b: model.call(p, *_nmt_args(b), method="loss")
    return jparams, jloss, model, loss, batches, lambda b: b, 1e-3


@pytest.mark.parametrize("which", ["lm", "nmt"])
def test_adam_steps_from_a_carried_jax_state_match_jax(lm, nmt, which):
    """One JAX Adam step, then the params and the Adam state (``slots/
    blocks_0/qkv/w/m`` ...) carried across by ``convert``; three
    ``Trainer.step`` steps continue as three JAX steps do. The learning
    rates are the benchmarks' (benchmarks/transformer_lm.py,
    transformer_nmt.py): the key bias's gradient is zero analytically
    (softmax is shift-invariant) and rounding noise of ~1e-12 in both
    frameworks, which Adam divides by eps = 1e-8, so that bias moves by
    up to ~lr * 1e-3 a step in a direction neither side controls."""
    jp, jloss, model, loss, batches, to_t, lr = (
        _lm_case(lm) if which == "lm" else _nmt_case(nmt))
    jopt = JAdam(lr)
    js = jopt.init(jp)
    jp, js = jopt.update(jax.grad(jloss)(jp, *batches[0]), js, jp)
    model = params_from_numpy(_np(jp), model, "cpu")
    state = tree_from_numpy(_np(js), "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    assert set(_flat(state["slots"])) == set(
        _flat(Adam().init(model.tree())["slots"]))
    trainer = Trainer(loss, Adam(lr), device="cpu")
    params = model.tree()
    for batch in batches[1:]:
        jp, js = jopt.update(jax.grad(jloss)(jp, *batch), js, jp)
        params, state, _ = trainer.step(params, state, *to_t(batch))
    assert int(state["step"]) == int(js["step"]) == 4
    _assert_trees(params, jp, ATOL)
    _assert_trees(state["slots"], js["slots"], GRAD_ATOL)


def test_port_tree_renames_block_lists_at_any_depth():
    leaf = np.zeros(2)
    tree = {"step": leaf, "slots": {"blocks_0": {"w": {"m": leaf}},
                                    "blocks_10": {"w": {"m": leaf}},
                                    "enc_blocks_1": {"b": leaf},
                                    "w0": leaf, "kv_x": {"w": leaf}}}
    assert set(_flat(port_tree(tree))) == {
        "step", "slots/blocks/0/w/m", "slots/blocks/10/w/m",
        "slots/enc_blocks/1/b", "slots/w0", "slots/kv_x/w"}
