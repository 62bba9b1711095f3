"""The port's model zoo (paddle_tpu_torch/models/tagger.py, embeddings.py,
generative.py, ``ConvTextCls`` in text_cls.py, ``TransformerLM``'s
``tie_head=False`` and ``remat=True``) against the JAX package's, on the
CPU, with the JAX weights carried across by
``convert.params_from_numpy``.

Small sizes (vocab <= 100, widths <= 32, batch 5-6). For each model:
the forward, the loss and every gradient, then one Adam step through the
port's ``Trainer`` against JAX's ``Adam.update``; the taggers' Viterbi
``decode`` must equal JAX's tags. Tolerances: f32 values atol 1e-5 and
gradients atol 2e-5 of the reference's largest magnitude (at least 1),
rtol alike — both sides f32, summation order only; parameters after the
Adam step atol 1e-5 (Adam's first step is about lr * sign(g), so a
gradient that differs only in rounding moves a parameter by far less).
The VAE's noise is JAX's own draw, rebuilt from its key with the call
JAX makes, and fed to the port's arithmetic. ``remat=True`` must equal
``remat=False`` bit for bit, loss and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as JMOD
from paddle_tpu.core import SeqBatch as JSeqBatch
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu_torch import models as MOD
from paddle_tpu_torch.convert import params_from_numpy, port_tree
from paddle_tpu_torch.core import SeqBatch
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.trainer import Trainer

ATOL, GRAD_ATOL = 1e-5, 2e-5
B, T = 6, 7
LENS = np.array([7, 1, 4, 0, 5, 7], np.int32)


def _flat(tree):
    return {"/".join(p): np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v, np.float32) for p, v in tree_items(tree)}


def close(got, want, atol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=atol, atol=atol * scale)


def _jflat(tree):
    """A JAX tree's leaves by the port's paths (``blocks_{i}`` ->
    ``blocks/{i}``)."""
    return _flat(port_tree(jax.tree_util.tree_map(np.asarray, tree)))


def trees_close(got, want, atol):
    g = _flat(got)
    w = _jflat(want)
    assert g.keys() == w.keys()
    for k in w:
        close(g[k], w[k], atol)


def _ids(rs, vocab, shape):
    return rs.randint(0, vocab, shape).astype(np.int32)


# name -> (JAX model, port model, batch(rs) -> numpy args, JAX loss
# (jm, params, *args), port loss (model, tree, *tensors))
def _seq_loss_j(jm, p, d, l, *rest):
    return jm.loss(p, JSeqBatch(d, l), *(JSeqBatch(r, l) if r.ndim == 2
                                          else r for r in rest))


def _seq_loss_t(m, p, d, l, *rest):
    method = "forward" if isinstance(m, MOD.ConvTextCls) else "loss"
    return m.call(p, SeqBatch(d, l), *rest, method=method)


MODELS = {
    "linear_crf": (
        lambda: JMOD.LinearCRFTagger(50, 5, embed_dim=8),
        lambda: MOD.LinearCRFTagger(50, 5, embed_dim=8),
        lambda rs: [_ids(rs, 50, (B, T)), LENS, _ids(rs, 5, (B, T))],
        _seq_loss_j, _seq_loss_t),
    "bilstm_crf": (
        lambda: JMOD.BiLSTMCRFTagger(50, 5, embed_dim=8, hidden=8),
        lambda: MOD.BiLSTMCRFTagger(50, 5, embed_dim=8, hidden=8),
        lambda rs: [_ids(rs, 50, (B, T)), LENS, _ids(rs, 5, (B, T))],
        _seq_loss_j, _seq_loss_t),
    "conv_textcls": (
        lambda: JMOD.ConvTextCls(50, embed_dim=8, num_filters=6,
                                 context_len=3, classes=3),
        lambda: MOD.ConvTextCls(50, embed_dim=8, num_filters=6,
                                context_len=3, classes=3),
        lambda rs: [_ids(rs, 50, (B, T)), np.maximum(LENS, 1),
                    _ids(rs, 3, (B,))],
        _seq_loss_j, _seq_loss_t),
    "word2vec": (
        lambda: JMOD.Word2Vec(40, embed_dim=6, context=4, hidden=10),
        lambda: MOD.Word2Vec(40, embed_dim=6, context=4, hidden=10),
        lambda rs: [_ids(rs, 40, (B, 4)), _ids(rs, 40, (B,))],
        lambda jm, p, *a: jm.loss(p, *a),
        lambda m, p, *a: m.call(p, *a, method="loss")),
    "recommender": (
        lambda: JMOD.Recommender(20, 30, 7, 5, 4, dim=8),
        lambda: MOD.Recommender(20, 30, 7, 5, 4, dim=8),
        lambda rs: [_ids(rs, 20, (B,)), _ids(rs, 2, (B,)),
                    _ids(rs, 4, (B,)), _ids(rs, 5, (B,)),
                    _ids(rs, 30, (B,)), _ids(rs, 7, (B, 3)),
                    (rs.rand(B, 3) > 0.4).astype(np.float32),
                    rs.uniform(1, 5, B).astype(np.float32)],
        lambda jm, p, *a: jm.loss(p, *a),
        lambda m, p, *a: m.call(p, *a, method="loss")),
    "deepfm": (
        lambda: JMOD.DeepFM(100, 5, 3, factor=4, hidden=(8, 6)),
        lambda: MOD.DeepFM(100, 5, 3, factor=4, hidden=(8, 6)),
        lambda rs: [rs.randn(B, 3).astype(np.float32),
                    _ids(rs, 100, (B, 5)), _ids(rs, 2, (B,))],
        lambda jm, p, *a: jm.loss(p, *a),
        lambda m, p, *a: m.call(p, *a, method="loss")),
    "gan_d": (
        lambda: JMOD.GAN(data_dim=12, noise_dim=4, hidden=8),
        lambda: MOD.GAN(data_dim=12, noise_dim=4, hidden=8),
        lambda rs: [np.tanh(rs.randn(B, 12)).astype(np.float32),
                    rs.randn(B, 4).astype(np.float32)],
        lambda jm, p, *a: jm.d_loss(p, *a),
        lambda m, p, *a: m.call(p, *a, method="d_loss")),
    "gan_g": (
        lambda: JMOD.GAN(data_dim=12, noise_dim=4, hidden=8),
        lambda: MOD.GAN(data_dim=12, noise_dim=4, hidden=8),
        lambda rs: [rs.randn(B, 4).astype(np.float32)],
        lambda jm, p, *a: jm.g_loss(p, *a),
        lambda m, p, *a: m.call(p, *a, method="g_loss")),
    "lm_untied": (
        lambda: JMOD.TransformerLM(61, d_model=32, n_heads=4, n_layers=2,
                                   max_len=16, tie_head=False),
        lambda: MOD.TransformerLM(61, d_model=32, n_heads=4, n_layers=2,
                                  max_len=16, tie_head=False),
        lambda rs: [_ids(rs, 61, (3, 9))],
        lambda jm, p, *a: jm.loss(p, *a),
        lambda m, p, *a: m.call(p, *a, method="loss")),
}


def _pair(name, seed=0):
    jf, pf = MODELS[name][:2]
    jm, pm = jf(), pf()
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, params_from_numpy(tree, pm, "cpu")


def _batch(name, seed=1):
    return MODELS[name][2](np.random.RandomState(seed))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_grads_match_jax(name):
    jm, jp, model = _pair(name)
    _, _, _, jloss, tloss = MODELS[name]
    args = _batch(name)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, *a: jloss(jm, p, *a)))(jp, *map(jnp.asarray, args))
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = tloss(model, leaves, *map(torch.tensor, args))
    close(loss, jl, ATOL)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)],
                                materialize_grads=True)
    got = dict(zip(_flat(leaves), grads))
    want = _jflat(jg)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], GRAD_ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_adam_step_matches_jax(name):
    jm, jp, model = _pair(name, seed=2)
    _, _, _, jloss, tloss = MODELS[name]
    args = _batch(name, seed=3)
    jopt, opt = JAdam(2e-3), Adam(2e-3)
    g = jax.jit(jax.grad(lambda p, *a: jloss(jm, p, *a)))(
        jp, *map(jnp.asarray, args))
    jp, js = jax.jit(jopt.update)(g, jopt.init(jp), jp)
    trainer = Trainer(lambda p, *a: tloss(model, p, *a), opt, device="cpu")
    params, state, _ = trainer.step(model.tree(), opt.init(model.tree()),
                                    *map(torch.tensor, args))
    trees_close(params, jp, ATOL)
    trees_close(state["slots"], js["slots"], GRAD_ATOL)


def _forwards():
    """name -> (JAX forward(jm, p, *args), port forward(model, *tensors)),
    over the batch's leading args."""
    sb = lambda d, l: JSeqBatch(d, l)
    return {
        "bilstm_crf": (lambda jm, p, d, l, t: jm.emissions(p, sb(d, l)),
                       lambda m, d, l, t: m(SeqBatch(d, l))),
        "conv_textcls": (lambda jm, p, d, l, y: jm(p, sb(d, l)),
                         lambda m, d, l, y: m(SeqBatch(d, l))),
        "word2vec": (lambda jm, p, c, y: jm(p, c),
                     lambda m, c, y: m(c)),
        "recommender": (lambda jm, p, *a: jm(p, *a[:-1]),
                        lambda m, *a: m(*a[:-1])),
        "deepfm": (lambda jm, p, d, f, y: jm.predict_proba(p, d, f),
                   lambda m, d, f, y: m.predict_proba(d, f)),
        "gan_g": (lambda jm, p, z: jm.generate(p, z),
                  lambda m, z: m.generate(z)),
        "lm_untied": (lambda jm, p, ids: jm(p, ids),
                      lambda m, ids: m(ids)),
    }


FORWARDS = _forwards()


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_matches_jax(name):
    jm, jp, model = _pair(name, seed=4)
    jf, tf = FORWARDS[name]
    args = _batch(name, seed=5)
    with torch.no_grad():
        got = tf(model, *map(torch.tensor, args))
    close(got, jax.jit(lambda p, *a: jf(jm, p, *a))(
        jp, *map(jnp.asarray, args)), ATOL)


@pytest.mark.parametrize("name", ["linear_crf", "bilstm_crf"])
def test_tagger_decode_matches_jax(name):
    jm, jp, model = _pair(name, seed=6)
    d, l, _ = _batch(name, seed=7)
    jt, js = jax.jit(lambda p, a, b: jm.decode(p, JSeqBatch(a, b)))(
        jp, jnp.asarray(d), jnp.asarray(l))
    tt, ts = model.decode(SeqBatch(torch.tensor(d), torch.tensor(l)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    close(ts, js, ATOL)
    assert not tt[l == 0].any()


def test_discriminator_and_generator_halves_split_as_jax():
    """d_loss leaves G's gradient zero (the fake is detached);
    split_grads gives the g* and d* subtrees, JAX's."""
    jm, jp, model = _pair("gan_d")
    real, z = map(torch.tensor, _batch("gan_d"))
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, real, z, method="d_loss")
    flat = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)],
                               materialize_grads=True)
    gtree = {}
    for (path, _), g in zip(tree_items(leaves), flat):
        gtree.setdefault(path[0], {})[path[1]] = g
    g_half, d_half = MOD.GAN.split_grads(gtree)
    jg, jd = JMOD.GAN.split_grads(jp)
    assert sorted(g_half) == sorted(jg) == ["g1", "g2", "g3"]
    assert sorted(d_half) == sorted(jd) == ["d1", "d2", "d3"]
    assert all(not v.any() for sub in g_half.values() for v in sub.values())
    assert any(v.any() for sub in d_half.values() for v in sub.values())


def test_vae_loss_on_jax_noise_matches_jax():
    jm, pm = JMOD.VAE(data_dim=12, latent=3, hidden=8), MOD.VAE(
        data_dim=12, latent=3, hidden=8)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), pm,
                              "cpu")
    x = np.tanh(np.random.RandomState(8).randn(B, 12)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, (B, 3)))   # JAX's draw
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(x), key)))(jp)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, torch.tensor(x), torch.tensor(eps),
                      method="_loss_from_eps")
    close(loss, jl, ATOL)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
    got = dict(zip(_flat(leaves), grads))
    for k, w in _jflat(jg).items():
        close(got[k], w, GRAD_ATOL)
    # the generator's draw: the same generator state, the same loss
    l1 = model.loss(torch.tensor(x), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    e = torch.randn((B, 3), generator=g)
    assert torch.equal(l1, model._loss_from_eps(torch.tensor(x), e))
    s = model.sample(torch.Generator().manual_seed(1), 4)
    assert s.shape == (4, 12) and (s >= 0).all() and (s <= 1).all()


def test_lm_remat_equals_the_plain_forward_bit_for_bit():
    kw = dict(d_model=32, n_heads=4, n_layers=2, max_len=16)
    plain = MOD.TransformerLM(61, **kw).init(seed=3, device="cpu")
    remat = MOD.TransformerLM(61, remat=True, **kw).init(seed=3,
                                                         device="cpu")
    ids = torch.tensor(_ids(np.random.RandomState(10), 61, (3, 9)))
    out = []
    for m in (plain, remat):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                          m.tree())
        loss = m.call(leaves, ids, method="loss")
        out.append((loss, torch.autograd.grad(
            loss, [v for _, v in tree_items(leaves)])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    # through the trainer, whose tree differs from the module's own
    # weights after a step: the recompute reads the tree's leaves
    for m in (plain, remat):
        tr = Trainer(lambda p, x, m=m: m.call(p, x, method="loss"),
                     Adam(1e-2), device="cpu")
        p, s = m.tree(), Adam(1e-2).init(m.tree())
        for _ in range(2):
            p, s, cost = tr.step(p, s, ids)
        m.last = (cost, p)
    assert torch.equal(plain.last[0], remat.last[0])
    for (k, a), (_, b) in zip(tree_items(plain.last[1]),
                              tree_items(remat.last[1])):
        assert torch.equal(a, b), k


def test_lm_remat_matches_jax():
    jm = JMOD.TransformerLM(61, d_model=32, n_heads=4, n_layers=2,
                            max_len=16, remat=True)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    model = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp),
        MOD.TransformerLM(61, d_model=32, n_heads=4, n_layers=2, max_len=16,
                          remat=True), "cpu")
    ids = _ids(np.random.RandomState(11), 61, (3, 9))
    jl, jg = jax.jit(jax.value_and_grad(lambda p, i: jm.loss(p, i)))(
        jp, jnp.asarray(ids))
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, torch.tensor(ids), method="loss")
    close(loss, jl, ATOL)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
    got = dict(zip(_flat(leaves), grads))
    want = _jflat(jg)
    for k in want:
        close(got[k], want[k], GRAD_ATOL)


def test_untied_head_is_used_by_the_decode_methods():
    model = MOD.TransformerLM(61, d_model=32, n_heads=4, n_layers=2,
                              max_len=16, tie_head=False).init(0, "cpu")
    assert model.head.w.shape == (32, 61)
    ids = torch.tensor(_ids(np.random.RandomState(12), 61, (2, 5)))
    with torch.no_grad():
        full = model(ids)
        cell, last = model.prefill(ids, pad_to=16)
        torch.testing.assert_close(last, full[:, -1], atol=1e-5, rtol=1e-5)
        nxt = torch.argmax(last, -1)
        step, _ = model.decode_step(cell, nxt)
        ref = model(torch.cat([ids, nxt[:, None]], 1))[:, -1]
        torch.testing.assert_close(step, ref, atol=1e-5, rtol=1e-5)
