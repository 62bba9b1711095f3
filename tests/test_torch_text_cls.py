"""The port's text classifiers, optimizers and trainer
(paddle_tpu_torch/models/text_cls.py, optimizer/, trainer/) against the
JAX package's, on the CPU, with the JAX weights and optimizer state
carried across by ``convert``.

Small sizes (vocab 64, embed 8, hidden 16, batch 5-6, length <= 12). On
the CPU the LSTM runs the plain versions of its kernels. Tolerances: f32
logits and loss atol 1e-5, gradients atol 2e-5 (both sides f32, summation
order only); parameters after Adam steps atol 1e-5 — Adam's first steps
are ~lr*sign(g), so a gradient that differs only in rounding moves a
parameter by far less than that; per-step training costs atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import SeqBatch as JSeqBatch
from paddle_tpu.models import BiLSTMTextCls as JBiLSTM
from paddle_tpu.models import LSTMTextCls as JLSTM
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu_torch.convert import params_from_numpy, tree_from_numpy
from paddle_tpu_torch.core import SeqBatch
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.models import BiLSTMTextCls, LSTMTextCls
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.trainer import Trainer, event

VOCAB, EMBED, HIDDEN = 64, 8, 16
ATOL = 1e-5
GRAD_ATOL = 2e-5


class JLastSeq(JLSTM):
    """The last-step variant of benchmarks/lstm_textcls.py."""

    def __call__(self, params, batch, **kw):
        from paddle_tpu.ops import rnn as R
        from paddle_tpu.ops import sequence as S
        h = self.embed(params["embed"], batch.data)
        for i in range(self.num_layers):
            h, _ = R.lstm(h, batch.lengths, params[f"w{i}"],
                          params[f"u{i}"], params[f"b{i}"], forget_bias=1.0)
        return self.fc(params["fc"], S.sequence_last_step(h, batch.lengths))


# name -> (JAX model, port model)
MODELS = {
    "max_1layer": (lambda: JLSTM(VOCAB, EMBED, HIDDEN),
                   lambda: LSTMTextCls(VOCAB, EMBED, HIDDEN)),
    "max_2layer": (lambda: JLSTM(VOCAB, EMBED, HIDDEN, num_layers=2),
                   lambda: LSTMTextCls(VOCAB, EMBED, HIDDEN, num_layers=2)),
    "last": (lambda: JLastSeq(VOCAB, EMBED, HIDDEN),
             lambda: LSTMTextCls(VOCAB, EMBED, HIDDEN, pool="last")),
    "bilstm": (lambda: JBiLSTM(VOCAB, EMBED, HIDDEN),
               lambda: BiLSTMTextCls(VOCAB, EMBED, HIDDEN)),
}


def _pair(name, seed=0):
    jm, pm = (f() for f in MODELS[name])
    jp = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, params_from_numpy(tree, pm, "cpu")


def _batches(n, B=6, T=12, seed=1):
    """(data, lengths, labels) numpy batches with lengths 0, 1 and T."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rs.randint(1, T + 1, B).astype(np.int32)
        lens[:3] = (0, 1, T)
        out.append((rs.randint(0, VOCAB, (B, T)).astype(np.int32), lens,
                    rs.randint(0, 2, B).astype(np.int32)))
    return out


def _jloss(jm):
    def loss(p, data, lengths, labels):
        return jm.loss(p, JSeqBatch(data, lengths), labels)
    return loss


def _loss(model, route=None):
    def loss(p, data, lengths, labels):
        return model.call(p, SeqBatch(data, lengths), labels, route=route)
    return loss


def _t(batch):
    return tuple(torch.tensor(a) for a in batch)


def _flat(tree):
    return {"/".join(p): np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v) for p, v in tree_items(tree)}


def _assert_trees(got, want, atol):
    g, w = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=atol,
                                   err_msg=k)


def test_params_carry_the_jax_tree():
    jm, jp, model = _pair("max_2layer")
    assert set(_flat(model.tree())) == set(
        _flat(jax.tree_util.tree_map(np.asarray, jp)))
    assert set(_flat(model.tree())) == {
        "embed/w", "w0", "u0", "b0", "w1", "u1", "b1", "fc/w", "fc/b"}
    assert model.w0.shape == (EMBED, 4 * HIDDEN)
    assert model.fc.w.shape == (HIDDEN, 2)              # [in, out]


def test_init_draws_the_jax_distributions():
    """uniform(-0.08, 0.08) LSTM weights, zero biases, normal(0, 0.01)
    embedding, xavier-uniform head, as the JAX model declares them."""
    m = LSTMTextCls(VOCAB, EMBED, HIDDEN).init(seed=3, device="cpu")
    assert m.u0.abs().max() <= 0.08 and m.u0.std() > 0.03
    assert not m.b0.any() and not m.fc.b.any()
    assert abs(m.embed.w.std().item() - 0.01) < 2e-3
    limit = (6.0 / (HIDDEN + 2)) ** 0.5
    assert m.fc.w.abs().max() <= limit


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_loss_and_grads_match_jax(name):
    jm, jp, model = _pair(name)
    data, lengths, labels = _batches(1)[0]
    sb_j = JSeqBatch(jnp.asarray(data), jnp.asarray(lengths))
    sb = SeqBatch(torch.tensor(data), torch.tensor(lengths))
    np.testing.assert_allclose(model(sb).numpy(), np.asarray(jm(jp, sb_j)),
                               atol=ATOL, rtol=ATOL)
    jl, jg = jax.value_and_grad(_jloss(jm))(jp, *(jnp.asarray(a) for a in
                                                  (data, lengths, labels)))
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    loss = model.call(leaves, sb, torch.tensor(labels))
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
    got = dict(zip(_flat(leaves), grads))
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["max_1layer", "last", "bilstm"])
def test_adam_steps_match_jax(name, steps):
    """Params and Adam state (step, m, v) after ``steps`` steps over
    distinct batches, from the same params."""
    jm, jp, model = _pair(name)
    jopt, opt = JAdam(2e-3), Adam(2e-3)
    js = jopt.init(jp)
    trainer = Trainer(_loss(model), opt, device="cpu")
    params, state = model.tree(), opt.init(model.tree())
    for batch in _batches(steps):
        g = jax.grad(_jloss(jm))(jp, *(jnp.asarray(a) for a in batch))
        jp, js = jopt.update(g, js, jp)
        params, state, _ = trainer.step(params, state, *_t(batch))
    assert int(state["step"]) == int(js["step"]) == steps
    assert state["step"].dtype == torch.int32
    _assert_trees(params, jp, ATOL)
    _assert_trees(state["slots"], js["slots"], GRAD_ATOL)


def test_adam_state_carries_across_from_jax():
    """A JAX Adam state after two steps, carried over by
    ``tree_from_numpy``, continues into the same third step."""
    jm, jp, model = _pair("last", seed=2)
    jopt = JAdam(2e-3)
    js = jopt.init(jp)
    b1, b2, b3 = _batches(3, seed=4)
    for batch in (b1, b2):
        g = jax.grad(_jloss(jm))(jp, *(jnp.asarray(a) for a in batch))
        jp, js = jopt.update(g, js, jp)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    model = params_from_numpy(to_np(jp), model, "cpu")
    state = tree_from_numpy(to_np(js), "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 2
    g = jax.grad(_jloss(jm))(jp, *(jnp.asarray(a) for a in b3))
    jp, js = jopt.update(g, js, jp)
    trainer = Trainer(_loss(model), Adam(2e-3), device="cpu")
    params, state, _ = trainer.step(model.tree(), state, *_t(b3))
    _assert_trees(params, jp, ATOL)


def test_sgd_with_weight_decay_and_a_schedule_matches_jax():
    jm, jp, model = _pair("max_1layer")
    sched_j = lambda step: 0.1 / step
    sched = lambda step: 0.1 / step
    jopt = JSGD(sched_j, weight_decay=0.01)
    opt = SGD(sched, weight_decay=0.01)
    js, state = jopt.init(jp), opt.init(model.tree())
    params = model.tree()
    trainer = Trainer(_loss(model), opt, device="cpu")
    for batch in _batches(2, seed=5):
        g = jax.grad(_jloss(jm))(jp, *(jnp.asarray(a) for a in batch))
        jp, js = jopt.update(g, js, jp)
        params, state, _ = trainer.step(params, state, *_t(batch))
    _assert_trees(params, jp, ATOL)


def test_optimizer_passes_stats_through():
    params = {"w": torch.ones(3), "bn": {"stats": {"mean": torch.ones(2)}}}
    grads = tree_map(torch.ones_like, params)
    new, state = Adam(0.1).update(grads, Adam(0.1).init(params), params)
    assert torch.equal(new["bn"]["stats"]["mean"], torch.ones(2))
    assert not torch.equal(new["w"], params["w"])


def test_trainer_costs_match_a_jax_loop():
    """``Trainer.train``'s per-step costs (EndIteration) over two passes of
    three batches, and ``Trainer.test``'s mean cost, against a plain JAX
    loop of value_and_grad + Adam over the same batches."""
    jm, jp, model = _pair("last", seed=1)
    batches = _batches(3, seed=6)
    jopt = JAdam(2e-3)
    js = jopt.init(jp)
    want = []
    for _ in range(2):
        for batch in batches:
            loss, g = jax.value_and_grad(_jloss(jm))(
                jp, *(jnp.asarray(a) for a in batch))
            jp, js = jopt.update(g, js, jp)
            want.append(float(loss))
    events = []
    trainer = Trainer(_loss(model), Adam(2e-3), device="cpu")
    params, state = trainer.train(lambda: [_t(b) for b in batches],
                                  model.tree(), num_passes=2,
                                  event_handler=events.append)
    costs = [e.cost for e in events if isinstance(e, event.EndIteration)]
    np.testing.assert_allclose(costs, want, atol=ATOL)
    kinds = [type(e).__name__ for e in events]
    assert kinds[:2] == ["BeginPass", "BeginIteration"]
    assert kinds.count("EndPass") == 2 and int(state["step"]) == 6
    _assert_trees(params, jp, ATOL)
    test_want = np.mean([float(_jloss(jm)(jp, *(jnp.asarray(a) for a in b)))
                         for b in batches])
    got = trainer.test(lambda: [_t(b) for b in batches], params)["cost"]
    np.testing.assert_allclose(got, test_want, atol=ATOL)


def test_bf16_mixed_precision_step_tracks_jax():
    """The flagship's bf16-compute / f32-master step: params cast to bf16
    for the loss, f32 grads and Adam. bf16 rounds at other places in the
    two frameworks, so costs agree to 2e-2 and the f32 masters stay f32."""
    jm, jp, model = _pair("last", seed=3)
    jopt = JAdam(2e-3)
    js = jopt.init(jp)

    def jloss(p, *batch):
        p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        return _jloss(jm)(p16, *batch).astype(jnp.float32)

    def loss(p, *batch):
        p16 = tree_map(lambda a: a.to(torch.bfloat16), p)
        return _loss(model)(p16, *batch).float()
    trainer = Trainer(loss, Adam(2e-3), device="cpu")
    params, state = model.tree(), trainer.opt.init(model.tree())
    for batch in _batches(3, seed=7):
        jl, g = jax.value_and_grad(jloss)(jp, *(jnp.asarray(a)
                                                for a in batch))
        jp, js = jopt.update(g, js, jp)
        params, state, cost = trainer.step(params, state, *_t(batch))
        assert abs(cost.item() - float(jl)) < 2e-2
    assert all(v.dtype == torch.float32 for _, v in tree_items(params))


def test_trainer_without_a_device_never_picks_the_cpu():
    model = LSTMTextCls(VOCAB, EMBED, HIDDEN)
    if torch.cuda.is_available():
        assert Trainer(_loss(model), Adam()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Trainer(_loss(model), Adam())
        with pytest.raises(RuntimeError, match="no CUDA card"):
            model.init(seed=0)


def test_model_rejects_an_unknown_pool():
    with pytest.raises(ValueError, match="pool"):
        LSTMTextCls(VOCAB, pool="mean")
