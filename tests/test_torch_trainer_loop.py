"""The port's whole training loop (paddle_tpu_torch/trainer/trainer.py:
reader -> DataFeeder -> DoubleBuffer -> step with ``outputs_fn`` and
evaluators -> checkpoints) against the JAX package's ``Trainer``, on the
CPU, on the flagship's LSTM text classifier (last-step pooling, Adam) at
a small width (vocab 64, embed 8, hidden 16, batch 6, lengths 1..20).

The rows (ids, label, [scale]) come from a seeded reader; the loss is the
mean cross-entropy, each row's term times its scale (1, or inf in a
poisoned batch), so a batch of ids can make the loss non-finite.

Tolerances: per-batch costs and the test cost atol 1e-5 and the
parameters after training atol 2e-5 (both sides f32 and the same ops;
summation order only, and Adam's early steps ~lr * sign(g) do not
amplify it); the evaluators' error rate and AUC are computed from the
same argmax and bins on both sides and must be equal (rtol 1e-6), their
average cost atol 1e-5. Within the port, resume after a preemption,
``skip`` and ``halt`` against the runs without interruption or without
the batch are bit-equal; those runs take one CPU thread (``one_thread``):
on several, MKL may split a product differently from one run to the next
(two identical runs of a wider loop differed in the last bits at 8
threads, not at 1).
"""

import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.data as JD
import paddle_tpu.trainer as JT
from paddle_tpu.models import LSTMTextCls as JLSTM
from paddle_tpu.ops.loss import softmax_with_cross_entropy as jce
from paddle_tpu.optimizer import Adam as JAdam
import paddle_tpu_torch.data as PD
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.pytree import tree_items
from paddle_tpu_torch.models import LSTMTextCls
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy as pce
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.trainer import (AucEvaluator,
                                      ClassificationErrorEvaluator,
                                      SumEvaluator, Trainer, event,
                                      load_checkpoint, shared_forward)

VOCAB, EMBED, HIDDEN, B, LR = 64, 8, 16, 6, 2e-2
ATOL, PARAM_ATOL = 1e-5, 2e-5


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


def rows(seed, n, poison=None, lo=1, hi=20):
    """A reader creator of ``n`` rows (ids, label, [scale]); the rows of
    batch ``poison`` (of ``B``) get scale inf. The label is the parity of
    the last id, so that the loss can fall."""
    def reader():
        rs = np.random.RandomState(seed)
        for i in range(n):
            ids = rs.randint(0, VOCAB, rs.randint(lo, hi + 1)).tolist()
            scale = np.inf if poison is not None and i // B == poison else 1.0
            yield ids, ids[-1] % 2, [scale]
    return reader


def _setup(seed=0):
    jm = JLastSeq(VOCAB, EMBED, HIDDEN)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           LSTMTextCls(VOCAB, EMBED, HIDDEN, pool="last"),
                           "cpu")
    return jm, jp, pm


def _jax_fns(jm):
    def loss(p, sb, y, sc):
        return jnp.mean(jce(jm(p, sb), y) * sc[:, 0])

    def outputs(p, sb, y, sc):
        lg = jm(p, sb)
        return {"logits": lg, "probs": jax.nn.softmax(lg)[:, 1],
                "labels": y}
    return loss, outputs


def _port_fns(pm):
    @shared_forward
    def logits(p, sb):
        return pm.call(p, sb)

    def loss(p, sb, y, sc):
        return torch.mean(pce(logits(p, sb), y) * sc[:, 0])

    def outputs(p, sb, y, sc):
        lg = logits(p, sb)
        return {"logits": lg, "probs": torch.softmax(lg, -1)[:, 1],
                "labels": y}
    return loss, outputs


def _evals(E):
    return [E.ClassificationErrorEvaluator(), E.AucEvaluator(20),
            E.SumEvaluator()]


def port_trainer(pm, **kw):
    loss, outs = _port_fns(pm)
    kw.setdefault("outputs_fn", outs)
    kw.setdefault("evaluators", [ClassificationErrorEvaluator(),
                                 AucEvaluator(20), SumEvaluator()])
    return Trainer(loss, Adam(LR), device="cpu", **kw)


def jax_trainer(jm, **kw):
    loss, outs = _jax_fns(jm)
    return JT.Trainer(loss, JAdam(LR), outputs_fn=outs,
                      evaluators=_evals(JT.evaluator), **kw)


def port_feeder():
    return PD.DataFeeder([PD.SeqSlot(), PD.IndexSlot(), PD.DenseSlot(1)],
                         device="cpu")


def jax_feeder():
    return JD.DataFeeder([JD.SeqSlot(), JD.IndexSlot(), JD.DenseSlot(1)])


class Log:
    """Every event's essentials, and a hook run at each EndIteration."""

    def __init__(self, at=None):
        self.events, self.at = [], at

    def __call__(self, e):
        if isinstance(e, event.EndIteration) or type(e).__name__ == \
                "EndIteration":
            self.events.append(("it", e.pass_id, e.batch_id, e.cost,
                                e.evaluator_result))
            if self.at is not None:
                self.at(e)
        elif type(e).__name__ == "TestResult":
            self.events.append(("test", e.pass_id, e.cost,
                                e.evaluator_result))
        elif type(e).__name__ == "EndPass":
            self.events.append(("pass", e.pass_id, e.evaluator_result))

    def costs(self):
        return [ev[3] for ev in self.events if ev[0] == "it"]


def _np(tree):
    return {"/".join(p): np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v) for p, v in tree_items(tree)}


def _close_trees(got, want, atol):
    g, w = _np(got), _np(jax.tree_util.tree_map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=atol,
                                   err_msg=k)


def _equal_trees(a, b):
    a, b = _np(a), _np(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _close_results(got, want):
    assert set(got) == set(want)
    for k in want:
        tol = dict(atol=ATOL) if "cost" in k else dict(rtol=1e-6)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# -- the loop against JAX's ----------------------------------------------------

def test_losses_and_evaluators_follow_jax():
    jm, jp, pm = _setup()
    reader = JD.batch(rows(1, 4 * B), B)
    test_reader = JD.batch(rows(2, 2 * B), B)
    jlog, plog = Log(), Log()
    jpar, jst = jax_trainer(jm).train(
        reader, jp, num_passes=2, event_handler=jlog, feeder=jax_feeder(),
        test_reader=test_reader)
    ppar, pst = port_trainer(pm).train(
        PD.batch(rows(1, 4 * B), B), pm.tree(), num_passes=2,
        event_handler=plog, feeder=port_feeder(),
        test_reader=PD.batch(rows(2, 2 * B), B))
    assert len(plog.events) == len(jlog.events) == 2 * (4 + 2)
    for p, j in zip(plog.events, jlog.events):
        assert p[:2] == j[:2]
        if p[0] == "it":
            np.testing.assert_allclose(p[3], j[3], atol=ATOL)
            _close_results(p[4], j[4])
        elif p[0] == "test":
            np.testing.assert_allclose(p[2], j[2], atol=ATOL)
            _close_results(p[3], j[3])
        else:
            _close_results(p[2], j[2])
    assert plog.costs()[-1] < plog.costs()[0]
    _close_trees(ppar, jpar, PARAM_ATOL)
    _close_trees(pst["slots"], jst["slots"], PARAM_ATOL)
    assert int(pst["step"]) == int(jst["step"]) == 8


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains pass 0 and is preempted in pass 1; the port resumes
    from JAX's directory and continues as JAX's own continuation does."""
    jm, jp, pm = _setup(1)
    d = str(tmp_path / "jax")
    reader = rows(3, 4 * B)

    def preempt(tr):
        return Log(at=lambda e: tr.request_preemption()
                   if (e.pass_id, e.batch_id) == (1, 1) else None)

    jt = jax_trainer(jm, output_dir=d)
    jt.train(JD.batch(reader, B), jp, num_passes=3, feeder=jax_feeder(),
             event_handler=preempt(jt), handle_signals=False)
    assert jt.preempted and JT.latest_pass(d) == 1
    shutil.copytree(d, d + "-port")
    plog, jlog = Log(), Log()
    ppar, pst = port_trainer(pm, output_dir=d + "-port").train(
        PD.batch(reader, B), pm.tree(), num_passes=2, feeder=port_feeder(),
        resume=True, event_handler=plog, handle_signals=False)
    jpar, jst = jax_trainer(jm, output_dir=d).train(
        JD.batch(reader, B), jp, num_passes=2, feeder=jax_feeder(),
        resume=True, event_handler=jlog, handle_signals=False)
    assert [e[1:3] for e in plog.events if e[0] == "it"] == \
        [e[1:3] for e in jlog.events if e[0] == "it"] == \
        [(1, 2), (1, 3)] + [(2, i) for i in range(4)]
    np.testing.assert_allclose(plog.costs(), jlog.costs(), atol=ATOL)
    _close_trees(ppar, jpar, PARAM_ATOL)
    _close_trees(pst["slots"], jst["slots"], PARAM_ATOL)
    assert int(pst["step"]) == int(jst["step"]) == 12


# -- preemption, resume, skip, halt: the port against itself ------------------

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(pm, reader, **kw):
    at = kw.pop("at", None)
    tr = port_trainer(pm, **{k: kw.pop(k) for k in
                             ("output_dir", "on_nonfinite") if k in kw})
    log = Log(at=(lambda e: at(tr, e)) if at else None)
    params = kw.pop("params", pm.tree())
    p, s = tr.train(PD.batch(reader, B), params, feeder=port_feeder(),
                    event_handler=log, handle_signals=False, **kw)
    return tr, p, s, log


def test_resume_after_preemption_is_bit_equal(tmp_path, one_thread):
    _, _, pm = _setup(2)
    reader = rows(4, 4 * B)
    _, want_p, want_s, want_log = _run(pm, reader, num_passes=3)
    d = str(tmp_path)

    def preempt(tr, e):
        if (e.pass_id, e.batch_id) == (1, 1):
            tr.request_preemption()

    tr, _, _, log1 = _run(pm, reader, num_passes=3, output_dir=d,
                          at=preempt)
    assert tr.preempted and tr.train_stats["preemptions"] == 1
    _, _, st = load_checkpoint(d, device="cpu")
    assert st == {"pass_id": 1, "version": 1, "pass_complete": False,
                  "batch_id": 1}
    tr2, got_p, got_s, log2 = _run(pm, reader, num_passes=2, output_dir=d,
                                   resume=True)
    assert not tr2.preempted
    assert log1.costs() + log2.costs() == want_log.costs()
    # the loaded trees come back in the order of the trees given (the
    # step graph's key holds it)
    assert list(got_p) == list(want_p) and list(got_s["slots"]) == \
        list(want_s["slots"])
    _equal_trees(got_p, want_p)
    _equal_trees(got_s, want_s)
    assert int(got_s["step"]) == 12


def test_skip_with_adam_equals_never_seeing_the_batch(one_thread):
    _, _, pm = _setup(3)
    poisoned = rows(5, 5 * B, poison=2)
    tr, got_p, got_s, log = _run(pm, poisoned, num_passes=2,
                                 on_nonfinite="skip")
    assert tr.train_stats["skipped_batches"] == 2
    assert tr.train_stats["nonfinite_batches"] == 2
    costs = log.costs()
    assert np.isinf(costs[2]) and np.isinf(costs[7])
    assert [ev[4] for ev in log.events if ev[0] == "it"][2] is None

    def clean():
        rs = list(poisoned())
        return iter(rs[:2 * B] + rs[3 * B:])

    _, want_p, want_s, want_log = _run(pm, clean, num_passes=2)
    assert [c for c in costs if np.isfinite(c)] == want_log.costs()
    _equal_trees(got_p, want_p)
    _equal_trees(got_s, want_s)           # Adam's step counter too
    assert int(got_s["step"]) == 8


def test_halt_checkpoints_the_last_finite_state_then_raises(tmp_path,
                                                          one_thread):
    _, _, pm = _setup(4)
    d = str(tmp_path)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _run(pm, rows(6, 4 * B, poison=2), num_passes=1, output_dir=d,
             on_nonfinite="halt")
    p, s, st = load_checkpoint(d, device="cpu")
    assert st["halted"] and st["batch_id"] == 2 and not st["pass_complete"]
    _, want_p, want_s, _ = _run(pm, rows(6, 2 * B), num_passes=1)
    _equal_trees(p, want_p)
    _equal_trees(s, want_s)


def test_raise_policy_and_off():
    _, _, pm = _setup(4)
    with pytest.raises(FloatingPointError):
        _run(pm, rows(6, 3 * B, poison=1), num_passes=1)
    tr = port_trainer(pm, nan_guard=False)
    assert tr.on_nonfinite == "off"
    with pytest.raises(ValueError, match="on_nonfinite"):
        port_trainer(pm, on_nonfinite="ignore")
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        port_trainer(pm, mesh=object())


def test_checkpoint_cadence_and_signal_handlers(tmp_path):
    _, _, pm = _setup(5)
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    d = str(tmp_path / "c")
    tr = port_trainer(pm, output_dir=d)
    seen = []
    tr.train(PD.batch(rows(7, 2 * B), B), pm.tree(), num_passes=5,
             feeder=port_feeder(), checkpoint_every=2,
             event_handler=lambda e: seen.append(
                 signal.getsignal(signal.SIGTERM)))
    assert sorted(os.listdir(d)) == ["pass-00001", "pass-00003",
                                     "pass-00004"]
    assert all(h is not before[signal.SIGTERM] for h in seen)
    assert {s: signal.getsignal(s) for s in before} == before
    with pytest.raises(ValueError):
        tr.train(PD.batch(rows(7, B), B), pm.tree(), checkpoint_every=0)
    # SIGTERM mid-pass: checkpoint, then return; the handlers go back
    d2 = str(tmp_path / "s")
    tr2 = port_trainer(pm, output_dir=d2)

    def term(e):
        if type(e).__name__ == "EndIteration" and e.batch_id == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    tr2.train(PD.batch(rows(7, 2 * B), B), pm.tree(), num_passes=2,
              feeder=port_feeder(), event_handler=term)
    assert tr2.preempted and tr2.train_stats["preemptions"] == 1
    assert load_checkpoint(d2, device="cpu")[2]["batch_id"] == 0
    assert {s: signal.getsignal(s) for s in before} == before


def test_counters_and_stats():
    _, _, pm = _setup(6)
    tr, *_ = _run(pm, rows(8, 3 * B), num_passes=2)
    assert tr.metrics.counter("trainer.steps_total").get() == 6
    assert dict(tr.train_stats) == {"nonfinite_batches": 0,
                                    "skipped_batches": 0, "preemptions": 0}
    assert tr.stats.items()["TrainBatch"].count == 6
    assert tr.stats.items()["Eval"].count == 6


# -- check_gradient, benchmark ---------------------------------------------------

def test_check_gradient_passes_and_catches_a_wrong_gradient():
    _, _, pm = _setup(7)
    batch = port_feeder()(list(rows(9, B)()))
    loss, _ = _port_fns(pm)
    tr = Trainer(loss, Adam(LR), device="cpu")
    # JAX's defaults (eps 1e-3, rtol 5e-2): the LSTM's plain route sums in
    # f32 inside, as the kernels do, so a float64 loss still carries f32
    # rounding into the central differences
    assert tr.check_gradient(pm.tree(), batch)

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return 1.5 * g

    wrong = Trainer(lambda p, sb, y, sc: loss(
        {**p, "fc": {"w": Wrong.apply(p["fc"]["w"]), "b": p["fc"]["b"]}},
        sb, y, sc), Adam(LR), device="cpu")
    assert not wrong.check_gradient(pm.tree(), batch)


def test_benchmark_returns_ms_per_batch(tmp_path):
    _, _, pm = _setup(8)
    tr = port_trainer(pm)
    out = tr.benchmark(PD.batch(rows(10, 2 * B), B), pm.tree(),
                       feeder=port_feeder(), warmup=1, iters=3,
                       profile_dir=str(tmp_path))
    assert set(out) == {"ms_per_batch"} and out["ms_per_batch"] > 0
    assert os.listdir(tmp_path)
    with pytest.raises(ValueError, match="empty reader"):
        tr.benchmark(lambda: iter([]), pm.tree())


# -- the forward shared by the loss and the outputs ---------------------------

def test_outputs_share_the_loss_forward_and_see_pre_update_params():
    _, _, pm = _setup(9)
    calls = []

    @shared_forward
    def logits(p, sb):
        calls.append(1)
        return pm.call(p, sb)

    loss = lambda p, sb, y, sc: torch.mean(pce(logits(p, sb), y))
    outs = lambda p, sb, y, sc: {"logits": logits(p, sb)}
    tr = Trainer(loss, Adam(LR), device="cpu", outputs_fn=outs)
    batch = port_feeder()(list(rows(11, B)()))
    before = pm.call(pm.tree(), batch[0]).detach()
    p, s, cost, o = tr.step(pm.tree(), tr.opt.init(pm.tree()), *batch)
    assert len(calls) == 1 and torch.equal(o["logits"], before)
    assert not o["logits"].requires_grad
    res = tr.test(lambda: [batch], p)
    assert len(calls) == 2 and set(res) == {"cost", "evaluator_result"}
    assert logits(p, batch[0]) is not logits(p, batch[0])   # no scope


def test_guarded_step_body_reads_nothing_back_on_meta():
    """The skip-guarded step with outputs_fn, and the test body, on meta
    tensors: any host read would raise."""
    meta = torch.device("meta")
    m = LSTMTextCls(VOCAB, EMBED, HIDDEN, pool="last")
    loss, outs = _port_fns(m)
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=meta)
    from paddle_tpu_torch.core import SeqBatch
    batch = (SeqBatch(z(3, 8), z(3)), z(3), z(3, 1, dt=torch.float32))
    for policy in ("skip", "halt", "raise"):
        tr = Trainer(loss, Adam(LR), device=meta, outputs_fn=outs,
                     on_nonfinite=policy)
        params = m.tree()
        state = tr.opt.init(params)
        p, s, cost, o = tr._step_body(params, state, batch)
        assert p is params and s is state and cost.device == meta
        assert o["logits"].shape == (3, 2) and o["probs"].device == meta
        c, o2 = tr._loss_body(params, batch)
        assert c.device == meta and o2["labels"].device == meta


def test_logging_periods_and_the_flag_fallback(monkeypatch):
    """``log_period`` and ``param_stats_period`` run on the host after a
    step; ``param_stats_period=0`` falls back to the global flag."""
    from paddle_tpu_torch.utils.flags import FLAGS
    monkeypatch.setattr(FLAGS, "show_parameter_stats_period", 2)
    _, _, pm = _setup(10)
    tr = port_trainer(pm, log_period=1)
    assert tr.param_stats_period == 2 and tr.log_period == 1
    p, s = tr.train(PD.batch(rows(12, 2 * B), B), pm.tree(),
                    feeder=port_feeder(), handle_signals=False)
    assert int(s["step"]) == 2


def test_ploter_collects_what_jax_collects(tmp_path):
    from paddle_tpu.trainer.plot import Ploter as JPloter
    from paddle_tpu_torch.trainer import Ploter
    mine, theirs = Ploter("train", "test"), JPloter("train", "test")
    for i in range(3):
        for p in (mine, theirs):
            p.append("train", i, 1.0 / (i + 1))
            p.append("test", i, 0.5)
    assert mine.data == theirs.data
    mine.plot(str(tmp_path / "curve.png"))      # None without matplotlib
    mine.reset()
    assert mine.data == {"train": ([], []), "test": ([], [])}
