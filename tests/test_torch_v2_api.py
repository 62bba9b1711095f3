"""The v2 facade of the port against the JAX package's, on the CPU: the
counterpart of ``tests/test_v2_api.py``.

Both packages build the same network from fresh default programs (so the
generated names agree) and the port's ``SGD(..., device="cpu")`` takes
JAX's initial parameters through ``Parameters.get``/``set``. Training
fires the same events in the same order with the same costs (atol 1e-5,
rtol 1e-5: f32 on both sides, summation order only). The port's ``infer``
runs forward only: it returns JAX's first-call output and leaves every
parameter bit-equal, where JAX's takes a training step a call (ROADMAP
C.9). ``Parameters`` tars are JAX's byte for byte and load in either
package, and ``Topology`` serializes the programs JAX does (the golden
configs of ``tests/goldens/``).
"""

import io
import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu.data.dataset import imdb, uci_housing
from paddle_tpu_torch.utils.flags import FLAGS

ATOL = RTOL = 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


def _fit_a_line(v2, opt):
    x = v2.layer.data("x", v2.data_type.dense_vector(13))
    y = v2.layer.data("y", v2.data_type.dense_vector(1))
    pred = v2.layer.fc(x, 1)
    cost = v2.layer.square_error_cost(pred, y)
    return SimpleNamespace(x=x, y=y, pred=pred, cost=cost,
                           opt=opt(v2.optimizer))


def _pair(build, opt, extra=None):
    """JAX's trainer and the port's, the port's from JAX's parameters."""
    out = {}
    for fl, v2 in ((jfluid, jv2), (tfluid, tv2)):
        fl.reset_default_programs()
        net = build(v2, opt)
        kw = {} if v2 is jv2 else {"device": "cpu"}
        extra_layers = extra(v2, net) if extra else None
        net.trainer = v2.SGD(net.cost, net.opt, extra_layers=extra_layers,
                             **kw)
        net.extra = extra_layers
        out[v2] = net
    j, t = out[jv2], out[tv2]
    assert t.trainer.parameters.names() == j.trainer.parameters.names()
    for n in j.trainer.parameters.names():
        t.trainer.parameters.set(n, j.trainer.parameters.get(n))
    return j, t


def _train(net, v2, reader, feeding, passes):
    seen = []

    def handler(e):
        seen.append((type(e).__name__, getattr(e, "pass_id", None),
                     getattr(e, "batch_id", None), getattr(e, "cost", None),
                     dict(getattr(e, "metrics", None) or {})))

    net.trainer.train(reader, num_passes=passes, event_handler=handler,
                      feeding=[getattr(net, f) for f in feeding])
    return seen


def _assert_events_equal(t, j):
    assert [e[:3] for e in t] == [e[:3] for e in j]
    for a, b in zip(t, j):
        if a[3] is not None:
            np.testing.assert_allclose(a[3], b[3], atol=ATOL, rtol=RTOL)
        assert a[4].keys() == b[4].keys()
        for k in a[4]:
            np.testing.assert_allclose(a[4][k], b[4][k], atol=ATOL,
                                       rtol=RTOL)


def _params(net):
    p = net.trainer.parameters
    return {n: p.get(n).copy() for n in p.names()}


def _rows(reader):
    return [[tuple(np.array(c) for c in r) for r in b] for b in reader()]


def test_fit_a_line_trains_like_jax():
    j, t = _pair(_fit_a_line, lambda o: o.Momentum(0.01, momentum=0.9))
    batches = _rows(jv2.batch(uci_housing.train(256), 64))
    je = _train(j, jv2, lambda: iter(batches), ("x", "y"), 4)
    te = _train(t, tv2, lambda: iter(batches), ("x", "y"), 4)
    _assert_events_equal(te, je)
    costs = [e[3] for e in te if e[0] == "EndIteration"]
    assert costs[-1] < costs[0] * 0.5
    jp, tp = _params(j), _params(t)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], atol=ATOL, rtol=RTOL,
                                   err_msg=n)
    jr = j.trainer.test(lambda: iter(batches[:2]), feeding=[j.x, j.y])
    tr = t.trainer.test(lambda: iter(batches[:2]), feeding=[t.x, t.y])
    np.testing.assert_allclose(tr.cost, jr.cost, atol=ATOL, rtol=RTOL)


def test_infer_is_forward_only_and_equals_jax_first_call():
    j, t = _pair(_fit_a_line, lambda o: o.Momentum(0.01, momentum=0.9))
    batches = _rows(jv2.batch(uci_housing.train(128), 64))
    _train(j, jv2, lambda: iter(batches), ("x", "y"), 1)
    _train(t, tv2, lambda: iter(batches), ("x", "y"), 1)
    rows = [tuple(np.array(c) for c in r) for r in uci_housing.test(8)()]
    jbefore, tbefore = _params(j), _params(t)
    want = jv2.infer(j.pred, j.trainer, rows, feeding=[j.x, j.y])
    got = tv2.infer(t.pred, t.trainer, rows, feeding=[t.x, t.y])
    again = tv2.infer(t.pred, t.trainer, rows, feeding=[t.x, t.y])
    assert got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(again, got)
    for n, v in _params(t).items():
        np.testing.assert_array_equal(v, tbefore[n], err_msg=n)
    # the reference's caveat (C.9): JAX's infer took a training step
    jafter = _params(j)
    assert any(not np.array_equal(jafter[n], jbefore[n]) for n in jafter)
    ids = tv2.infer(t.pred, t.trainer, rows, feeding=[t.x, t.y],
                    field=["value", "id"])
    np.testing.assert_array_equal(ids[0], got)
    assert ids[1].dtype == np.int32 and ids[1].shape == (8,)


def _lstm_textcls(v2, opt):
    words = v2.layer.data("words",
                          v2.data_type.integer_value_sequence(imdb.VOCAB))
    label = v2.layer.data("label", v2.data_type.integer_value(2))
    lstm = v2.networks.simple_lstm(v2.layer.embedding(words, 16), 16)
    logits = v2.layer.fc(v2.layer.last_seq(lstm), 2)
    cost = v2.layer.classification_cost(logits, label)
    return SimpleNamespace(words=words, label=label, lstm=lstm,
                           logits=logits, cost=cost, opt=opt(v2.optimizer))


def test_lstm_textcls_trains_and_infers_sequences_like_jax():
    """The quick_start LSTM through SGD.train with an evaluator (Adam), then
    ``infer`` of a sequence layer: per-sample arrays cut to their
    lengths."""
    j, t = _pair(_lstm_textcls, lambda o: o.Adam(1e-2),
                 extra=lambda v2, n: [
                     v2.evaluator.classification_error_evaluator(n.logits,
                                                                 n.label)])
    batches = _rows(jv2.batch(imdb.train(64), 16))
    je = _train(j, jv2, lambda: iter(batches), ("words", "label"), 2)
    te = _train(t, tv2, lambda: iter(batches), ("words", "label"), 2)
    _assert_events_equal(te, je)
    rows = batches[0][:5]
    want = jv2.infer(j.lstm, j.trainer, rows, feeding=[j.words, j.label])
    before = _params(t)
    got = tv2.infer(t.lstm, t.trainer, rows, feeding=[t.words, t.label])
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    for n, v in _params(t).items():
        np.testing.assert_array_equal(v, before[n], err_msg=n)


def test_parameters_tar_is_jax_bytes_and_loads_both_ways():
    j, t = _pair(_fit_a_line, lambda o: o.Adam(1e-3))
    jb, tb = io.BytesIO(), io.BytesIO()
    j.trainer.parameters.to_tar(jb)
    t.trainer.parameters.to_tar(tb)
    assert tb.getvalue() == jb.getvalue()
    # JAX's tar into the port, the port's (after a change) into JAX
    name = t.trainer.parameters.names()[0]
    orig = t.trainer.parameters.get(name)
    t.trainer.parameters.set(name, np.zeros_like(orig))
    t.trainer.parameters.from_tar(io.BytesIO(jb.getvalue()))
    np.testing.assert_array_equal(t.trainer.parameters.get(name), orig)
    t.trainer.parameters[name] = orig + 1.0
    out = io.BytesIO()
    t.trainer.parameters.to_tar(out)
    j.trainer.parameters.from_tar(io.BytesIO(out.getvalue()))
    np.testing.assert_array_equal(j.trainer.parameters.get(name), orig + 1.0)
    scope_value = t.trainer.exe.scope.get(name)
    assert scope_value.device == t.trainer.exe.device
    assert str(scope_value.dtype) == "torch.float32"


def _golden(v2, name):
    """``tests/golden_configs.py``'s configs over package v2."""
    L, DT = v2.layer, v2.data_type
    if name == "mlp_classifier":
        x = L.data("x", DT.dense_vector(64))
        y = L.data("y", DT.integer_value(10))
        L.classification_cost(L.fc(L.fc(x, 32, act="tanh"), 10), y)
    elif name == "lstm_text_model":
        words = L.data("words", DT.integer_value_sequence(100))
        label = L.data("label", DT.integer_value(2))
        lstm = L.lstmemory(L.embedding(words, 16), 16)
        L.classification_cost(L.fc(L.pooling(lstm, "max"), 2), label)
    else:
        x = L.data("x", DT.dense_vector(8))
        ids = L.data("ids", DT.integer_value(20))
        out = L.mixed_layer(size=8, input=[
            L.full_matrix_projection(x, 8), L.identity_projection(x),
            L.table_projection(ids, 8)], act="relu", bias_attr=True)
        L.mse_cost(out, L.data("t", DT.dense_vector(8)))


def _dump(program):
    return json.dumps(program.to_dict(), indent=1, sort_keys=True,
                      default=lambda o: f"<callable:{getattr(o, '__name__', type(o).__name__)}>")


@pytest.mark.parametrize("name", ["lstm_text_model", "mixed_projection_model",
                                  "mlp_classifier"])
def test_topology_serializes_the_golden_program(name):
    tfluid.reset_default_programs()
    _golden(tv2, name)
    prog = tfluid.default_main_program()
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        assert _dump(prog) == f.read()


def test_topology_equals_jax():
    nets = {}
    for fl, v2 in ((jfluid, jv2), (tfluid, tv2)):
        fl.reset_default_programs()
        net = _fit_a_line(v2, lambda o: o.SGD(0.01))
        net.opt.fluid_opt.minimize(net.cost.var)
        nets[v2] = (net, v2.Topology(net.cost))
    (jn, jt), (tn, tt) = nets[jv2], nets[tv2]
    assert tt.serialize() == jt.serialize()
    assert [n for n, _ in tt.data_type()] == [n for n, _ in jt.data_type()]
    assert tt.get_layer_proto(tn.pred.var.name) == \
        jt.get_layer_proto(jn.pred.var.name)
    assert tt.serialize_for_inference([tn.pred]) == \
        jt.serialize_for_inference([jn.pred])


def test_sgd_runs_on_the_card_unless_cpu_is_asked():
    import torch
    tfluid.reset_default_programs()
    net = _fit_a_line(tv2, lambda o: o.SGD(0.01))
    if torch.cuda.is_available():
        assert tv2.SGD(net.cost, net.opt).exe.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tv2.SGD(net.cost, net.opt)


def test_param_stats_flag(monkeypatch):
    """--show_parameter_stats_period through the port's v2 trainer."""
    monkeypatch.setattr(FLAGS, "show_parameter_stats_period", 2)
    tfluid.reset_default_programs()
    net = _fit_a_line(tv2, lambda o: o.SGD(0.01))
    trainer = tv2.SGD(net.cost, net.opt, device="cpu")
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lg = logging.getLogger("paddle_tpu_torch.v2.trainer")
    h = Grab(level=logging.INFO)
    lg.addHandler(h)
    try:
        trainer.train(tv2.batch(uci_housing.train(64), 16), num_passes=1,
                      feeding=[net.x, net.y])
    finally:
        lg.removeHandler(h)
    lines = [m for m in records if m.startswith("param ")]
    assert lines and any("absmax" in ln for ln in lines)
