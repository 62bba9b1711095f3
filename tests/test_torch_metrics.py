"""The port's metric ops (paddle_tpu_torch/ops/metrics.py) and evaluators
(trainer/evaluator.py) against the JAX package's, on the CPU, on the same
numpy inputs.

Tolerances: counts (accuracy, histograms, precision/recall, chunks, edit
distances, pn-pairs) are small integers in f32 and must be equal; AUC
and the rates derived from the counts rtol 1e-6 (f32 sums of the same
terms in another order); average precision is host numpy on both sides
and equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.metrics as JM
import paddle_tpu.trainer.evaluator as JE
import paddle_tpu_torch.ops.metrics as PM
import paddle_tpu_torch.trainer.evaluator as PE


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def _data(seed=0, B=16, C=5):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, C).astype(np.float32)
    labels = rs.randint(0, C, B).astype(np.int32)
    return rs, logits, labels


def test_accuracy_and_top_k():
    rs, logits, labels = _data()
    w = rs.rand(16).astype(np.float32)
    for args in ((logits, labels), (logits.argmax(-1).astype(np.int32),
                                    labels)):
        got = PM.accuracy(*map(torch.from_numpy, args))
        want = JM.accuracy(*map(jnp.asarray, args))
        for g, wv in zip(got, want):
            _eq(g, wv)
    got = PM.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(w))
    want = JM.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                       jnp.asarray(w))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(float(g), float(wv), rtol=1e-6)
    for k in (1, 3):
        for g, wv in zip(PM.top_k_accuracy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), k),
                         JM.top_k_accuracy(jnp.asarray(logits),
                                           jnp.asarray(labels), k)):
            _eq(g, wv)


@pytest.mark.parametrize("n", [10, 200])
def test_auc_histogram_and_auc(n):
    rs = np.random.RandomState(n)
    probs = np.concatenate([rs.rand(60), [0.0, 1.0, 0.5]]).astype(np.float32)
    labels = (rs.rand(63) < probs).astype(np.int32)
    got = PM.auc_histogram(torch.from_numpy(probs), torch.from_numpy(labels),
                           n)
    want = JM.auc_histogram(jnp.asarray(probs), jnp.asarray(labels), n)
    for g, w in zip(got, want):
        _eq(g, w)
    np.testing.assert_allclose(float(PM.auc_from_histogram(*got)),
                               float(JM.auc_from_histogram(*want)),
                               rtol=1e-6)


def test_precision_recall_counts():
    _, logits, labels = _data(1)
    pred = logits.argmax(-1).astype(np.int32)
    _eq(PM.precision_recall_counts(torch.from_numpy(pred),
                                   torch.from_numpy(labels), 5),
        JM.precision_recall_counts(jnp.asarray(pred), jnp.asarray(labels), 5))


def _tags(seed, B=6, T=9, types=3):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 2 * types, (B, T)).astype(np.int32)
    pred = label.copy()
    flip = rs.rand(B, T) < 0.3
    pred[flip] = rs.randint(0, 2 * types, flip.sum())
    lens = rs.randint(0, T + 1, B).astype(np.int32)
    lens[:2] = (0, T)
    return pred, label, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_count(seed):
    args = _tags(seed)
    got = PM.chunk_count(*map(torch.from_numpy, args), num_chunk_types=3)
    want = JM.chunk_count(*map(jnp.asarray, args), num_chunk_types=3)
    for g, w in zip(got, want):
        _eq(g, w)


def test_edit_distance():
    rs = np.random.RandomState(5)
    pred = rs.randint(0, 4, (7, 6)).astype(np.int32)
    label = rs.randint(0, 4, (7, 5)).astype(np.int32)
    plen = np.array([0, 6, 3, 1, 5, 6, 2], np.int32)
    llen = np.array([5, 0, 3, 1, 2, 5, 4], np.int32)
    got = PM.edit_distance(*map(torch.from_numpy, (pred, plen, label, llen)))
    want = JM.edit_distance(*map(jnp.asarray, (pred, plen, label, llen)))
    _eq(got, want)


def test_pnpair_counts_and_average_precision():
    rs = np.random.RandomState(6)
    scores = np.round(rs.rand(20), 1).astype(np.float32)   # ties
    labels = rs.randint(0, 3, 20).astype(np.int32)
    qids = rs.randint(0, 3, 20).astype(np.int32)
    for g, w in zip(PM.pnpair_counts(*map(torch.from_numpy,
                                          (scores, labels, qids))),
                    JM.pnpair_counts(*map(jnp.asarray,
                                          (scores, labels, qids)))):
        _eq(g, w)
    matched = (rs.rand(20) < 0.5).astype(np.float64)
    assert PM.average_precision(scores, matched, 12) == \
        JM.average_precision(scores, matched, 12)
    assert PM.average_precision([], [], 3) == 0.0


# -- evaluators: several batches through both --------------------------------

def _batches(n=3, B=12, C=4):
    out = []
    for i in range(n):
        rs, logits, labels = _data(10 + i, B, C)
        probs = 1.0 / (1.0 + np.exp(-logits[:, 1]))
        pred, ltags, lens = _tags(20 + i, B=B)
        out.append(dict(
            logits=logits, labels=labels, probs=probs.astype(np.float32),
            binary=(labels % 2).astype(np.int32),
            pred=logits.argmax(-1).astype(np.int32), pred_tags=pred,
            label_tags=ltags, lengths=lens,
            scores=rs.rand(B).astype(np.float32),
            query_ids=rs.randint(0, 3, B).astype(np.int32),
            cost=np.float32(rs.rand())))
    return out


# name -> (constructor taking the module, the update's keyword keys)
EVALUATORS = {
    "classification_error": (lambda E: E.ClassificationErrorEvaluator(),
                             {"logits": "logits", "labels": "labels"}),
    "sum": (lambda E: E.SumEvaluator(), {"cost": "cost"}),
    "auc": (lambda E: E.AucEvaluator(50),
            {"probs": "probs", "labels": "binary"}),
    "precision_recall": (lambda E: E.PrecisionRecallEvaluator(4),
                         {"pred": "pred", "labels": "labels"}),
    "chunk": (lambda E: E.ChunkEvaluator(3),
              {"pred_tags": "pred_tags", "label_tags": "label_tags",
               "lengths": "lengths"}),
    "pnpair": (lambda E: E.PnpairEvaluator(),
               {"scores": "scores", "labels": "binary",
                "query_ids": "query_ids"}),
    "value_printer": (lambda E: E.ValuePrinterEvaluator("logits",
                                                        log_fn=_sink),
                      {"logits": "logits"}),
    "max_id_printer": (lambda E: E.MaxIdPrinterEvaluator("logits",
                                                         log_fn=_sink),
                       {"logits": "logits"}),
}

_LOG = []


def _sink(fmt, *args):
    _LOG.append(fmt % tuple(np.array2string(a) if isinstance(a, np.ndarray)
                            else a for a in args))


@pytest.mark.parametrize("name", list(EVALUATORS))
def test_evaluator_follows_jax(name):
    make, keys = EVALUATORS[name]
    je, pe = make(JE), make(PE)
    _LOG.clear()
    for b in _batches():
        je.update(**{k: jnp.asarray(b[v]) for k, v in keys.items()})
        pe.update(**{k: torch.from_numpy(np.asarray(b[v]))
                     for k, v in keys.items()})
    want, got = je.result(), pe.result()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    if name.endswith("printer"):
        assert len(_LOG) == 6 and _LOG[0::2] == _LOG[1::2]
    pe.start()
    assert pe.result() == make(PE).result()


def test_evaluator_group_and_card_free_host_reads():
    """A group fans out; tensors reach the evaluators as the step's
    outputs (here on the CPU) and are read back on the host."""
    group = PE.EvaluatorGroup(PE.ClassificationErrorEvaluator(),
                              PE.SumEvaluator(), PE.AucEvaluator(20))
    jgroup = JE.EvaluatorGroup(JE.ClassificationErrorEvaluator(),
                               JE.SumEvaluator(), JE.AucEvaluator(20))
    for b in _batches():
        kw = dict(logits=b["logits"], labels=b["binary"], probs=b["probs"],
                  cost=b["cost"])
        group.update(**{k: torch.from_numpy(np.asarray(v))
                        for k, v in kw.items()})
        jgroup.update(**{k: jnp.asarray(v) for k, v in kw.items()})
    got, want = group.result(), jgroup.result()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
