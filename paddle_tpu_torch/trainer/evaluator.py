"""Streaming evaluators — the counterpart of
``paddle_tpu/trainer/evaluator.py`` (the gserver Evaluator zoo:
classification error, sum, AUC, precision/recall, chunk F1, pn-pair and
the printers).

Each evaluator owns small host accumulators; the per-batch counts come
from ``ops/metrics.py`` on the tensors the trainer's step hands over
(its ``outputs_fn``, evaluated inside the step's graph on the card) and
are read back here, after the step. ``result()`` returns a dict for
events and logs. ``CTCErrorEvaluator`` and ``DetectionMAPEvaluator``
wait for ``ops/ctc`` and ``ops/detection`` (ROADMAP A.4).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import metrics as M
from ..utils.logging import get_logger


def _np(x) -> np.ndarray:
    """A host copy of a tensor (or anything numpy takes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class Evaluator:
    name = "evaluator"

    def start(self):
        raise NotImplementedError

    def update(self, **batch_outputs):
        raise NotImplementedError

    def result(self) -> Dict[str, float]:
        raise NotImplementedError


class ClassificationErrorEvaluator(Evaluator):
    """Error-rate (1 - accuracy), the default classification metric
    (Evaluator.cpp ClassificationErrorEvaluator)."""

    name = "classification_error"

    def __init__(self):
        self.start()

    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def update(self, logits=None, labels=None, correct=None, count=None, **_):
        if correct is None:
            correct, count = M.accuracy(_tensor(logits), _tensor(labels))
        self.wrong += float(count) - float(correct)
        self.total += float(count)

    def result(self):
        err = self.wrong / max(self.total, 1.0)
        return {"classification_error": err, "accuracy": 1.0 - err}


class SumEvaluator(Evaluator):
    """Accumulate a scalar (cost) across batches (Evaluator.cpp SumEvaluator)."""

    name = "sum"

    def __init__(self, key: str = "cost"):
        self.key = key
        self.start()

    def start(self):
        self.total = 0.0
        self.count = 0

    def update(self, **kw):
        v = kw.get(self.key)
        if v is not None:
            self.total += float(v)
            self.count += 1

    def result(self):
        return {f"avg_{self.key}": self.total / max(self.count, 1),
                f"sum_{self.key}": self.total}


class AucEvaluator(Evaluator):
    """Rank-AUC via fixed-threshold histograms (AucEvaluator analog) — the
    histogram update runs on device (ops/metrics.py:auc_histogram)."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.n = num_thresholds
        self.start()

    def start(self):
        self.pos = np.zeros(self.n, np.float64)
        self.neg = np.zeros(self.n, np.float64)

    def update(self, probs=None, labels=None, **_):
        p, n = M.auc_histogram(_tensor(probs), _tensor(labels), self.n)
        self.pos += _np(p).astype(np.float64)
        self.neg += _np(n).astype(np.float64)

    def result(self):
        # in f32, as JAX computes it from its f32 copies of the histograms
        auc = M.auc_from_histogram(
            torch.as_tensor(self.pos, dtype=torch.float32),
            torch.as_tensor(self.neg, dtype=torch.float32))
        return {"auc": float(auc)}


class PrecisionRecallEvaluator(Evaluator):
    """Per-class and macro precision/recall/F1 (PrecisionRecallEvaluator)."""

    name = "precision_recall"

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.start()

    def start(self):
        self.tp = np.zeros(self.num_classes, np.float64)
        self.fp = np.zeros(self.num_classes, np.float64)
        self.fn = np.zeros(self.num_classes, np.float64)

    def update(self, pred=None, labels=None, **_):
        counts = _np(M.precision_recall_counts(
            _tensor(pred), _tensor(labels), self.num_classes)).astype(
                np.float64)
        self.tp += counts[:, 0]
        self.fp += counts[:, 1]
        self.fn += counts[:, 2]

    def result(self):
        prec = self.tp / np.maximum(self.tp + self.fp, 1.0)
        rec = self.tp / np.maximum(self.tp + self.fn, 1.0)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        return {"macro_precision": float(prec.mean()),
                "macro_recall": float(rec.mean()),
                "macro_f1": float(f1.mean())}


class ChunkEvaluator(Evaluator):
    """Chunk (NER) F1 over IOB tags (ChunkEvaluator.cpp analog)."""

    name = "chunk"

    def __init__(self, num_tag_types: int, scheme: str = "IOB"):
        self.num_tag_types = num_tag_types
        self.scheme = scheme
        self.start()

    def start(self):
        self.n_pred = 0.0
        self.n_label = 0.0
        self.n_correct = 0.0

    def update(self, pred_tags=None, label_tags=None, lengths=None, **_):
        nc, np_, nl = M.chunk_count(_tensor(pred_tags), _tensor(label_tags),
                                    _tensor(lengths),
                                    scheme=self.scheme,
                                    num_chunk_types=self.num_tag_types)
        self.n_pred += float(np_)
        self.n_label += float(nl)
        self.n_correct += float(nc)

    def result(self):
        p = self.n_correct / max(self.n_pred, 1.0)
        r = self.n_correct / max(self.n_label, 1.0)
        f1 = 2 * p * r / max(p + r, 1e-12)
        return {"chunk_precision": p, "chunk_recall": r, "chunk_f1": f1}


class EvaluatorGroup:
    """Evaluator composition the way NeuralNetwork combines them
    (gserver combined evaluator): start/update/result fan out."""

    def __init__(self, *evaluators: Evaluator):
        self.evaluators = list(evaluators)

    def start(self):
        for e in self.evaluators:
            e.start()

    def update(self, **kw):
        for e in self.evaluators:
            e.update(**kw)

    def result(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.evaluators:
            out.update(e.result())
        return out


class PnpairEvaluator(Evaluator):
    """Positive-negative pair ordering (PnpairEvaluator.cpp): ratio of
    correctly-ordered same-query pairs; ties count half."""

    name = "pnpair"

    def __init__(self):
        self.start()

    def start(self):
        self.pos = 0.0
        self.neg = 0.0
        self.spe = 0.0

    def update(self, scores=None, labels=None, query_ids=None, **_):
        p, n, s = M.pnpair_counts(_tensor(scores).reshape(-1),
                                  _tensor(labels).reshape(-1),
                                  _tensor(query_ids).reshape(-1))
        self.pos += float(p)
        self.neg += float(n)
        self.spe += float(s)

    def result(self):
        denom = max(self.neg + self.spe / 2.0, 1e-12)
        return {"pnpair_ratio": (self.pos + self.spe / 2.0) / denom,
                "pnpair_pos": self.pos, "pnpair_neg": self.neg}


class ValuePrinterEvaluator(Evaluator):
    """Printer evaluator (Evaluator.cpp ValuePrinter): logs a named batch
    output every ``period`` updates — debugging aid, contributes no metric."""

    name = "value_printer"

    def __init__(self, key: str, period: int = 1, max_items: int = 8,
                 log_fn=None):
        self.key = key
        self.period = period
        self.max_items = max_items
        self.log = log_fn or get_logger(__name__).info
        self.start()

    def start(self):
        self.n = 0

    def update(self, **kw):
        self.n += 1
        if self.key in kw and self.n % self.period == 0:
            v = _np(kw[self.key])
            self.log("value_printer[%s] shape=%s head=%s", self.key, v.shape,
                     np.ravel(v)[: self.max_items])

    def result(self):
        return {}


class MaxIdPrinterEvaluator(Evaluator):
    """Printer (Evaluator.cpp MaxIdPrinter): logs argmax ids of an output."""

    name = "max_id_printer"

    def __init__(self, key: str = "logits", period: int = 1, max_items: int = 8,
                 log_fn=None):
        self.key = key
        self.period = period
        self.max_items = max_items
        self.log = log_fn or get_logger(__name__).info
        self.start()

    def start(self):
        self.n = 0

    def update(self, **kw):
        self.n += 1
        if self.key in kw and self.n % self.period == 0:
            ids = _np(kw[self.key]).argmax(-1)
            self.log("max_id[%s]: %s", self.key,
                     np.ravel(ids)[: self.max_items])

    def result(self):
        return {}
