"""Streaming evaluators — the counterpart of
``paddle_tpu/trainer/evaluator.py`` (the gserver Evaluator zoo:
classification error, sum, AUC, precision/recall, chunk F1, CTC error,
pn-pair, detection mAP and the printers).

Each evaluator owns small host accumulators; the per-batch counts come
from ``ops/metrics.py`` on the tensors the trainer's step hands over
(its ``outputs_fn``, evaluated inside the step's graph on the card) and
are read back here, after the step. ``result()`` returns a dict for
events and logs. ``CTCErrorEvaluator`` decodes with
``ops/ctc.py`` ``ctc_greedy_decode`` on the tensors' device;
``DetectionMAPEvaluator`` matches on the host, through
``ops/detection.py`` ``iou_matrix`` in f32 as JAX's does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import metrics as M
from ..ops.ctc import ctc_greedy_decode
from ..ops.detection import iou_matrix
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


class CTCErrorEvaluator(Evaluator):
    """Sequence error rate: the edit distance between the CTC greedy
    decodes and the label sequences over the total label length
    (CTCErrorEvaluator.cpp)."""

    name = "ctc_error"

    def __init__(self, blank: int = 0):
        self.blank = blank
        self.start()

    def start(self):
        self.dist = 0.0
        self.label_len = 0.0
        self.seq_errs = 0.0
        self.n_seq = 0.0

    def update(self, log_probs=None, logit_lengths=None, labels=None,
               label_lengths=None, decoded=None, decoded_lengths=None, **_):
        if decoded is None:
            decoded, decoded_lengths = ctc_greedy_decode(
                _tensor(log_probs), _tensor(logit_lengths), blank=self.blank)
        decoded = _tensor(decoded)
        dev = decoded.device
        d = _np(M.edit_distance(decoded, _tensor(decoded_lengths).to(dev),
                                _tensor(labels).to(dev),
                                _tensor(label_lengths).to(dev))
                ).astype(np.float64)
        self.dist += float(d.sum())
        self.label_len += float(_np(label_lengths).sum())
        self.seq_errs += float((d > 0).sum())
        self.n_seq += d.shape[0]

    def result(self):
        return {"ctc_error_rate": self.dist / max(self.label_len, 1.0),
                "ctc_seq_error": self.seq_errs / max(self.n_seq, 1.0)}


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


class DetectionMAPEvaluator(Evaluator):
    """Mean average precision over detection outputs
    (DetectionMAPEvaluator.cpp, integral mode).

    update() takes one image's detections [N, 6] rows (class, score, x1,
    y1, x2, y2), the detection output's format, and its ground truth
    [M, 5] rows (class, x1, y1, x2, y2). Each class's detections are taken
    best score first; one matches the gt of its highest IoU (the first on
    a tie) when that IoU reaches the threshold and the gt is not taken
    yet."""

    name = "detection_map"

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 background: int = 0):
        self.num_classes = num_classes
        self.iou = iou_threshold
        self.background = background
        self.start()

    def start(self):
        self.scores = {c: [] for c in range(self.num_classes)}
        self.matched = {c: [] for c in range(self.num_classes)}
        self.n_gt = {c: 0 for c in range(self.num_classes)}

    def update(self, detections=None, gt=None, **_):
        det = _np(detections).astype(np.float64)
        gts = _np(gt).astype(np.float64)
        for c in range(self.num_classes):
            if c == self.background:
                continue
            d = det[det[:, 0] == c]
            g = gts[gts[:, 0] == c]
            self.n_gt[c] += len(g)
            if len(d) == 0:
                continue
            d = d[np.argsort(-d[:, 1])]
            taken = np.zeros(len(g), bool)
            # one [D, M] IoU call a class, in f32 as JAX computes it
            all_ious = (iou_matrix(
                torch.as_tensor(d[:, 2:6], dtype=torch.float32),
                torch.as_tensor(g[:, 1:5], dtype=torch.float32)).numpy()
                if len(g) else np.zeros((len(d), 0)))
            for row, ious in zip(d, all_ious):
                self.scores[c].append(row[1])
                if ious.size == 0:
                    self.matched[c].append(0.0)
                    continue
                best = int(ious.argmax())
                if ious[best] >= self.iou and not taken[best]:
                    taken[best] = True
                    self.matched[c].append(1.0)
                else:
                    self.matched[c].append(0.0)

    def result(self):
        aps = [M.average_precision(self.scores[c], self.matched[c],
                                   self.n_gt[c])
               for c in range(self.num_classes)
               if c != self.background and self.n_gt[c] > 0]
        return {"detection_map": float(np.mean(aps)) if aps else 0.0}


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
