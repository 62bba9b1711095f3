"""The port's detection ops, NCE and hierarchical sigmoid
(paddle_tpu_torch/ops/detection.py, nce.py) and the detection mAP
evaluator against the JAX package's, on the CPU, on the same numpy
inputs from a seed.

Tolerances: values and gradients in f32 within ``ATOL`` (2e-5) of the
reference's largest magnitude (at least 1), rtol 1e-5 — the same
arithmetic in another summation order. Indices, masks, ranks and NMS
keeps must be equal, with ties planted (equal scores, equal
cross-entropies). The one-image ops are batched with
``torch.func.vmap`` against ``jax.vmap``, as their callers batch them.
Where JAX's result is unspecified (two real gts sharing a best prior)
the port is held to its stated rule: the higher gt index wins. The NCE
negatives are JAX's own draw, rebuilt from the key with the call JAX
makes, and fed to the port's arithmetic; the port's own draw is held to
its range and its generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import detection as JD
from paddle_tpu.ops import nce as JN
from paddle_tpu.trainer.evaluator import DetectionMAPEvaluator as JMAP
from paddle_tpu_torch.ops import detection as D
from paddle_tpu_torch.ops import nce as N
from paddle_tpu_torch.trainer import DetectionMAPEvaluator

ATOL = 2e-5


def close(got, want):
    want = np.asarray(want)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
        return
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL * scale)


def _t(a):
    return torch.tensor(np.array(a))


# -------------------------------------------------------------------- priors

@pytest.mark.parametrize("cfg", [
    dict(feature_hw=(3, 4), image_hw=(300, 300), min_size=30.0),
    dict(feature_hw=(5, 5), image_hw=(300, 200), min_size=60.0,
         max_size=111.0, aspect_ratios=(2.0, 3.0)),
    dict(feature_hw=(2, 3), image_hw=(100, 100), min_size=90.0,
         aspect_ratios=(2.0,), flip=False, clip=False,
         variance=(0.1, 0.2, 0.3, 0.4))])
def test_prior_box_matches_jax(cfg):
    jb, jv = JD.prior_box(**cfg)
    tb, tv = D.prior_box(**cfg, device="cpu")
    close(tb, jb)
    close(tv, jv)


def _boxes(rs, n, lo=0.0, hi=1.0):
    xy = rs.uniform(lo, hi - 0.3, (n, 2))
    wh = rs.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_encode_decode_match_jax():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 7), _boxes(rs, 5)
    b[0] = a[3]                                  # IoU 1
    b[1] = (0.9, 0.9, 0.95, 0.95)                # no overlap with most
    close(D.iou_matrix(_t(a), _t(b)), JD.iou_matrix(a, b))
    pri = _boxes(rs, 7)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (7, 1))
    close(D.encode_boxes(_t(a), _t(pri), _t(var)),
          JD.encode_boxes(a, pri, var))
    loc = rs.randn(7, 4).astype(np.float32) * 0.5
    cot = rs.randn(7, 4).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(
        JD.decode_boxes(x, pri, var) * cot))(jnp.asarray(loc))
    x = _t(loc).requires_grad_(True)
    tv = torch.sum(D.decode_boxes(x, _t(pri), _t(var)) * _t(cot))
    close(tv, jv)
    close(torch.autograd.grad(tv, [x])[0], jg)


# ---------------------------------------------------------------- matching

def _priors():
    b1, v1 = JD.prior_box((4, 4), (300, 300), 60.0, 110.0)
    b2, v2 = JD.prior_box((2, 2), (300, 300), 150.0, 220.0)
    return (np.concatenate([np.asarray(b1), np.asarray(b2)]),
            np.concatenate([np.asarray(v1), np.asarray(v2)]))


def _gts(rs, B=3, G=4):
    gt = np.zeros((B, G, 4), np.float32)
    mask = np.zeros((B, G), np.float32)
    labels = np.zeros((B, G), np.int32)
    for i, n in enumerate((3, 1, 2)[:B]):
        gt[i, :n] = _boxes(rs, n)
        mask[i, :n] = 1.0
        labels[i, :n] = rs.randint(1, 5, n)
    return gt, labels, mask


def test_match_priors_matches_jax():
    pri, _ = _priors()
    gt, _, mask = _gts(np.random.RandomState(1))
    for i in range(gt.shape[0]):
        jm, jp = JD.match_priors(pri, gt[i], mask[i], 0.4)
        tm, tp = D.match_priors(_t(pri), _t(gt[i]), _t(mask[i]), 0.4)
        close(tm, jm)
        close(tp, jp)
        assert tp.sum() >= mask[i].sum()


def test_match_priors_duplicate_best_prior_goes_to_the_higher_gt():
    """Two real gts whose best prior is the same: the higher index is
    force-matched to it (JAX leaves which one to XLA's scatter)."""
    pri = np.array([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                    [0.0, 0.5, 0.5, 1.0]], np.float32)
    gt = np.array([[0.0, 0.0, 0.4, 0.4], [0.05, 0.05, 0.45, 0.45],
                   [0.6, 0.6, 0.9, 0.9], [0.0, 0.0, 0.0, 0.0]], np.float32)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    tm, tp = D.match_priors(_t(pri), _t(gt), _t(mask), 0.9)
    assert tm.tolist() == [1, 2, 0] and tp.tolist() == [True, True, False]
    # without the duplicate (gt 1 padded), JAX's result
    mask1 = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    jm, jp = JD.match_priors(pri, gt, mask1, 0.9)
    tm, tp = D.match_priors(_t(pri), _t(gt), _t(mask1), 0.9)
    close(tm, jm)
    close(tp, jp)
    assert tm.tolist() == [0, 2, 0]


def _ssd_batch(seed, C=5, ties=False):
    rs = np.random.RandomState(seed)
    pri, var = _priors()
    Np = pri.shape[0]
    gt, labels, mask = _gts(rs)
    B = gt.shape[0]
    loc = (rs.randn(B, Np, 4) * 0.3).astype(np.float32)
    conf = (np.zeros((B, Np, C)) if ties
            else rs.randn(B, Np, C)).astype(np.float32)
    return loc, conf, pri, var, gt, labels, mask


@pytest.mark.parametrize("ties", [False, True])
def test_multibox_loss_vmapped_matches_jax(ties):
    loc, conf, pri, var, gt, labels, mask = _ssd_batch(2, ties=ties)

    def jloss(l, c):
        per = jax.vmap(lambda a, b, g, gl, m: JD.multibox_loss(
            a, b, pri, var, g, gl, m, overlap_threshold=0.4))(
                l, c, gt, labels, mask)
        return jnp.sum(per * jnp.arange(1.0, 4.0)), per

    (jv, jper), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(loc),
                                              jnp.asarray(conf))
    tl, tc = (_t(a).requires_grad_(True) for a in (loc, conf))
    tper = torch.func.vmap(lambda a, b, g, gl, m: D.multibox_loss(
        a, b, _t(pri), _t(var), g, gl, m, overlap_threshold=0.4))(
            tl, tc, _t(gt), _t(labels), _t(mask))
    close(tper, jper)
    tv = torch.sum(tper * torch.arange(1.0, 4.0))
    for g, w in zip(torch.autograd.grad(tv, [tl, tc]), jg):
        close(g, w)


@pytest.mark.parametrize("seed", [3, 4])
def test_nms_matches_jax_with_tied_scores(seed):
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, 30)
    boxes[10:14] = boxes[2]                      # duplicates: suppressed
    scores = rs.choice(np.float32([0.0, 0.3, 0.5, 0.9]), 30)  # many ties
    for top_k in (5, 30, 50):
        want = jax.jit(lambda b, s, k=top_k: JD.nms(
            b, s, iou_threshold=0.3, top_k=k))(boxes, scores)
        got = D.nms(_t(boxes), _t(scores), iou_threshold=0.3, top_k=top_k)
        for g, w in zip(got, want):
            close(g, w)


def test_detection_output_matches_jax_and_the_class_loop():
    loc, conf, pri, var, *_ = _ssd_batch(5, C=6)
    conf[0, :, 2] = 3.0                          # ties among a class
    kw = dict(num_classes=6, background_id=1, iou_threshold=0.45,
              score_threshold=0.05, keep_top_k=20)
    want = jax.jit(jax.vmap(lambda a, b: JD.detection_output(
        a, b, pri, var, **kw)))(jnp.asarray(loc), jnp.asarray(conf))
    got = torch.func.vmap(lambda a, b: D.detection_output(
        a, b, _t(pri), _t(var), **kw))(_t(loc), _t(conf))
    for g, w in zip(got, want):
        close(g, w)
    # the [classes, k] loop equals one nms a class
    boxes = D.decode_boxes(_t(loc[1]), _t(pri), _t(var))
    probs = torch.softmax(_t(conf[1]), -1)
    for j, c in enumerate([0, 2, 3, 4, 5]):
        one = D.nms(boxes, probs[:, c], iou_threshold=0.45,
                    score_threshold=0.05, top_k=20)
        for g, w in zip(one, (got[0][1, j], got[1][1, j], got[2][1, j])):
            assert torch.equal(g, w)


def test_detection_map_evaluator_matches_jax():
    rs = np.random.RandomState(6)
    je, te = JMAP(4, iou_threshold=0.5), DetectionMAPEvaluator(4, 0.5)
    for _ in range(3):
        gt_boxes = _boxes(rs, 5)
        gt = np.concatenate([rs.randint(1, 4, (5, 1)), gt_boxes], 1)
        det_boxes = np.concatenate([gt_boxes + rs.randn(5, 4) * 0.02,
                                    _boxes(rs, 4)]).astype(np.float32)
        det = np.concatenate([rs.randint(1, 4, (9, 1)),
                              rs.rand(9, 1), det_boxes], 1)
        je.update(detections=det, gt=gt)
        te.update(detections=torch.tensor(det), gt=torch.tensor(gt))
    assert te.name == je.name
    want, got = je.result(), te.result()
    assert got.keys() == want.keys()
    assert got["detection_map"] == pytest.approx(want["detection_map"],
                                                 abs=1e-12)
    assert 0.0 < got["detection_map"] <= 1.0


# --------------------------------------------------------------------- nce

def _nce_inputs(seed, B=6, Dm=5, V=11):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Dm).astype(np.float32),
            rs.randint(0, V, B).astype(np.int32),
            (rs.randn(V, Dm) * 0.5).astype(np.float32),
            (rs.randn(V) * 0.1).astype(np.float32),
            rs.dirichlet(np.ones(V)).astype(np.float32))


@pytest.mark.parametrize("dist", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_nce_loss_on_jax_negatives_matches_jax(dist, bias):
    h, lab, w, b, q = _nce_inputs(7)
    key = jax.random.PRNGKey(3)
    S = 4
    sd = jnp.asarray(q) if dist else None
    # JAX's own draw (ops/nce.py), rebuilt from the key
    neg = (jax.random.categorical(key, jnp.log(sd), shape=(S,)) if dist
           else jax.random.randint(key, (S,), 0, w.shape[0]))

    def jf(hh, ww, bb):
        return JN.nce_loss(hh, lab, ww, bb if bias else None, key,
                           num_neg_samples=S, sample_dist=sd)

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (h, w, b)))
    leaves = [_t(a).requires_grad_(True) for a in (h, w, b)]
    tv = N._nce_from_negatives(
        leaves[0], _t(lab), leaves[1], leaves[2] if bias else None,
        _t(np.asarray(neg)), sample_dist=_t(q) if dist else None)
    close(tv, jv)
    for g, want in zip(torch.autograd.grad(tv, leaves,
                                           materialize_grads=True), jg):
        close(g, want)


@pytest.mark.parametrize("dist", [False, True])
def test_nce_loss_draws_its_negatives_from_the_generator(dist):
    h, lab, w, b, q = _nce_inputs(8)
    sd = _t(q) if dist else None
    negs = N._draw_negatives(torch.Generator().manual_seed(1), 11, 500,
                             sd, device="cpu")
    assert negs.shape == (500,) and negs.min() >= 0 and negs.max() < 11
    if dist:   # the empirical frequencies follow the distribution
        freq = np.bincount(negs.numpy(), minlength=11) / 500
        assert np.abs(freq - q).max() < 0.08
    args = (_t(h), _t(lab), _t(w), _t(b))
    l1 = N.nce_loss(*args, torch.Generator().manual_seed(5),
                    num_neg_samples=6, sample_dist=sd)
    l2 = N.nce_loss(*args, torch.Generator().manual_seed(5),
                    num_neg_samples=6, sample_dist=sd)
    neg = N._draw_negatives(torch.Generator().manual_seed(5), 11, 6, sd,
                            device="cpu")
    assert torch.equal(l1, l2)
    assert torch.equal(l1, N._nce_from_negatives(*args, neg,
                                                 sample_dist=sd))


@pytest.mark.parametrize("V", [2, 7, 16])
def test_huffman_codes_and_hsigmoid_match_jax(V):
    jp, jc = JN.build_huffman_codes(V)
    tp, tc = N.build_huffman_codes(V, device="cpu")
    close(tp, jp)
    close(tc, jc)
    rs = np.random.RandomState(V)
    h = rs.randn(5, 4).astype(np.float32)
    lab = rs.randint(0, V, 5).astype(np.int32)
    iw = (rs.randn(2 * V, 4) * 0.5).astype(np.float32)
    ib = (rs.randn(2 * V) * 0.1).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda a, ww, bb: JN.hsigmoid_loss(a, lab, ww, bb, jp, jc),
        argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (h, iw, ib)))
    leaves = [_t(x).requires_grad_(True) for x in (h, iw, ib)]
    tv = N.hsigmoid_loss(leaves[0], _t(lab), leaves[1], leaves[2], tp, tc)
    close(tv, jv)
    for g, w in zip(torch.autograd.grad(tv, leaves), jg):
        close(g, w)
    lp = N.hsigmoid_logprobs(_t(h), _t(iw), None, tp, tc)
    close(lp, JN.hsigmoid_logprobs(h, iw, None, jp, jc))
    close(N.hsigmoid_logprobs(_t(h), _t(iw), _t(ib), tp, tc),
          JN.hsigmoid_logprobs(h, iw, ib, jp, jc))
    # a distribution over the classes
    np.testing.assert_allclose(torch.exp(lp).sum(-1).numpy(), 1.0,
                               rtol=1e-5)
