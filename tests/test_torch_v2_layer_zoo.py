"""The v2 layer zoo of the port against the JAX package's, on the CPU: the
counterpart of ``tests/test_v2_layer_zoo.py``.

Each case builds one network through ``paddle_tpu.v2`` and through
``paddle_tpu_torch.v2`` (from fresh default programs, so the generated
names agree), carries JAX's initial scope across
(``convert.scope_from_numpy``), runs both executors on the same feed and
holds every fetched output to JAX's (atol 1e-5, rtol 1e-5: f32 on both
sides, summation order only). A case with a cost also takes one SGD step
(lr 0.05) in both, and every variable of the scopes after it is held to
JAX's under the same tolerance. Random layers (``sampling_id``, ``nce``)
draw from each package's own generator: their outputs are held to JAX's
shape and to finite values. The beam search of
``examples/machine_translation.py`` is rebuilt here at that file's sizes
from each package (the example itself is not imported).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch.nn import initializer as tinit
from torch_fluid_common import Pair

ATOL = RTOL = 1e-5
B, T, D, V = 4, 6, 8, 12
RS = np.random.RandomState(0)
X = RS.randn(B, D).astype(np.float32)
X2 = RS.randn(B, D).astype(np.float32)
SEQ = RS.randn(B, T, D).astype(np.float32)
LENS = np.array([6, 4, 3, 2], np.int32)
IDS = RS.randint(0, V, (B, T)).astype(np.int32)
LABEL = RS.randint(0, 2, B).astype(np.int32)


def pkg(fl):
    """The v2 names of the package whose fluid module is ``fl``."""
    v2 = jv2 if fl is jfluid else tv2
    return SimpleNamespace(L=v2.layer, DT=v2.data_type, NW=v2.networks,
                           EV=v2.evaluator, fluid=fl, FL=fl.layers, v2=v2,
                           I=jinit if fl is jfluid else tinit)


def _dense(P, name, dim=D):
    return P.L.data(name, P.DT.dense_vector(dim))


def _seq(P, name, dim=D):
    return P.L.data(name, P.DT.dense_vector_sequence(dim))


def _img(P, name, shape):
    """A flat dense feed reshaped to an image (annotated for the DSL)."""
    flat = P.L.data(name, P.DT.dense_vector(int(np.prod(shape))))
    out = P.L.LayerOutput(P.FL.reshape(flat.var, (-1,) + tuple(shape)))
    out.var.shape = (B,) + tuple(shape)
    return out


def _regress(P, out, dim):
    """A squared-error cost of ``out`` against a dense target ``tgt``."""
    return P.L.mse_cost(out, _dense(P, "tgt", dim))


# ---------------------------------------------------------------- cases --
# each: P -> dict(fetch=[LayerOutput | Variable], feed=..., cost=optional)

def mixed_full_matrix_identity(P):
    x = _dense(P, "x")
    out = P.L.mixed_layer(size=D, input=[
        P.L.full_matrix_projection(x, D), P.L.identity_projection(x),
        P.L.dotmul_projection(x)], act="tanh", bias_attr=True)
    return dict(fetch=[out], feed={"x": X, "tgt": X2},
                cost=_regress(P, out, D))


def mixed_table_and_trans(P):
    ids = P.L.data("ids", P.DT.integer_value(V))
    x = _dense(P, "x")
    out = P.L.mixed_layer(size=5, input=[
        P.L.table_projection(ids, 5), P.L.trans_full_matrix_projection(x, 5),
        P.L.full_matrix_projection(x, 5)])
    return dict(fetch=[out], feed={"ids": IDS[:, 0], "x": X,
                                   "tgt": X2[:, :5]},
                cost=_regress(P, out, 5))


def context_projection(P):
    s = _seq(P, "s")
    out = P.L.mixed_layer(size=3 * D, input=[
        P.L.context_projection_layer(s, context_len=3)])
    return dict(fetch=[out], feed={"s": SEQ, "s__len__": LENS})


def operators_and_slices(P):
    a, b = _dense(P, "a"), _dense(P, "b")
    dm = P.L.mixed_layer(size=D, input=[P.L.dotmul_operator(a, b, scale=2.0)])
    ip = P.L.mixed_layer(size=3, input=[
        P.L.identity_projection(a, offset=2, size=3)])
    sp = P.L.mixed_layer(size=5, input=[
        P.L.slice_projection(a, [(0, 2), (5, 8)])])
    return dict(fetch=[dm, ip, sp], feed={"a": X, "b": X2})


def addto_scaling_slope_cos_power(P):
    a, b = _dense(P, "a"), _dense(P, "b")
    w = P.L.data("w", P.DT.dense_vector(1))
    sloped = P.L.slope_intercept_layer(
        P.L.scaling_layer(P.L.addto_layer([a, b], act="relu"), w),
        slope=2.0, intercept=1.0)
    cs = P.L.cos_sim(a, b)
    pw = P.L.power_layer(_dense(P, "p"))
    return dict(fetch=[sloped, cs, pw],
                feed={"a": X, "b": X2, "w": np.full((B, 1), 0.7, np.float32),
                      "p": np.abs(X) + 0.1})


def norm_interp_comb(P):
    n = P.L.sum_to_one_norm_layer(_dense(P, "x"))
    a, b, w = _dense(P, "a"), _dense(P, "b"), P.L.data("w", P.DT.dense_vector(1))
    it = P.L.interpolation_layer([a, b], w)
    lc = P.L.linear_comb_layer(P.L.data("ws", P.DT.dense_vector(3)),
                               P.L.data("vecs", P.DT.dense_vector(3 * D)), D)
    return dict(fetch=[n, it, lc],
                feed={"x": np.abs(X) + 0.1, "a": X, "b": X2,
                      "w": np.full((B, 1), 0.3, np.float32),
                      "ws": RS.randn(B, 3).astype(np.float32),
                      "vecs": RS.randn(B, 3 * D).astype(np.float32)})


def shape_layers(P):
    x = _dense(P, "x")
    s = _seq(P, "s")
    return dict(fetch=[P.L.repeat_layer(x, 3), P.L.seq_reshape_layer(s, D // 2),
                       P.L.clip_layer(x, -0.5, 0.5),
                       P.L.pad_layer(x, [(0, 0), (1, 2)])],
                feed={"x": X, "s": SEQ, "s__len__": LENS})


def expand_maxid_sampling(P):
    s = _seq(P, "s")
    ex = P.L.expand_layer(_dense(P, "p"), s)
    mid = P.L.max_id_layer(_dense(P, "x"))
    sid = P.L.sampling_id_layer(_dense(P, "pr"), seed=1)
    return dict(fetch=[ex, mid, sid], random=[sid],
                feed={"p": X, "s": SEQ, "s__len__": LENS, "x": X,
                      "pr": np.abs(X) + 0.01})


def multiplex_tensor_convshift(P):
    a, b = _dense(P, "a"), _dense(P, "b")
    mp = P.L.multiplex_layer(P.L.data("i", P.DT.integer_value(2)), [a, b])
    t = P.L.tensor_layer(a, b, size=4, act="tanh")
    cs = P.L.conv_shift_layer(a, P.L.data("k", P.DT.dense_vector(3)))
    return dict(fetch=[mp, t, cs],
                feed={"i": np.array([0, 1, 1, 0], np.int32), "a": X, "b": X2,
                      "k": RS.randn(B, 3).astype(np.float32),
                      "tgt": X2[:, :4]},
                cost=_regress(P, t, 4))


def image_layers(P):
    x = _img(P, "img", (8, 8, 3))
    return dict(fetch=[P.L.maxout_layer(x, groups=3),
                       P.L.img_cmrnorm_layer(x, size=3),
                       P.L.bilinear_interp_layer(x, 16, 16),
                       P.L.rotate_layer(x), P.L.spp_layer(x, pyramid_height=2),
                       P.L.img_conv_transpose(x, 4, 3, stride=2)],
                feed={"img": RS.randn(B, 8 * 8 * 3).astype(np.float32)})


def image_3d(P):
    x = _img(P, "img", (4, 8, 8, 3))
    out = P.L.img_pool3d(P.L.img_conv3d(x, 4, 3, padding=1), 2)
    return dict(fetch=[out],
                feed={"img": RS.randn(B, 4 * 8 * 8 * 3).astype(np.float32)})


def seq_aux_layers(P):
    s = _seq(P, "s")
    rc = P.L.row_conv_layer(s, future_context=2)
    pl = P.L.prelu_layer(s)
    return dict(fetch=[rc, pl], feed={"s": SEQ, "s__len__": LENS,
                                      "tgt": SEQ[:, 0]},
                cost=_regress(P, P.L.last_seq(rc), D))


def cost_regression_family(P):
    x, y = _dense(P, "x"), _dense(P, "y")
    h = P.L.fc(x, D)
    costs = [P.L.mse_cost(h, y), P.L.huber_regression_cost(h, y),
             P.L.smooth_l1_cost(h, y)]
    return dict(fetch=costs, feed={"x": X, "y": X2}, cost=costs[1])


def cost_classification_family(P):
    lg = P.L.fc(_dense(P, "x"), V)
    lab = P.L.data("y", P.DT.integer_value(V))
    multi = P.L.data("m", P.DT.dense_vector(V))
    prob = _dense(P, "p", V)
    soft = P.L.data("t", P.DT.dense_vector(V))
    score = P.L.data("s", P.DT.dense_vector(1))
    binlab = P.L.data("yb", P.DT.dense_vector(1))
    pm = P.L.data("pm", P.DT.dense_vector(1))
    costs = [P.L.cross_entropy_with_selfnorm_cost(lg, lab),
             P.L.multi_binary_label_cross_entropy_cost(lg, multi),
             P.L.soft_binary_class_cross_entropy_cost(prob, soft),
             P.L.sigmoid_cross_entropy_cost(score, binlab),
             P.L.hinge_cost(score, pm), P.L.classification_cost(lg, lab)]
    probs = np.clip(np.abs(RS.randn(B, V)).astype(np.float32) * 0.1 + 0.2,
                    0.05, 0.95)
    return dict(fetch=costs, cost=costs[-1],
                feed={"x": X, "y": IDS[:, 1],
                      "m": RS.randint(0, 2, (B, V)).astype(np.float32),
                      "p": probs, "t": probs,
                      "s": RS.randn(B, 1).astype(np.float32),
                      "yb": RS.randint(0, 2, (B, 1)).astype(np.float32),
                      "pm": (RS.randint(0, 2, (B, 1)) * 2 - 1).astype(
                          np.float32)})


def cost_rank_and_lambda(P):
    left, right = (P.L.data(n, P.DT.dense_vector(1)) for n in ("a", "b"))
    rc = P.L.rank_cost(left, right, P.L.data("y", P.DT.dense_vector(1)))
    score = P.L.data("s", P.DT.integer_value_sequence(1))
    score.var.dtype = "float32"
    rel = P.L.data("r", P.DT.integer_value_sequence(1))
    rel.var.dtype = "float32"
    lc = P.L.lambda_cost(score, rel)
    return dict(fetch=[rc, lc],
                feed={"a": RS.randn(B, 1).astype(np.float32),
                      "b": RS.randn(B, 1).astype(np.float32),
                      "y": RS.randint(0, 2, (B, 1)).astype(np.float32),
                      "s": RS.randn(B, T).astype(np.float32),
                      "r": RS.randint(0, 3, (B, T)).astype(np.float32),
                      "s__len__": LENS, "r__len__": LENS})


def crf_train_and_decode(P):
    emis = _seq(P, "e", 5)
    tags = P.L.data("t", P.DT.integer_value_sequence(5))
    cost = P.L.crf_layer(emis, tags)
    dec = P.L.crf_decoding_layer(emis, transitions=cost.transitions)
    return dict(fetch=[cost, dec], cost=cost,
                feed={"e": SEQ[..., :5],
                      "t": RS.randint(0, 5, (B, T)).astype(np.int32),
                      "e__len__": LENS, "t__len__": LENS})


def ctc_cost(P):
    lg = _seq(P, "lg", 6)
    lb = P.L.data("lb", P.DT.integer_value_sequence(6))
    cost = P.L.ctc_layer(lg, lb, size=6)
    return dict(fetch=[cost],
                feed={"lg": SEQ[..., :6], "lg__len__": LENS,
                      "lb": RS.randint(1, 6, (B, 3)).astype(np.int32),
                      "lb__len__": np.array([3, 2, 2, 1], np.int32)})


def sampled_costs(P):
    h = _dense(P, "h")
    lab = P.L.data("y", P.DT.integer_value(V))
    nce = P.L.nce_layer(h, lab, num_classes=V, num_neg_samples=3)
    hs = P.L.hsigmoid_layer(h, lab, num_classes=V)
    return dict(fetch=[nce, hs], random=[nce], cost=hs,
                feed={"h": X, "y": IDS[:, 2]})


def _words(P):
    w = P.L.data("w", P.DT.integer_value_sequence(V))
    return P.L.embedding(w, D)


def _textcls(P, feat):
    """A 2-class classifier over ``feat`` with its cost."""
    return P.L.classification_cost(P.L.fc(feat, 2),
                                   P.L.data("y", P.DT.integer_value(2)))


_WORD_FEED = {"w": IDS, "w__len__": LENS, "y": LABEL}


def simple_lstm(P):
    h = P.NW.simple_lstm(_words(P), 8)
    return dict(fetch=[h], feed=_WORD_FEED,
                cost=_textcls(P, P.L.last_seq(h)))


def bidirectional_lstm(P):
    h = P.NW.bidirectional_lstm(_words(P), 8)
    return dict(fetch=[h], feed=_WORD_FEED, cost=_textcls(P, h))


def simple_gru(P):
    h = P.NW.simple_gru(_words(P), 8)
    return dict(fetch=[h], feed=_WORD_FEED,
                cost=_textcls(P, P.L.last_seq(h)))


def bidirectional_gru(P):
    h = P.NW.bidirectional_gru(_words(P), 8)
    return dict(fetch=[h], feed=_WORD_FEED, cost=_textcls(P, h))


def lstmemory_grumemory_pooling(P):
    emb = _words(P)
    lstm = P.L.pooling(P.L.lstmemory(emb, 8), "max")
    gru = P.L.pooling(P.L.grumemory(emb, 8, reverse=True), "avg")
    h = P.L.concat([lstm, gru])
    return dict(fetch=[lstm, gru], feed=_WORD_FEED, cost=_textcls(P, h))


def conv_and_attention_pools(P):
    emb = _words(P)
    scp = P.NW.sequence_conv_pool(emb, context_len=3, hidden_size=10)
    ap = P.NW.simple_attention_pool(emb)
    tcp = P.NW.text_conv_pool(emb, 6)
    return dict(fetch=[scp, ap, tcp], feed=_WORD_FEED,
                cost=_textcls(P, P.L.concat([scp, ap, tcp])))


def lstm_step_in_recurrent_group(P):
    H = 5

    def step(x_t):
        h_mem = P.L.memory("h", H)
        c_mem = P.L.memory("c", H)
        gates = P.L.mixed_layer(size=4 * H, input=[
            P.L.full_matrix_projection(x_t, 4 * H),
            P.L.full_matrix_projection(h_mem, 4 * H)])
        out = P.L.lstm_step_layer(gates, c_mem, size=H, name="h")
        P.L.identity(P.L.get_output_layer(out, "state"), name="c")
        return out

    last = P.L.last_seq(P.L.recurrent_group(step, _seq(P, "s")))
    return dict(fetch=[last], feed={"s": SEQ, "s__len__": LENS,
                                    "tgt": X[:, :H]},
                cost=_regress(P, last, H))


def gru_step_in_recurrent_group(P):
    H = 5

    def step(x_t):
        h_mem = P.L.memory("h", H)
        xw = P.L.mixed_layer(size=3 * H,
                             input=[P.L.full_matrix_projection(x_t, 3 * H)])
        return P.L.gru_step_layer(xw, h_mem, size=H, name="h")

    last = P.L.last_seq(P.L.recurrent_group(step, _seq(P, "s2")))
    return dict(fetch=[last], feed={"s2": SEQ, "s2__len__": LENS,
                                    "tgt": X[:, :H]},
                cost=_regress(P, last, H))


def evaluators(P):
    x = _dense(P, "x")
    y = P.L.data("y", P.DT.integer_value(2))
    logits = P.L.fc(x, 2)
    cost = P.L.classification_cost(logits, y)
    return dict(fetch=[P.EV.classification_error_evaluator(logits, y),
                       P.EV.sum_evaluator(logits),
                       P.EV.precision_recall_evaluator(logits, y),
                       P.EV.auc_evaluator(logits, y)],
                feed={"x": X, "y": LABEL}, cost=cost)


def selective_fc_and_gated_unit(P):
    sel = P.L.selective_fc_layer(_dense(P, "x"), 5,
                                 select=P.L.data("sel", P.DT.dense_vector(5)))
    gu = P.L.gated_unit_layer(_seq(P, "s"), 7, act="tanh")
    return dict(fetch=[sel, gu],
                feed={"x": X, "sel": (RS.rand(B, 5) > 0.5).astype(np.float32),
                      "s": SEQ, "s__len__": LENS, "tgt": X[:, :7]},
                cost=_regress(P, P.L.last_seq(gu), 7))


def elementwise_tail(P):
    x, y = _dense(P, "x"), _dense(P, "y")
    return dict(fetch=[P.L.dot_prod_layer(x, y),
                       P.L.out_prod_layer(x, P.L.data("y3",
                                                      P.DT.dense_vector(3))),
                       P.L.eos_layer(P.L.data("ids", P.DT.integer_value(V)),
                                     eos_id=3),
                       P.L.row_l2_norm_layer(x), P.L.scale_shift_layer(x),
                       P.L.resize_layer(x, D // 2)],
                feed={"x": X, "y": X2, "y3": X2[:, :3],
                      "ids": np.array([3, 1, 3, 0], np.int32)})


def cross_channel_norm_switch_order(P):
    img = P.L.data("img", P.DT.dense_vector(4 * 4 * 6))
    nchw = P.L.identity(img)
    nchw.var = P.FL.reshape(img.var, (-1, 6, 4, 4))
    ccn = P.L.cross_channel_norm_layer(P.L.switch_order_layer(nchw))
    return dict(fetch=[ccn],
                feed={"img": RS.randn(B, 6 * 4 * 4).astype(np.float32)})


def sub_seq_family(P):
    s = _seq(P, "s")
    sub = P.L.sub_seq_layer(s, P.L.data("offs", P.DT.integer_value(T)),
                            P.L.data("szs", P.DT.integer_value(T)))
    sl = P.L.seq_slice_layer(s, None, P.L.data("ends", P.DT.integer_value(T)))
    cat = P.L.seq_concat_layer(s, _seq(P, "b"))
    return dict(fetch=[sub, sl, cat, cat.lengths],
                feed={"s": SEQ, "s__len__": LENS, "b": SEQ, "b__len__": LENS,
                      "offs": np.array([1, 0, 1, 0], np.int32),
                      "szs": np.array([3, 2, 2, 2], np.int32),
                      "ends": np.array([2, 2, 1, 1], np.int32)})


def kmax_and_sub_nested_seq(P):
    km = P.L.kmax_seq_score_layer(
        P.L.data("sc", P.DT.dense_vector_sequence(1)), beam_size=2)
    nested = P.L.data("ns", P.DT.dense_vector_sub_sequence(D))
    idx = P.L.LayerOutput(P.FL.data("idx", shape=(1,), dtype="int32"))
    trimmed = P.L.sub_nested_seq_layer(nested, idx)
    return dict(fetch=[km, trimmed, trimmed.sub_lengths],
                feed={"sc": RS.randn(B, T, 1).astype(np.float32),
                      "sc__len__": LENS,
                      "ns": RS.randn(B, 3, T, D).astype(np.float32),
                      "ns__sublen__": RS.randint(1, T + 1, (B, 3)).astype(
                          np.int32),
                      "ns__len__": np.full((B,), 3, np.int32),
                      "idx": np.array([[2], [0], [1], [2]], np.int32)})


def detection_trio(P):
    F, IMG, NP, C, G = 4, 32, 4 * 4 * 4, 3, 2
    feat = P.L.identity(P.L.data("feat", P.DT.dense_vector(F * F * 8)))
    feat.var = P.FL.reshape(feat.var, (-1, F, F, 8))
    img = P.L.identity(P.L.data("img", P.DT.dense_vector(IMG * IMG * 3)))
    img.var = P.FL.reshape(img.var, (-1, IMG, IMG, 3))
    pb = P.L.priorbox_layer(feat, img, aspect_ratio=[2.0],
                            variance=[0.1, 0.1, 0.2, 0.2],
                            min_size=[10.0], max_size=[20.0])
    loc = P.L.identity(P.L.data("loc", P.DT.dense_vector(NP * 4)))
    loc.var = P.FL.reshape(loc.var, (-1, NP, 4))
    conf = P.L.identity(P.L.data("conf", P.DT.dense_vector(NP * C)))
    conf.var = P.FL.reshape(conf.var, (-1, NP, C))
    gtb = P.L.data("gtb", P.DT.dense_vector(G * 4))
    gtl = P.FL.data("gtl", shape=(G,), dtype="int32")
    gtm = P.L.data("gtm", P.DT.dense_vector(G))
    gt = P.L.identity(gtb)
    gt.var = P.FL.reshape(gtb.var, (-1, G, 4))
    gt.outputs = {"gt_label": gtl, "gt_mask": gtm.var}
    loss = P.L.multibox_loss_layer(loc, conf, pb, gt, num_classes=C)
    det = P.L.detection_output_layer(loc, conf, pb, num_classes=C,
                                     keep_top_k=5)
    return dict(fetch=[loss, det, det.outputs["scores"],
                       det.outputs["valid"], pb, pb.outputs["variances"]],
                feed={"feat": RS.randn(B, F * F * 8).astype(np.float32),
                      "img": RS.randn(B, IMG * IMG * 3).astype(np.float32),
                      "loc": (RS.randn(B, NP * 4) * 0.1).astype(np.float32),
                      "conf": RS.randn(B, NP * C).astype(np.float32),
                      "gtb": RS.rand(B, G * 4).astype(np.float32),
                      "gtl": RS.randint(1, C, (B, G)).astype(np.int32),
                      "gtm": np.ones((B, G), np.float32)})


def conv_projection_and_operator(P):
    x = _img(P, "img", (6, 6, 2))
    proj = P.L.mixed_layer(size=4, input=[
        P.L.conv_projection(x, filter_size=3, num_filters=4, padding=1)])
    op = P.L.mixed_layer(size=4, input=[
        P.L.conv_operator(x, P.L.data("filt", P.DT.dense_vector(72)),
                          filter_size=3, num_filters=4, padding=1)])
    return dict(fetch=[proj, op],
                feed={"img": RS.randn(B, 72).astype(np.float32),
                      "filt": RS.randn(B, 72).astype(np.float32)})


def scale_sub_region_print_beam_ce(P):
    x = _img(P, "img", (4, 4, 2))
    idx = P.L.LayerOutput(P.FL.data("idx", shape=(6,), dtype="int32"))
    ssr = P.L.scale_sub_region_layer(x, idx, value=3.0)
    pr = P.L.print_layer(_dense(P, "x"))
    ce = P.L.cross_entropy_over_beam(P.L.data("sc", P.DT.dense_vector(4)),
                                     P.L.data("g", P.DT.integer_value(5)),
                                     P.L.data("gs", P.DT.dense_vector(1)))
    return dict(fetch=[ssr, pr, ce],
                feed={"img": RS.randn(B, 32).astype(np.float32),
                      "idx": np.tile(np.array([1, 1, 1, 2, 1, 2], np.int32),
                                     (B, 1)),
                      "x": X, "sc": RS.randn(B, 4).astype(np.float32),
                      "g": np.array([0, 4, 2, 1], np.int32),
                      "gs": RS.randn(B, 1).astype(np.float32)})


CASES = {f.__name__: f for f in (
    mixed_full_matrix_identity, mixed_table_and_trans, context_projection,
    operators_and_slices, addto_scaling_slope_cos_power, norm_interp_comb,
    shape_layers, expand_maxid_sampling, multiplex_tensor_convshift,
    image_layers, image_3d, seq_aux_layers, cost_regression_family,
    cost_classification_family, cost_rank_and_lambda, crf_train_and_decode,
    ctc_cost, sampled_costs, simple_lstm, bidirectional_lstm, simple_gru,
    bidirectional_gru, lstmemory_grumemory_pooling, conv_and_attention_pools,
    lstm_step_in_recurrent_group, gru_step_in_recurrent_group, evaluators,
    selective_fc_and_gated_unit, elementwise_tail,
    cross_channel_norm_switch_order, sub_seq_family, kmax_and_sub_nested_seq,
    detection_trio, conv_projection_and_operator,
    scale_sub_region_print_beam_ce)}


def build_case(name, lr=0.05):
    """The case's network in both packages (a ``Pair``), its spec from the
    port's build, and the fetch names."""
    specs = {}

    def build(fl):
        spec = CASES[name](pkg(fl))
        if spec.get("cost") is not None:
            pkg(fl).v2.optimizer.SGD(lr).fluid_opt.minimize(spec["cost"].var)
        specs[fl] = spec
        return spec

    pair = Pair(build)
    return pair, specs[tfluid]


def _name(v):
    return getattr(v, "var", v).name


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_zoo_matches_jax(name):
    pair, spec = build_case(name)
    fetch = [_name(v) for v in spec["fetch"]]
    random = {_name(v) for v in spec.get("random", ())}
    cost = spec.get("cost")
    if cost is not None and _name(cost) not in fetch:
        fetch.append(_name(cost))
    j, t = pair.run(spec["feed"], fetch)
    for n, a, b in zip(fetch, j, t):
        assert b.shape == a.shape, (n, b.shape, a.shape)
        if n in random:
            assert np.isfinite(b.astype(np.float64)).all(), n
            continue
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   atol=ATOL, rtol=RTOL, err_msg=n)
    if cost is not None:
        pair.assert_scopes_close()


# ------------------------------------------------- beam search (example) --

V_SRC, V_TRG, E, H = 16, 12, 16, 32
MB, TS, TT = 16, 6, 5
BOS, EOS = 0, 1


def _translation(P):
    """``examples/machine_translation.py``'s ``build`` over package P."""
    from_layer = P.v2.layer
    ParamAttr = P.v2.attr.ParamAttr
    src = P.L.data("src", P.DT.integer_value_sequence(V_SRC))
    trg = P.L.data("trg", P.DT.integer_value_sequence(V_TRG))
    nxt = P.FL.data("nxt", shape=(TT,), dtype="int64")
    emb = P.L.embedding(src, E, param_attr=ParamAttr(name="src_embed"))
    enc = P.L.grumemory(emb, H)
    w = P.FL._create_parameter("enc_proj_w", (H, H), "float32",
                               P.I.uniform(-0.1, 0.1),
                               attr={"name": "enc_proj_w"})
    proj = from_layer.LayerOutput(P.FL.matmul(enc.var, w), enc.lengths)
    enc_last = P.L.last_seq(enc)

    def step(y_t, enc_s, proj_s):
        dec_mem = from_layer.memory("dec_state", H, boot_layer=enc_last)
        context = P.NW.simple_attention(enc_s, proj_s, dec_mem, name="att")
        h = P.L.fc([y_t, context, dec_mem], H, act="tanh", name="dec_state",
                   param_attr=ParamAttr(name="dec_h_w"),
                   bias_attr=ParamAttr(name="dec_h_b"))
        return P.L.fc(h, V_TRG, act="softmax",
                      param_attr=ParamAttr(name="dec_out_w"),
                      bias_attr=ParamAttr(name="dec_out_b"))

    trg_emb = P.L.embedding(trg, E, param_attr=ParamAttr(name="trg_embed"))
    dec = from_layer.recurrent_group(
        step, [trg_emb, from_layer.StaticInput(enc),
               from_layer.StaticInput(proj)])
    probs2d = P.FL.reshape(dec.var, (-1, V_TRG))
    loss = P.FL.mean(P.FL.cross_entropy(probs2d, P.FL.reshape(nxt, (-1,))))
    tokens, scores = from_layer.beam_search(
        step, [from_layer.GeneratedInput(
            V_TRG, E, embedding_param=ParamAttr(name="trg_embed")),
            from_layer.StaticInput(enc), from_layer.StaticInput(proj)],
        bos_id=BOS, eos_id=EOS, beam_size=4, max_length=TT)
    P.fluid.AdamOptimizer(0.02).minimize(loss)
    return loss, tokens, scores


def _translation_batch(rng, n=MB):
    srcs = rng.randint(2, V_SRC, (n, TS)).astype(np.int32)
    nxts = np.zeros((n, TT), np.int64)
    trgs = np.zeros((n, TT), np.int32)
    for b in range(n):
        for t in range(TT):
            nxts[b, t] = 2 + (srcs[b, 0] + t) % (V_TRG - 2)
            trgs[b, t] = nxts[b, t - 1] if t else BOS
    return {"src": srcs, "src__len__": np.full((n,), TS, np.int32),
            "trg": trgs, "trg__len__": np.full((n,), TT, np.int32),
            "nxt": nxts}


def test_machine_translation_beam_search_matches_jax():
    """The example's attention seq2seq: 3 Adam steps (losses and every
    variable after them within 1e-5 of JAX's), then the shared-weight
    beam search: the same tokens and scores within 1e-5."""
    pair = Pair(lambda fl: _translation(pkg(fl)))
    (loss, tokens, scores), _ = pair.jout, pair.tout
    rng = np.random.RandomState(7)
    for _ in range(3):
        pair.steps(1, _translation_batch(rng), [loss.name])
    pair.assert_scopes_close()
    feed = _translation_batch(np.random.RandomState(99), n=8)
    j, t = pair.run(feed, [tokens.name, scores.name])
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], atol=ATOL, rtol=RTOL)
    assert t[0].shape == (8, 4, TT)
