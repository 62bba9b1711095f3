"""Operator registry: op type -> compute over torch tensors — the
counterpart of ``paddle_tpu/fluid/registry.py``.

Every op type the JAX package registers is registered here with the same
named input and output slots and the same attrs, computed through the
port's ``ops/`` (the whole-sequence ``lstm`` and ``gru`` ops through
``ops/rnn.py``, so a fluid program reaches the recurrence kernels #8-#12
on the card). There is no grad op: the executor differentiates a block's
forward with ``torch.autograd`` (``autodiff_grad``).

Compute signature::

    def compute(inputs: Dict[str, List[Tensor]], attrs: Dict) -> Dict[str, List[Tensor]]

Constants are made on the device of the run (:func:`run_device`).
Random ops draw from a ``torch.Generator`` seeded by their ``seed`` attr
(and the run's step, where JAX folds it in): their draws are the port's
own, not JAX's, and a block holding one runs without a CUDA graph
(``RANDOM_OPS``; fluid/executor.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

import torch


class OpRegistry:
    _ops: Dict[str, Callable] = {}

    @classmethod
    def register(cls, op_type: str):
        def deco(fn):
            cls._ops[op_type] = fn
            return fn
        return deco

    @classmethod
    def has(cls, op_type: str) -> bool:
        return op_type in cls._ops

    @classmethod
    def get(cls, op_type: str) -> Callable:
        return cls._ops[op_type]

    @classmethod
    def registered(cls) -> List[str]:
        return sorted(cls._ops)


#: ops whose draws come from a generator seeded on the host each run
#: (dropout only when it trains): a block holding one runs eagerly
RANDOM_OPS = frozenset({"gaussian_random", "uniform_random", "dropout",
                        "nce", "sampling_id"})

_RUN = threading.local()


def run_device() -> torch.device:
    """The device of the run in progress (the executor's), the CPU
    outside one."""
    return getattr(_RUN, "device", None) or torch.device("cpu")


class running_on:
    """Make ``device`` the device constants are made on, for a block."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.prev = getattr(_RUN, "device", None)
        _RUN.device = self.device
        return self

    def __exit__(self, *exc):
        _RUN.device = self.prev


def kernel_route():
    """The route the recurrence ops ask their kernels for: None (the
    kernels on the card), or "plain" inside :class:`routed`."""
    return getattr(_RUN, "route", None)


class routed:
    """Run the recurrence ops (``lstm``, ``gru``) on ``route`` ("plain":
    the kernels' plain versions on any device) inside a block, as the
    model API's ``route=`` does; the card checks hold a program's kernel
    route against it. The executor keys its graphs by the route."""

    def __init__(self, route):
        if route not in (None, "plain"):
            raise ValueError(f"unknown route {route!r} (None or 'plain')")
        self.route = route

    def __enter__(self):
        self.prev = kernel_route()
        _RUN.route = self.route
        return self

    def __exit__(self, *exc):
        _RUN.route = self.prev


def _x(ins, key="X"):
    return ins[key][0]


def _dtype(name) -> torch.dtype:
    return getattr(torch, str(name))


def _generator(attrs, ins, device) -> torch.Generator:
    """The generator of a random op: its ``seed`` attr, and the run's step
    where the op takes one (a fresh draw each run)."""
    seed = int(attrs.get("seed", 0))
    if "Step" in ins:
        seed = seed * 1000003 + int(ins["Step"][0])
    return torch.Generator(device=device).manual_seed(seed)


def _reduce(fn, x, dim, keep):
    if dim is None:
        out = fn(x)
        return out.reshape((1,) * x.dim()) if keep else out
    return fn(x, dim=tuple(dim) if isinstance(dim, (list, tuple)) else dim,
              keepdim=keep)


# ---------------------------------------------------------------- basic math --

@OpRegistry.register("elementwise_add")
def _add(ins, attrs):
    return {"Out": [_x(ins) + _x(ins, "Y")]}


@OpRegistry.register("elementwise_sub")
def _sub(ins, attrs):
    return {"Out": [_x(ins) - _x(ins, "Y")]}


@OpRegistry.register("elementwise_mul")
def _emul(ins, attrs):
    return {"Out": [_x(ins) * _x(ins, "Y")]}


@OpRegistry.register("elementwise_div")
def _ediv(ins, attrs):
    return {"Out": [_x(ins) / _x(ins, "Y")]}


@OpRegistry.register("mul")
def _mul(ins, attrs):
    from ..ops.math import mul as mul_op
    return {"Out": [mul_op(_x(ins), _x(ins, "Y"),
                           x_num_col_dims=attrs.get("x_num_col_dims", 1),
                           y_num_col_dims=attrs.get("y_num_col_dims", 1))]}


@OpRegistry.register("matmul")
def _matmul(ins, attrs):
    from ..ops.math import matmul
    return {"Out": [matmul(_x(ins), _x(ins, "Y"),
                           transpose_x=attrs.get("transpose_X", False),
                           transpose_y=attrs.get("transpose_Y", False))]}


@OpRegistry.register("scale")
def _scale(ins, attrs):
    return {"Out": [_x(ins) * attrs.get("scale", 1.0) + attrs.get("bias", 0.0)]}


@OpRegistry.register("mean")
def _mean(ins, attrs):
    return {"Out": [torch.mean(_x(ins))]}


@OpRegistry.register("sum")
def _sum(ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@OpRegistry.register("reduce_sum")
def _rsum(ins, attrs):
    return {"Out": [_reduce(torch.sum, _x(ins), attrs.get("dim"),
                            attrs.get("keep_dim", False))]}


@OpRegistry.register("reshape")
def _reshape(ins, attrs):
    return {"Out": [torch.reshape(_x(ins), tuple(attrs["shape"]))]}


@OpRegistry.register("transpose")
def _transpose(ins, attrs):
    x = _x(ins)
    axis = attrs.get("axis")
    return {"Out": [x.permute(*(axis if axis is not None
                                else range(x.dim() - 1, -1, -1)))]}


@OpRegistry.register("concat")
def _concat(ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@OpRegistry.register("split")
def _split(ins, attrs):
    from ..ops.math import split as split_op
    outs = split_op(_x(ins), attrs["num_or_sections"], attrs.get("axis", 0))
    return {"Out": list(outs)}


@OpRegistry.register("cast")
def _cast(ins, attrs):
    return {"Out": [_x(ins).to(_dtype(attrs["dtype"]))]}


@OpRegistry.register("clip")
def _clip(ins, attrs):
    return {"Out": [torch.clamp(_x(ins), attrs["min"], attrs["max"])]}


# -------------------------------------------------------------- activations ---

for _name in ("sigmoid", "tanh", "relu", "softmax", "log_softmax", "gelu",
              "leaky_relu", "elu", "softsign", "square", "sqrt", "abs_act",
              "exponential", "brelu", "soft_shrink", "hard_shrink",
              "thresholded_relu", "stanh", "softrelu", "hard_sigmoid",
              "swish", "reciprocal", "log"):
    def _make(name=_name):
        from ..ops import activations as A
        fn = getattr(A, name)

        def compute(ins, attrs, _fn=fn):
            return {"Out": [_fn(_x(ins), **attrs)]}
        return compute
    OpRegistry._ops[_name] = _make()
OpRegistry._ops["abs"] = OpRegistry._ops["abs_act"]


# -------------------------------------------------------------------- fills ---

@OpRegistry.register("fill_constant")
def _fill(ins, attrs):
    return {"Out": [torch.full(tuple(attrs["shape"]), attrs["value"],
                               dtype=_dtype(attrs.get("dtype", "float32")),
                               device=run_device())]}


@OpRegistry.register("fill_init")
def _fill_init(ins, attrs):
    """Startup-program parameter init: attr 'init' is a port initializer
    (``nn/initializer.py``), filled from a CPU generator seeded by attr
    'seed' — runs once, eagerly."""
    p = torch.empty(tuple(attrs["shape"]),
                    dtype=_dtype(attrs.get("dtype", "float32")),
                    device=run_device())
    attrs["init"](p, torch.Generator().manual_seed(int(attrs.get("seed", 0))))
    return {"Out": [p]}


@OpRegistry.register("gaussian_random")
def _gauss(ins, attrs):
    from ..ops.random import gaussian_random
    dev = run_device()
    return {"Out": [gaussian_random(_generator(attrs, {}, dev),
                                    attrs["shape"], attrs.get("mean", 0.0),
                                    attrs.get("std", 1.0), device=dev)]}


@OpRegistry.register("uniform_random")
def _unif(ins, attrs):
    from ..ops.random import uniform_random
    dev = run_device()
    return {"Out": [uniform_random(_generator(attrs, {}, dev),
                                   attrs["shape"], attrs.get("min", -1.0),
                                   attrs.get("max", 1.0), device=dev)]}


@OpRegistry.register("dropout")
def _dropout(ins, attrs):
    from ..ops.random import dropout as drop
    rate = attrs.get("dropout_prob", 0.5)
    x = _x(ins)
    if not attrs.get("is_test", True):
        out = drop(x, rate, _generator(attrs, ins, x.device), train=True)
    else:
        out = x
    return {"Out": [out]}


# ------------------------------------------------------------------- layers ---

@OpRegistry.register("lookup_table")
def _lookup(ins, attrs):
    return {"Out": [ins["W"][0][ins["Ids"][0].long()]]}


@OpRegistry.register("conv2d")
def _conv2d(ins, attrs):
    from ..ops.conv import conv2d
    return {"Out": [conv2d(ins["Input"][0], ins["Filter"][0],
                           stride=attrs.get("strides", 1),
                           padding=attrs.get("paddings", 0),
                           dilation=attrs.get("dilations", 1),
                           groups=attrs.get("groups", 1))]}


@OpRegistry.register("pool2d")
def _pool2d(ins, attrs):
    from ..ops import pool as P
    is_max = attrs.get("pooling_type", "max") == "max"
    if attrs.get("global_pooling", False):
        g = P.global_max_pool2d if is_max else P.global_avg_pool2d
        return {"Out": [g(_x(ins))]}
    fn = P.max_pool2d if is_max else P.avg_pool2d
    return {"Out": [fn(_x(ins), attrs.get("ksize", 2),
                       attrs.get("strides"), attrs.get("paddings", 0))]}


@OpRegistry.register("batch_norm_infer")
def _bn_infer(ins, attrs):
    from ..ops.norm import batch_norm
    y, _, _ = batch_norm(_x(ins), ins["Scale"][0], ins["Bias"][0],
                         ins["Mean"][0], ins["Variance"][0],
                         train=False, eps=attrs.get("epsilon", 1e-5))
    return {"Out": [y]}


@OpRegistry.register("layer_norm")
def _ln(ins, attrs):
    from ..ops.norm import layer_norm
    return {"Out": [layer_norm(_x(ins), ins["Scale"][0], ins["Bias"][0],
                               eps=attrs.get("epsilon", 1e-5))]}


# ------------------------------------------------------------------- losses ---

@OpRegistry.register("cross_entropy")
def _ce(ins, attrs):
    from ..ops.loss import cross_entropy
    return {"Y": [cross_entropy(_x(ins), ins["Label"][0],
                                soft_label=attrs.get("soft_label", False))]}


@OpRegistry.register("softmax_with_cross_entropy")
def _sce(ins, attrs):
    from ..ops.loss import softmax_with_cross_entropy
    logits = ins["Logits"][0]
    return {"Loss": [softmax_with_cross_entropy(logits, ins["Label"][0])],
            "Softmax": [torch.softmax(logits, -1)]}


@OpRegistry.register("sigmoid_cross_entropy_with_logits")
def _sigce(ins, attrs):
    from ..ops.loss import sigmoid_cross_entropy_with_logits
    return {"Out": [sigmoid_cross_entropy_with_logits(_x(ins),
                                                      ins["Label"][0])]}


@OpRegistry.register("square_error")
def _sqerr(ins, attrs):
    from ..ops.loss import square_error
    return {"Out": [square_error(_x(ins), ins["Label"][0])]}


# ------------------------------------------------------------------ metrics ---

@OpRegistry.register("accuracy")
def _acc(ins, attrs):
    from ..ops.metrics import accuracy
    correct, total = accuracy(_x(ins, "Out"), ins["Label"][0])
    return {"Accuracy": [correct / total], "Correct": [correct],
            "Total": [total]}


@OpRegistry.register("top_k")
def _topk(ins, attrs):
    vals, idx = torch.topk(_x(ins), attrs["k"])
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


# ---------------------------------------------------------------- optimizer ---

@OpRegistry.register("sgd")
def _sgd(ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    return {"ParamOut": [p - lr * g]}


@OpRegistry.register("momentum")
def _momentum(ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0]
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@OpRegistry.register("adam")
def _adam(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0]
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mhat = m_new / (1 - b1p)
    vhat = v_new / (1 - b2p)
    return {"ParamOut": [p - lr * mhat / (torch.sqrt(vhat) + eps)],
            "Moment1Out": [m_new], "Moment2Out": [v_new],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


@OpRegistry.register("autodiff_grad")
def _autodiff_stub(ins, attrs):
    raise RuntimeError("autodiff_grad is run by the executor, not directly")


# ------------------------------------------------------ sequence / recurrent --
# A whole masked LSTM/GRU pass is ONE op: the port's ops/rnn.py runs it
# through the whole-sequence kernels (fused=None, JAX's "auto", takes
# them; the route planner picks the step loop where no grid fits).

def _fused(attrs) -> bool:
    fused = attrs.get("fused", None)
    return True if fused is None else bool(fused)


@OpRegistry.register("lstm")
def _lstm(ins, attrs):
    from ..ops.rnn import lstm
    out, state = lstm(ins["X"][0],
                      ins["Lengths"][0] if "Lengths" in ins else None,
                      ins["W"][0], ins["U"][0],
                      ins["B"][0] if "B" in ins else None,
                      reverse=attrs.get("reverse", False),
                      forget_bias=attrs.get("forget_bias", 1.0),
                      fused=_fused(attrs), route=kernel_route())
    return {"Out": [out], "LastH": [state.h], "LastC": [state.c]}


@OpRegistry.register("gru")
def _gru(ins, attrs):
    from ..ops.rnn import gru
    out, last = gru(ins["X"][0],
                    ins["Lengths"][0] if "Lengths" in ins else None,
                    ins["W"][0], ins["U"][0],
                    ins["B"][0] if "B" in ins else None,
                    reverse=attrs.get("reverse", False),
                    fused=_fused(attrs), route=kernel_route())
    return {"Out": [out], "LastH": [last]}


@OpRegistry.register("simple_rnn")
def _simple_rnn(ins, attrs):
    """Vanilla (Elman) recurrence: h_t = act(x_t [@W] + h_{t-1}@U + b)."""
    from ..ops import activations as _acts
    from ..ops.rnn import simple_rnn
    act = _acts.get(attrs.get("act", "tanh"))
    out, last = simple_rnn(
        ins["X"][0], ins["Lengths"][0] if "Lengths" in ins else None,
        ins["W"][0] if "W" in ins else None, ins["U"][0],
        ins["B"][0] if "B" in ins else None,
        act=act, reverse=attrs.get("reverse", False))
    return {"Out": [out], "LastH": [last]}


@OpRegistry.register("sequence_pool")
def _seq_pool(ins, attrs):
    from ..ops.sequence import sequence_pool
    return {"Out": [sequence_pool(ins["X"][0], ins["Lengths"][0],
                                  attrs.get("pool_type", "average"))]}


@OpRegistry.register("sequence_conv")
def _seq_conv(ins, attrs):
    from ..ops.sequence import sequence_conv
    return {"Out": [sequence_conv(
        ins["X"][0], ins["Lengths"][0], ins["Filter"][0],
        context_start=attrs.get("context_start", -1),
        context_length=attrs.get("context_length", 3))]}


@OpRegistry.register("sequence_last_step")
def _seq_last(ins, attrs):
    from ..ops.sequence import sequence_last_step
    return {"Out": [sequence_last_step(ins["X"][0], ins["Lengths"][0])]}


@OpRegistry.register("sequence_first_step")
def _seq_first(ins, attrs):
    from ..ops.sequence import sequence_first_step
    return {"Out": [sequence_first_step(ins["X"][0], ins["Lengths"][0])]}


# ------------------------------------------------------- control flow stubs --
# Run structurally by the executor (fluid/executor.py); registered so
# Operator construction validates.

for _cf in ("while", "conditional_block", "static_rnn", "beam_search_gen"):
    def _cf_stub(ins, attrs, _n=_cf):
        raise RuntimeError(f"'{_n}' is run by the executor, not directly")
    OpRegistry._ops[_cf] = _cf_stub


# --------------------------------------------------- tensor arrays & compare --
# A TensorArray is a fixed-capacity [T, ...] buffer: write = an update at
# the index, read = a select at it (both on the device, index included).

@OpRegistry.register("array_write")
def _array_write(ins, attrs):
    x, i = _x(ins), ins["I"][0]
    if "Array" in ins:
        arr = ins["Array"][0]
    else:
        arr = x.new_zeros((attrs["capacity"],) + tuple(x.shape))
    idx = torch.reshape(i, (1,)).long()
    return {"Out": [arr.index_copy(0, idx, x[None].to(arr.dtype))]}


@OpRegistry.register("array_read")
def _array_read(ins, attrs):
    arr, i = _x(ins, "Array"), ins["I"][0]
    return {"Out": [arr.index_select(0, torch.reshape(i, (1,)).long())[0]]}


@OpRegistry.register("array_length")
def _array_length(ins, attrs):
    arr = ins["Array"][0]
    return {"Out": [torch.full((), arr.shape[0], dtype=torch.int32,
                               device=arr.device)]}


@OpRegistry.register("lod_tensor_to_array")
def _lod_to_array(ins, attrs):
    return {"Out": [torch.movedim(_x(ins), 1, 0)]}


@OpRegistry.register("array_to_lod_tensor")
def _array_to_lod(ins, attrs):
    return {"Out": [torch.movedim(_x(ins), 0, 1)]}


@OpRegistry.register("increment")
def _increment(ins, attrs):
    x = _x(ins)
    return {"Out": [x + torch.full((), attrs.get("step", 1), dtype=x.dtype,
                                   device=x.device)]}


def _compare(fn):
    def compute(ins, attrs):
        return {"Out": [fn(_x(ins), ins["Y"][0])]}
    return compute


OpRegistry._ops["less_than"] = _compare(lambda a, b: a < b)
OpRegistry._ops["less_equal"] = _compare(lambda a, b: a <= b)
OpRegistry._ops["greater_than"] = _compare(lambda a, b: a > b)
OpRegistry._ops["greater_equal"] = _compare(lambda a, b: a >= b)
OpRegistry._ops["equal"] = _compare(lambda a, b: a == b)
OpRegistry._ops["not_equal"] = _compare(lambda a, b: a != b)
OpRegistry._ops["logical_and"] = _compare(torch.logical_and)
OpRegistry._ops["logical_or"] = _compare(torch.logical_or)


@OpRegistry.register("logical_not")
def _lnot(ins, attrs):
    return {"Out": [torch.logical_not(_x(ins))]}


@OpRegistry.register("assign")
def _assign(ins, attrs):
    return {"Out": [_x(ins)]}


@OpRegistry.register("fill_zeros_like")
def _zeros_like(ins, attrs):
    return {"Out": [torch.zeros_like(_x(ins))]}


@OpRegistry.register("fill_constant_batch_size_like")
def _fill_bsl(ins, attrs):
    ref = _x(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), attrs["value"],
                               dtype=_dtype(attrs.get("dtype", "float32")),
                               device=ref.device)]}


@OpRegistry.register("is_empty")
def _is_empty(ins, attrs):
    x = _x(ins)
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


# ------------------------------------------------------------- simple math ---

@OpRegistry.register("sign")
def _sign(ins, attrs):
    return {"Out": [torch.sign(_x(ins))]}


@OpRegistry.register("minus")
def _minus(ins, attrs):
    return {"Out": [_x(ins) - _x(ins, "Y")]}


@OpRegistry.register("pow")
def _pow(ins, attrs):
    return {"Out": [torch.pow(_x(ins), attrs.get("factor", 1.0))]}


@OpRegistry.register("reduce_mean")
def _rmean(ins, attrs):
    return {"Out": [_reduce(torch.mean, _x(ins), attrs.get("dim"),
                            attrs.get("keep_dim", False))]}


@OpRegistry.register("reduce_max")
def _rmax(ins, attrs):
    return {"Out": [_reduce(torch.amax, _x(ins), attrs.get("dim"),
                            attrs.get("keep_dim", False))]}


@OpRegistry.register("reduce_min")
def _rmin(ins, attrs):
    return {"Out": [_reduce(torch.amin, _x(ins), attrs.get("dim"),
                            attrs.get("keep_dim", False))]}


@OpRegistry.register("expand")
def _expand(ins, attrs):
    from ..ops.math import expand
    return {"Out": [expand(_x(ins), attrs["expand_times"])]}


@OpRegistry.register("pad")
def _pad(ins, attrs):
    from ..ops.math import pad
    return {"Out": [pad(_x(ins), attrs["paddings"],
                        attrs.get("pad_value", 0.0))]}


@OpRegistry.register("crop")
def _crop(ins, attrs):
    from ..ops.math import crop
    x = _x(ins)
    # non-positive shape entries mean "to the end"
    shape = [x.shape[i] - o if s <= 0 else s
             for i, (o, s) in enumerate(zip(attrs["offsets"],
                                            attrs["shape"]))]
    return {"Out": [crop(x, attrs["offsets"], shape)]}


@OpRegistry.register("gather")
def _gather(ins, attrs):
    from ..ops.math import gather
    return {"Out": [gather(_x(ins), ins["Index"][0], attrs.get("axis", 0))]}


@OpRegistry.register("scatter")
def _scatter(ins, attrs):
    from ..ops.math import scatter
    return {"Out": [scatter(_x(ins, "Ref"), ins["Index"][0],
                            ins["Updates"][0],
                            overwrite=attrs.get("overwrite", True))]}


@OpRegistry.register("multiplex")
def _multiplex(ins, attrs):
    # out[b] = X[ids[b]][b] (multiplex_op.cc row selection)
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)          # [n, B, ...]
    return {"Out": [stacked[ids, torch.arange(ids.shape[0],
                                              device=ids.device)]]}


@OpRegistry.register("clip_by_norm")
def _clip_norm(ins, attrs):
    from ..ops.math import clip_by_norm
    return {"Out": [clip_by_norm(_x(ins), attrs["max_norm"])]}


@OpRegistry.register("l1_norm")
def _l1norm(ins, attrs):
    return {"Out": [torch.sum(torch.abs(_x(ins)))]}


@OpRegistry.register("squared_l2_norm")
def _sql2(ins, attrs):
    from ..ops.loss import squared_l2_norm
    return {"Out": [squared_l2_norm(_x(ins))]}


@OpRegistry.register("squared_l2_distance")
def _sql2d(ins, attrs):
    x, y = _x(ins), _x(ins, "Y")
    d = (x - y).reshape(x.shape[0], -1)
    return {"Out": [torch.sum(d * d, dim=1, keepdim=True)],
            "sub_result": [d]}


@OpRegistry.register("cos_sim")
def _cos_sim(ins, attrs):
    from ..ops.math import cos_sim
    return {"Out": [cos_sim(_x(ins), _x(ins, "Y"))]}


@OpRegistry.register("l2_normalize")
def _l2n(ins, attrs):
    from ..ops.math import l2_normalize
    return {"Out": [l2_normalize(_x(ins), attrs.get("axis", -1))]}


@OpRegistry.register("prelu")
def _prelu(ins, attrs):
    x, alpha = _x(ins), ins["Alpha"][0]
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@OpRegistry.register("conv_shift")
def _conv_shift(ins, attrs):
    # circular correlation (conv_shift_op.cc): X [B, M], Y [B, N]
    x, y = _x(ins), _x(ins, "Y")
    M, N = x.shape[1], y.shape[1]
    half = N // 2
    idx = (torch.arange(M, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % M
    windows = x[:, idx]                             # [B, M, N]
    return {"Out": [torch.einsum("bmn,bn->bm", windows, y)]}


@OpRegistry.register("bilinear_tensor_product")
def _btp(ins, attrs):
    # out[:, k] = x W_k y^T + b
    x, y, w = _x(ins), _x(ins, "Y"), ins["Weight"][0]   # w: [K, Dx, Dy]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if "Bias" in ins:
        out = out + ins["Bias"][0]
    return {"Out": [out]}


@OpRegistry.register("interpolation")
def _interp(ins, attrs):
    from ..ops.math import interpolation
    return {"Out": [interpolation(_x(ins), _x(ins, "Y"), ins["W"][0])]}


# ------------------------------------------------------------ conv / pool ----

@OpRegistry.register("depthwise_conv2d")
def _dwconv(ins, attrs):
    from ..ops.conv import depthwise_conv2d
    return {"Out": [depthwise_conv2d(ins["Input"][0], ins["Filter"][0],
                                     stride=attrs.get("strides", 1),
                                     padding=attrs.get("paddings", 0))]}


@OpRegistry.register("conv2d_transpose")
def _deconv(ins, attrs):
    from ..ops.conv import conv2d_transpose
    return {"Out": [conv2d_transpose(ins["Input"][0], ins["Filter"][0],
                                     stride=attrs.get("strides", 1),
                                     padding=attrs.get("paddings", 0))]}


@OpRegistry.register("conv3d")
def _conv3d(ins, attrs):
    from ..ops.conv import conv3d
    return {"Out": [conv3d(ins["Input"][0], ins["Filter"][0],
                           stride=attrs.get("strides", 1),
                           padding=attrs.get("paddings", 0),
                           dilation=attrs.get("dilations", 1),
                           groups=attrs.get("groups", 1))]}


@OpRegistry.register("pool3d")
def _pool3d(ins, attrs):
    from ..ops import pool as P
    fn = (P.max_pool3d if attrs.get("pooling_type", "max") == "max"
          else P.avg_pool3d)
    return {"Out": [fn(_x(ins), attrs.get("ksize", 2),
                       attrs.get("strides"), attrs.get("paddings", 0))]}


@OpRegistry.register("pool2d_with_index")
def _pool_idx(ins, attrs):
    from ..ops.pool import max_pool2d_with_index
    out, idx = max_pool2d_with_index(_x(ins), attrs.get("ksize", 2),
                                     attrs.get("strides"),
                                     attrs.get("paddings", 0))
    return {"Out": [out], "Mask": [idx]}


@OpRegistry.register("lrn")
def _lrn(ins, attrs):
    from ..ops.norm import lrn
    return {"Out": [lrn(_x(ins), size=attrs.get("n", 5),
                        alpha=attrs.get("alpha", 1e-4),
                        beta=attrs.get("beta", 0.75),
                        k=attrs.get("k", 1.0))]}


@OpRegistry.register("maxout")
def _maxout(ins, attrs):
    from ..ops.conv import maxout
    return {"Out": [maxout(_x(ins), attrs["groups"])]}


@OpRegistry.register("roi_pool")
def _roi(ins, attrs):
    from ..ops.pool import roi_pool
    return {"Out": [roi_pool(_x(ins), ins["ROIs"][0],
                             (attrs["pooled_height"], attrs["pooled_width"]),
                             spatial_scale=attrs.get("spatial_scale", 1.0))]}


@OpRegistry.register("row_conv")
def _row_conv(ins, attrs):
    from ..ops.conv import row_conv
    return {"Out": [row_conv(_x(ins), ins["Filter"][0])]}


@OpRegistry.register("block_expand")
def _block_expand(ins, attrs):
    from ..ops.conv import im2col
    return {"Out": [im2col(_x(ins), attrs["block"], attrs.get("strides", 1),
                           attrs.get("paddings", 0))]}


@OpRegistry.register("bilinear_interp")
def _bilinear(ins, attrs):
    from ..ops.conv import bilinear_interp
    return {"Out": [bilinear_interp(_x(ins), attrs["out_h"],
                                    attrs["out_w"])]}


@OpRegistry.register("spp")
def _spp(ins, attrs):
    from ..ops.pool import spatial_pyramid_pool
    return {"Out": [spatial_pyramid_pool(_x(ins), attrs["pyramid_height"],
                                         attrs.get("pooling_type", "max"))]}


# ------------------------------------------------------------- batch norm ----

@OpRegistry.register("batch_norm")
def _batch_norm(ins, attrs):
    """Training-capable batch norm: MeanOut/VarianceOut alias the
    persistable stat vars, which the executor writes back after the run."""
    from ..ops.norm import batch_norm
    y, new_mean, new_var = batch_norm(
        _x(ins), ins["Scale"][0], ins["Bias"][0],
        ins["Mean"][0], ins["Variance"][0],
        train=not attrs.get("is_test", False),
        momentum=attrs.get("momentum", 0.9),
        eps=attrs.get("epsilon", 1e-5))
    return {"Y": [y], "MeanOut": [new_mean], "VarianceOut": [new_var]}


# ------------------------------------------------------------------ losses ---

def _loss_reg(name, fn_name, x_key="X", label_key="Label", out_key="Out",
              **fixed):
    from ..ops import loss as L
    fn = getattr(L, fn_name)

    def compute(ins, attrs, _fn=fn):
        kw = dict(fixed)
        for a in ("sigma", "delta", "margin", "eps"):
            if a in attrs:
                kw[a] = attrs[a]
        return {out_key: [_fn(ins[x_key][0], ins[label_key][0], **kw)]}
    OpRegistry._ops[name] = compute


_loss_reg("smooth_l1_loss", "smooth_l1")
_loss_reg("huber_loss", "huber_regression")
_loss_reg("modified_huber_loss", "modified_huber")
_loss_reg("hinge_loss", "hinge")
_loss_reg("log_loss", "log_loss", x_key="Predicted")
_loss_reg("multi_binary_label_cross_entropy",
          "multi_binary_label_cross_entropy")
_loss_reg("soft_binary_class_cross_entropy",
          "soft_binary_class_cross_entropy")
_loss_reg("kldiv_loss", "kldiv_loss", label_key="Target")


@OpRegistry.register("rank_loss")
def _rank_loss(ins, attrs):
    from ..ops.loss import rank_loss
    return {"Out": [rank_loss(ins["Left"][0], ins["Right"][0],
                              ins["Label"][0])]}


@OpRegistry.register("margin_rank_loss")
def _margin_rank(ins, attrs):
    from ..ops.loss import margin_rank_loss
    return {"Out": [margin_rank_loss(ins["X1"][0], ins["X2"][0],
                                     ins["Label"][0],
                                     margin=attrs.get("margin", 0.0))]}


# --------------------------------------------------------------- sequences ---

@OpRegistry.register("sequence_expand")
def _seq_expand(ins, attrs):
    from ..ops.sequence import sequence_expand
    max_len = ins["Ref"][0].shape[1] if "Ref" in ins else attrs["max_len"]
    return {"Out": [sequence_expand(_x(ins), ins["RefLengths"][0],
                                    max_len)]}


@OpRegistry.register("sequence_softmax")
def _seq_softmax(ins, attrs):
    x, lengths = _x(ins), ins["Lengths"][0]
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths.to(x.device)[:, None])
    sm = torch.softmax(torch.where(mask, x, -1e9), dim=1)
    return {"Out": [torch.where(mask, sm, 0.0)]}


@OpRegistry.register("sequence_reverse")
def _seq_rev(ins, attrs):
    from ..ops.sequence import sequence_reverse
    return {"Out": [sequence_reverse(_x(ins), ins["Lengths"][0])]}


@OpRegistry.register("sequence_slice")
def _seq_slice(ins, attrs):
    from ..ops.sequence import sequence_slice
    x = _x(ins)
    return {"Out": [sequence_slice(x, ins["Lengths"][0], ins["Offset"][0],
                                   ins["Length"][0],
                                   attrs.get("max_out", x.shape[1]))]}


@OpRegistry.register("sequence_concat")
def _seq_concat(ins, attrs):
    from ..ops.sequence import sequence_concat
    out, lengths = sequence_concat(ins["X"][0], ins["XLengths"][0],
                                   ins["Y"][0], ins["YLengths"][0])
    return {"Out": [out], "OutLengths": [lengths]}


@OpRegistry.register("context_projection")
def _ctx_proj(ins, attrs):
    from ..ops.sequence import context_projection
    return {"Out": [context_projection(_x(ins), ins["Lengths"][0],
                                       attrs.get("context_start", -1),
                                       attrs.get("context_length", 3))]}


@OpRegistry.register("lod_reset")
def _lod_reset(ins, attrs):
    # lengths live beside data: the op passes data through and emits the
    # new lengths
    x = _x(ins)
    return {"Out": [x],
            "OutLengths": [ins["Lengths"][0] if "Lengths" in ins
                           else torch.as_tensor(attrs["target_lengths"],
                                                device=x.device)]}


# ----------------------------------------------------------------- CRF/CTC ---

@OpRegistry.register("linear_chain_crf")
def _crf(ins, attrs):
    from ..ops.crf import crf_loss
    t = ins["Transition"][0]   # [N+2, N] packed like the reference
    ll = crf_loss(ins["Emission"][0], ins["Label"][0], ins["Lengths"][0],
                  t[0], t[1], t[2:])
    return {"LogLikelihood": [ll]}


@OpRegistry.register("crf_decoding")
def _crf_dec(ins, attrs):
    from ..ops.crf import crf_decode
    t = ins["Transition"][0]
    tags, score = crf_decode(ins["Emission"][0], ins["Lengths"][0],
                             t[0], t[1], t[2:])
    return {"ViterbiPath": [tags], "Score": [score]}


@OpRegistry.register("warpctc")
def _ctc(ins, attrs):
    from ..ops.ctc import ctc_loss
    return {"Loss": [ctc_loss(ins["Logits"][0], ins["LogitsLengths"][0],
                              ins["Label"][0], ins["LabelLengths"][0],
                              blank=attrs.get("blank", 0))]}


@OpRegistry.register("ctc_greedy_decode")
def _ctc_dec(ins, attrs):
    from ..ops.ctc import ctc_greedy_decode
    toks, lens = ctc_greedy_decode(ins["Logits"][0], ins["LogitsLengths"][0],
                                   blank=attrs.get("blank", 0))
    return {"Out": [toks], "OutLengths": [lens]}


# -------------------------------------------------------------- nce / hsig ---

@OpRegistry.register("nce")
def _nce(ins, attrs):
    from ..ops.nce import nce_loss
    hidden = ins["Input"][0]
    return {"Cost": [nce_loss(
        hidden, ins["Label"][0], ins["Weight"][0],
        ins["Bias"][0] if "Bias" in ins else None,
        _generator(attrs, ins, hidden.device),
        num_neg_samples=attrs.get("num_neg_samples", 10))]}


@OpRegistry.register("hierarchical_sigmoid")
def _hsig(ins, attrs):
    from ..ops.nce import build_huffman_codes, hsigmoid_loss
    hidden = ins["Input"][0]
    if "Paths" in ins:
        paths, codes = ins["Paths"][0], ins["Codes"][0]
    else:
        paths, codes = build_huffman_codes(attrs["num_classes"],
                                           device=hidden.device)
    return {"Cost": [hsigmoid_loss(
        hidden, ins["Label"][0], ins["InnerW"][0],
        ins["InnerB"][0] if "InnerB" in ins else None, paths, codes)]}


# ----------------------------------------------------------------- metrics ---

@OpRegistry.register("auc")
def _auc(ins, attrs):
    from ..ops.metrics import auc_from_histogram, auc_histogram
    pos, neg = auc_histogram(ins["Out"][0], ins["Label"][0],
                             attrs.get("num_thresholds", 200))
    return {"AUC": [auc_from_histogram(pos, neg)],
            "PosHist": [pos], "NegHist": [neg]}


@OpRegistry.register("precision_recall")
def _pr(ins, attrs):
    from ..ops.metrics import precision_recall_counts
    counts = precision_recall_counts(ins["Out"][0], ins["Label"][0],
                                     attrs["num_classes"])
    tp, fp, fn_ = counts
    return {"TP": [tp], "FP": [fp], "FN": [fn_]}


@OpRegistry.register("chunk_eval")
def _chunk(ins, attrs):
    from ..ops.metrics import chunk_count
    c, p, l = chunk_count(ins["Inference"][0], ins["Label"][0],
                          ins["Lengths"][0],
                          scheme=attrs.get("chunk_scheme", "IOB"),
                          num_chunk_types=attrs.get("num_chunk_types", 1))
    return {"Correct": [c], "Predicted": [p], "Labeled": [l]}


@OpRegistry.register("positive_negative_pair")
def _pnpair(ins, attrs):
    # over query groups, count concordant/discordant score pairs
    score, label, qid = ins["Score"][0], ins["Label"][0], ins["QueryID"][0]
    s, l, q = score.reshape(-1), label.reshape(-1), qid.reshape(-1)
    same_q = q[:, None] == q[None, :]
    ds = s[:, None] - s[None, :]
    dl = l[:, None] - l[None, :]
    valid = same_q & (dl > 0)                       # i more relevant than j
    return {"PositivePair": [torch.sum(valid & (ds > 0)).float()],
            "NegativePair": [torch.sum(valid & (ds < 0)).float()],
            "NeutralPair": [torch.sum(valid & (ds == 0)).float()]}


# --------------------------------------------------------------- detection ---

@OpRegistry.register("prior_box")
def _prior_box(ins, attrs):
    from ..ops.detection import prior_box
    boxes, variances = prior_box(
        tuple(attrs["feature_hw"]), tuple(attrs["image_hw"]),
        min_size=attrs["min_size"], max_size=attrs.get("max_size"),
        aspect_ratios=attrs.get("aspect_ratios", (2.0,)),
        flip=attrs.get("flip", True), clip=attrs.get("clip", True),
        variance=attrs.get("variance", (0.1, 0.1, 0.2, 0.2)),
        device=run_device())
    return {"Boxes": [boxes], "Variances": [variances]}


@OpRegistry.register("multibox_loss")
def _mb_loss(ins, attrs):
    from ..ops.detection import multibox_loss
    loss = torch.func.vmap(
        lambda lp, cl, gb, gl, gm: multibox_loss(
            lp, cl, ins["PriorBox"][0], ins["PriorVar"][0], gb, gl, gm,
            neg_pos_ratio=attrs.get("neg_pos_ratio", 3.0),
            overlap_threshold=attrs.get("overlap_threshold", 0.5),
            background_id=attrs.get("background_id", 0))
    )(ins["Loc"][0], ins["Conf"][0], ins["GTBox"][0], ins["GTLabel"][0],
      ins["GTMask"][0])
    return {"Loss": [loss]}


@OpRegistry.register("detection_output")
def _det_out(ins, attrs):
    from ..ops.detection import detection_output
    boxes, scores, valid = torch.func.vmap(
        lambda lp, cl: detection_output(
            lp, cl, ins["PriorBox"][0], ins["PriorVar"][0],
            num_classes=attrs["num_classes"],
            background_id=attrs.get("background_id", 0),
            iou_threshold=attrs.get("nms_threshold", 0.45),
            score_threshold=attrs.get("score_threshold", 0.01),
            keep_top_k=attrs.get("keep_top_k", 100))
    )(ins["Loc"][0], ins["Conf"][0])
    return {"Boxes": [boxes], "Scores": [scores], "Valid": [valid]}


# ---------------------------------------------------------------- rnn units --

@OpRegistry.register("lstm_unit")
def _lstm_unit(ins, attrs):
    from ..ops.rnn import LSTMState, lstm_cell
    state = LSTMState(h=ins["HPrev"][0], c=ins["CPrev"][0])
    new = lstm_cell(_x(ins), state, ins["U"][0],
                    ins["B"][0] if "B" in ins else None,
                    forget_bias=attrs.get("forget_bias", 0.0))
    return {"H": [new.h], "C": [new.c]}


@OpRegistry.register("gru_unit")
def _gru_unit(ins, attrs):
    from ..ops.rnn import gru_cell
    h = gru_cell(_x(ins), ins["HPrev"][0], ins["U"][0],
                 ins["B"][0] if "B" in ins else None)
    return {"H": [h]}


# ---------------------------------------------------------- optimizer ops ----

@OpRegistry.register("adagrad")
def _adagrad(ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@OpRegistry.register("adadelta")
def _adadelta(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ag, au = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * g * g
    upd = torch.sqrt(au + eps) / torch.sqrt(ag_new + eps) * g
    au_new = rho * au + (1 - rho) * upd * upd
    return {"ParamOut": [p - upd], "AvgSquaredGradOut": [ag_new],
            "AvgSquaredUpdateOut": [au_new]}


@OpRegistry.register("rmsprop")
def _rmsprop(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
            "MomentOut": [mom_new]}


@OpRegistry.register("adamax")
def _adamax(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, u, b1p = ins["Moment"][0], ins["InfNorm"][0], ins["Beta1Pow"][0]
    lr = ins["LearningRate"][0]
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    p_new = p - (lr / (1 - b1p)) * m_new / (u_new + eps)
    return {"ParamOut": [p_new], "MomentOut": [m_new], "InfNormOut": [u_new],
            "Beta1PowOut": [b1p * b1]}


@OpRegistry.register("decayed_adagrad")
def _dec_adagrad(ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


def _shrink(prox, lr, l1, l2):
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@OpRegistry.register("proximal_gd")
def _prox_gd(ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    return {"ParamOut": [_shrink(p - lr * g, lr, l1, l2)]}


@OpRegistry.register("proximal_adagrad")
def _prox_adagrad(ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    m_new = m + g * g
    eff_lr = lr / (torch.sqrt(m_new) + 1e-10)
    return {"ParamOut": [_shrink(p - eff_lr * g, eff_lr, l1, l2)],
            "MomentOut": [m_new]}


@OpRegistry.register("ftrl")
def _ftrl(ins, attrs):
    """FTRL-proximal (lr_power fixed at -0.5)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    lr = ins["LearningRate"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    sq_new = sq + g * g
    sigma = (torch.sqrt(sq_new) - torch.sqrt(sq)) / lr
    lin_new = lin + g - sigma * p
    quad = torch.sqrt(sq_new) / lr + 2.0 * l2
    p_new = torch.where(torch.abs(lin_new) > l1,
                        (torch.sign(lin_new) * l1 - lin_new) / quad,
                        torch.zeros_like(p))
    return {"ParamOut": [p_new], "SquaredAccumOut": [sq_new],
            "LinearAccumOut": [lin_new]}


@OpRegistry.register("squeeze")
def _squeeze(ins, attrs):
    x, axis = _x(ins), attrs.get("axis")
    if axis is None:
        return {"Out": [torch.squeeze(x)]}
    return {"Out": [torch.squeeze(x, tuple(axis) if isinstance(
        axis, (list, tuple)) else axis)]}


@OpRegistry.register("unsqueeze")
def _unsqueeze(ins, attrs):
    x, axis = _x(ins), attrs["axis"]
    axes = sorted(a % (x.dim() + len(axis)) for a in axis) \
        if isinstance(axis, (list, tuple)) else [axis]
    for a in axes:
        x = torch.unsqueeze(x, a)
    return {"Out": [x]}


def _nested(ins):
    from ..core.lod import NestedSeqBatch
    return NestedSeqBatch(_x(ins), ins["SubLengths"][0], ins["SeqLengths"][0])


@OpRegistry.register("nested_seq_pool")
def _nested_pool(ins, attrs):
    from ..ops.sequence import nested_seq_pool
    return {"Out": [nested_seq_pool(_nested(ins),
                                    attrs.get("pool_type", "average")).data]}


@OpRegistry.register("nested_last_step")
def _nested_last(ins, attrs):
    from ..ops.sequence import nested_last_step
    return {"Out": [nested_last_step(_nested(ins)).data]}


@OpRegistry.register("nested_lstm")
def _nested_lstm(ins, attrs):
    """Inner LSTM per sub-sequence (state resets at sub-sequence
    boundaries)."""
    from ..ops.rnn import lstm
    from ..ops.sequence import nested_rnn
    out, last = nested_rnn(lstm, _nested(ins), ins["W"][0], ins["U"][0],
                           ins["B"][0] if "B" in ins else None,
                           reverse=attrs.get("reverse", False))
    return {"Out": [out], "LastH": [last.data]}


# ---------------------------------------------------------------------------
# gen-1 layer-zoo completions (small ops backing the v2 *_layer DSL surface)
# ---------------------------------------------------------------------------

@OpRegistry.register("argmax")
def _argmax(ins, attrs):
    return {"Out": [torch.argmax(_x(ins), dim=attrs.get("axis", -1))
                    .to(torch.int32)]}


@OpRegistry.register("power")
def _power(ins, attrs):
    """y = x^w, w a learned scalar; sign-preserving for negative inputs."""
    x, w = _x(ins), ins["W"][0]
    return {"Out": [torch.sign(x) * torch.pow(torch.abs(x) + 1e-12,
                                              torch.reshape(w, ()))]}


@OpRegistry.register("slope_intercept")
def _slope_intercept(ins, attrs):
    return {"Out": [attrs.get("slope", 1.0) * _x(ins)
                    + attrs.get("intercept", 0.0)]}


@OpRegistry.register("sum_to_one_norm")
def _sum_to_one_norm(ins, attrs):
    x = _x(ins)
    s = torch.sum(x, dim=-1, keepdim=True)
    return {"Out": [x / torch.where(torch.abs(s) < 1e-12, 1.0, s)]}


@OpRegistry.register("linear_comb")
def _linear_comb(ins, attrs):
    """weights [B, M] over M vectors [B, M*D] -> [B, D]."""
    w, x = ins["W"][0], _x(ins)
    B = x.shape[0]
    M = w.shape[-1]
    D = x.shape[-1] // M
    return {"Out": [torch.einsum("bm,bmd->bd", w, x.reshape(B, M, D))]}


@OpRegistry.register("repeat")
def _repeat(ins, attrs):
    return {"Out": [torch.repeat_interleave(_x(ins), attrs["times"],
                                            dim=attrs.get("axis", -1))]}


@OpRegistry.register("rotate")
def _rotate(ins, attrs):
    """90-degree CCW rotation of [B, H, W, C] maps."""
    return {"Out": [torch.rot90(_x(ins), 1, (1, 2))]}


@OpRegistry.register("seq_reshape")
def _seq_reshape(ins, attrs):
    x = _x(ins)
    return {"Out": [x.reshape(x.shape[0], -1, attrs["new_dim"])]}


@OpRegistry.register("sampling_id")
def _sampling_id(ins, attrs):
    """Class ids sampled from row distributions by the Gumbel trick."""
    x = _x(ins)
    u = torch.rand(x.shape, generator=_generator(attrs, {}, x.device),
                   dtype=x.dtype, device=x.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
    logp = torch.log(torch.clamp(x, min=1e-20)) if attrs.get(
        "input_is_prob", True) else x
    return {"Out": [torch.argmax(logp + g, dim=-1).to(torch.int32)]}


@OpRegistry.register("cross_entropy_over_selfnorm")
def _ce_selfnorm(ins, attrs):
    """CE on unnormalised logits plus alpha * log(Z)^2."""
    logits, label = _x(ins), ins["Label"][0]
    alpha = attrs.get("softmax_selfnorm_alpha", 0.1)
    logz = torch.logsumexp(logits, dim=-1)
    logp = logits - logz[..., None]
    nll = -torch.gather(logp, -1, label[..., None].long())[..., 0]
    return {"Out": [nll + alpha * logz * logz]}


@OpRegistry.register("huber_classification")
def _huber_cls(ins, attrs):
    from ..ops import loss as L
    return {"Out": [L.huber_classification(_x(ins), ins["Label"][0])]}


@OpRegistry.register("lambda_cost")
def _lambda_cost(ins, attrs):
    """Listwise LambdaRank: pairwise logistic losses weighted by
    |delta NDCG|. Score [B, T], Label (relevance) [B, T], Lengths [B]."""
    s = _x(ins).float()
    rel = ins["Label"][0].float()
    lens = ins["Lengths"][0].to(s.device)
    B, T = s.shape
    pos = torch.arange(T, device=s.device)
    valid = pos[None, :] < lens[:, None]                       # [B, T]
    s_m = torch.where(valid, s, torch.full((), -1e30, device=s.device))
    # rank of each item under the current scores (0-based, stable)
    order = torch.argsort(-s_m, dim=-1, stable=True)
    ranks = torch.zeros((B, T), device=s.device).scatter(
        1, order, pos.float().expand(B, T).contiguous())
    gain = (torch.exp2(rel) - 1.0) * valid
    disc = 1.0 / torch.log2(ranks + 2.0)
    rel_sorted = -torch.sort(-torch.where(valid, rel, 0.0), dim=-1).values
    ideal = torch.sum((torch.exp2(rel_sorted) - 1.0)
                      / torch.log2(pos.float() + 2.0), dim=-1, keepdim=True)
    ideal = torch.where(ideal <= 0, 1.0, ideal)
    dg = gain[:, :, None] - gain[:, None, :]                   # [B, T, T]
    dd = disc[:, :, None] - disc[:, None, :]
    dndcg = torch.abs(dg * dd) / ideal[:, :, None]
    higher = (rel[:, :, None] > rel[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    sdiff = s[:, :, None] - s[:, None, :]
    pair_loss = torch.log1p(torch.exp(-torch.clamp(sdiff, -30, 30)))
    per_row = torch.sum(torch.where(higher, dndcg * pair_loss, 0.0),
                        dim=(1, 2))
    return {"Out": [per_row]}


@OpRegistry.register("binary_f1")
def _binary_f1(ins, attrs):
    """Per-batch F1 for one positive class."""
    from ..ops.metrics import precision_recall_counts
    logits, label = ins["X"][0], ins["Label"][0]
    pos = attrs.get("positive_label", 1)
    pred = torch.argmax(logits, -1).to(torch.int32)
    counts = precision_recall_counts(pred, label.to(torch.int32),
                                     int(logits.shape[-1]))
    tp, fp, fn = counts[pos, 0], counts[pos, 1], counts[pos, 2]
    prec = tp / torch.clamp(tp + fp, min=1)
    rec = tp / torch.clamp(tp + fn, min=1)
    return {"Out": [2 * prec * rec / torch.clamp(prec + rec, min=1e-12)]}


# -------------------------------------------------- gen-1 tail (round 3) ----

@OpRegistry.register("lstm_step")
def _lstm_step(ins, attrs):
    """Pre-projected-gates LSTM step with peephole connections."""
    from ..ops.rnn import lstm_peephole_step
    h, c = lstm_peephole_step(_x(ins), ins["CPrev"][0], ins["WPeep"][0],
                              ins["B"][0] if "B" in ins else None,
                              forget_bias=attrs.get("forget_bias", 0.0))
    return {"H": [h], "C": [c]}


@OpRegistry.register("kmax_seq_score")
def _kmax_seq_score(ins, attrs):
    from ..ops.sequence import kmax_seq_score
    return {"Out": [kmax_seq_score(_x(ins), ins["Lengths"][0],
                                   attrs["beam_size"])]}


@OpRegistry.register("sub_nested_seq")
def _sub_nested_seq(ins, attrs):
    from ..ops.sequence import sub_nested_seq
    out, sub = sub_nested_seq(_x(ins), ins["SubLengths"][0],
                              ins["Indices"][0])
    return {"Out": [out], "SubLengthsOut": [sub]}


@OpRegistry.register("equal_scalar")
def _equal_scalar(ins, attrs):
    """Elementwise id == constant (distinct from the two-input "equal")."""
    return {"Out": [(_x(ins) == attrs["value"]).to(torch.int32)]}


@OpRegistry.register("dyn_conv2d")
def _dyn_conv2d(ins, attrs):
    """Per-sample dynamic-filter conv (the filter is an input). NHWC."""
    from ..ops.conv import conv2d
    x = _x(ins)                                        # [B, H, W, C]
    k = attrs["filter_size"]
    c, nf = attrs["channels"], attrs["num_filters"]
    # the reference's (F, C, k, k) per-sample packing, as HWIO
    filt = ins["Filter"][0].reshape((-1, nf, c, k, k)).permute(
        0, 3, 4, 2, 1)                                 # [B, k, k, C, F]
    outs = [conv2d(x[i:i + 1], filt[i], stride=attrs.get("stride", 1),
                   padding=attrs.get("padding", 0))[0]
            for i in range(x.shape[0])]
    return {"Out": [torch.stack(outs)]}


@OpRegistry.register("scale_sub_region")
def _scale_sub_region(ins, attrs):
    """Multiply a per-sample (C, H, W) box by a constant. X [B, H, W, C];
    Indices [B, 6] 1-based inclusive (C_s, C_e, H_s, H_e, W_s, W_e)."""
    x = _x(ins)
    idx = ins["Indices"][0].to(device=x.device, dtype=torch.int32)
    B, H, W, C = x.shape
    hh = torch.arange(H, device=x.device)[None, :, None, None]
    ww = torch.arange(W, device=x.device)[None, None, :, None]
    cc = torch.arange(C, device=x.device)[None, None, None, :]

    def e(i):
        return idx[:, i][:, None, None, None]
    inside = ((cc >= e(0) - 1) & (cc <= e(1) - 1) &
              (hh >= e(2) - 1) & (hh <= e(3) - 1) &
              (ww >= e(4) - 1) & (ww <= e(5) - 1))
    return {"Out": [torch.where(inside, x * attrs["value"], x)]}


@OpRegistry.register("cross_entropy_over_beam")
def _ce_over_beam(ins, attrs):
    """Beam-training CE: softmax over each sample's beam scores, the gold
    joining as slot K only for samples whose gold fell out of the beam
    (gold_idx == K); a gold index outside the logits gives +inf."""
    scores = _x(ins)                                    # [B, K]
    gold_idx = ins["GoldIdx"][0].to(torch.long)         # [B]
    K = scores.shape[-1]
    if "GoldScore" in ins:
        gs = ins["GoldScore"][0].reshape(-1, 1)         # [B, 1]
        in_beam = (gold_idx < K).reshape(-1, 1)
        slot_k = torch.where(in_beam, -1e9, gs)
        logits = torch.cat([scores, slot_k], dim=-1)
    else:
        logits = scores
    logp = torch.log_softmax(logits, dim=-1)
    safe_idx = torch.clamp(gold_idx, 0, logits.shape[-1] - 1)
    picked = torch.gather(logp, -1, safe_idx[:, None])[:, 0]
    picked = torch.where((gold_idx > safe_idx) | (gold_idx < 0),
                         -torch.inf, picked)
    return {"Out": [-picked]}
