"""Image classification models — the counterpart of
``paddle_tpu/models/image.py``: ``ResNet`` (18/34/50/101/152, with
``resnet50``), ``LeNet``, ``SmallNet``, ``VGG``, ``AlexNet`` and
``GoogleNet``.

NHWC activations and HWIO conv weights, as in JAX. Children and
parameters carry the JAX attribute names (``stem``, ``layer{li}_{bi}``
with ``a``/``b``/``c``/``proj`` inside, ``head``; ``b{i}_{j}``; ``i3a``,
``aux1``, …), each conv-BN pair ``conv/w`` and ``bn/{gamma,beta,stats}``,
so a JAX tree loads unchanged (``convert.params_from_numpy``).

``model(x, train=..., mutable=...)`` gives logits (GoogleNet in training
mode: (main, aux1, aux2)); ``model.loss(x, labels, ...)`` the mean
softmax cross-entropy. In training mode the batch norms record their new
running stats in ``mutable`` (``nn.Module.record_stats``); AlexNet and
GoogleNet drop out with the ``generator`` they are given (none: no
dropout, JAX's ``rng=None``). ``model.call(params, x, labels,
method="loss", ...)`` runs with the leaves of a tree, for ``Trainer``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..nn import BatchNorm, Conv2D, Linear, Module
from ..ops import conv as conv_ops
from ..ops import pool as P
from ..ops.loss import softmax_with_cross_entropy
from ..ops.norm import lrn
from ..ops.random import dropout


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(softmax_with_cross_entropy(logits, labels))


class LeNet(Module):
    """conv-pool x2 + fc (light_mnist). Input [B, 28, 28, 1]."""

    def __init__(self, classes: int = 10):
        super().__init__()
        self.c1 = Conv2D(1, 20, 5, act="relu")
        self.c2 = Conv2D(20, 50, 5, act="relu")
        self.fc1 = Linear(4 * 4 * 50, 500, act="relu")
        self.fc2 = Linear(500, classes)

    def forward(self, x, **kw):
        h = P.max_pool2d(self.c1(x), 2, 2)
        h = P.max_pool2d(self.c2(h), 2, 2)
        return self.fc2(self.fc1(h.reshape(h.shape[0], -1)))

    def loss(self, x, labels, **kw):
        return _xent(self(x), labels)


class SmallNet(Module):
    """cifar-quick: 3 x (conv-pool) + fc. Input [B, 32, 32, 3]."""

    def __init__(self, classes: int = 10):
        super().__init__()
        self.c1 = Conv2D(3, 32, 5, padding=2, act="relu")
        self.c2 = Conv2D(32, 32, 5, padding=2, act="relu")
        self.c3 = Conv2D(32, 64, 5, padding=2, act="relu")
        self.fc1 = Linear(4 * 4 * 64, 64, act="relu")
        self.fc2 = Linear(64, classes)

    def forward(self, x, **kw):
        h = P.max_pool2d(self.c1(x), 2, 2)
        h = P.max_pool2d(self.c2(h), 2, 2)
        h = P.max_pool2d(self.c3(h), 2, 2)
        return self.fc2(self.fc1(h.reshape(h.shape[0], -1)))

    def loss(self, x, labels, **kw):
        return _xent(self(x), labels)


class _ConvBN(Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, act=None):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=padding,
                           bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x, train=False, mutable=None, **kw):
        h = self.bn(self.conv(x), train=train, mutable=mutable)
        return self.act(h) if self.act else h


class VGG(Module):
    """VGG-16: conv-BN blocks [2, 2, 3, 3, 3] with a pool after each, a
    global average pool, 2 x 512 fc."""

    def __init__(self, classes: int = 10, in_ch: int = 3,
                 width_mult: float = 1.0):
        super().__init__()
        cfg = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
        c = in_ch
        for i, (n, ch) in enumerate(cfg):
            ch = max(8, int(ch * width_mult))
            for j in range(n):
                setattr(self, f"b{i}_{j}", _ConvBN(c, ch, 3, padding=1,
                                                   act=torch.relu))
                c = ch
        self.cfg = [n for n, _ in cfg]
        self.fc1 = Linear(c, 512, act="relu")
        self.fc2 = Linear(512, 512, act="relu")
        self.out = Linear(512, classes)

    def forward(self, x, train=False, mutable=None, **kw):
        h = x
        for i, n in enumerate(self.cfg):
            for j in range(n):
                h = getattr(self, f"b{i}_{j}")(h, train=train,
                                               mutable=mutable)
            h = P.max_pool2d(h, 2, 2)
        h = P.global_avg_pool2d(h)
        return self.out(self.fc2(self.fc1(h)))

    def loss(self, x, labels, train=False, mutable=None):
        return _xent(self(x, train=train, mutable=mutable), labels)


class _Bottleneck(Module):
    """1x1 -> 3x3 (the stride) -> 1x1 (x4), with a projection shortcut
    where the shape changes."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * 4
        self.a = _ConvBN(cin, planes, 1, act=torch.relu)
        self.b = _ConvBN(planes, planes, 3, stride=stride, padding=1,
                         act=torch.relu)
        self.c = _ConvBN(planes, cout, 1)
        self.proj = (None if (cin == cout and stride == 1)
                     else _ConvBN(cin, cout, 1, stride=stride))

    def forward(self, x, train=False, mutable=None, **kw):
        h = self.a(x, train=train, mutable=mutable)
        h = self.b(h, train=train, mutable=mutable)
        h = self.c(h, train=train, mutable=mutable)
        s = (x if self.proj is None
             else self.proj(x, train=train, mutable=mutable))
        return torch.relu(h + s)


class _BasicBlock(Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.a = _ConvBN(cin, planes, 3, stride=stride, padding=1,
                         act=torch.relu)
        self.b = _ConvBN(planes, planes, 3, padding=1)
        self.proj = (None if (cin == planes and stride == 1)
                     else _ConvBN(cin, planes, 1, stride=stride))

    def forward(self, x, train=False, mutable=None, **kw):
        h = self.a(x, train=train, mutable=mutable)
        h = self.b(h, train=train, mutable=mutable)
        s = (x if self.proj is None
             else self.proj(x, train=train, mutable=mutable))
        return torch.relu(h + s)


_RESNET_CFG = {
    18: (_BasicBlock, [2, 2, 2, 2], 1),
    34: (_BasicBlock, [3, 4, 6, 3], 1),
    50: (_Bottleneck, [3, 4, 6, 3], 4),
    101: (_Bottleneck, [3, 4, 23, 3], 4),
    152: (_Bottleneck, [3, 8, 36, 3], 4),
}


class ResNet(Module):
    """ResNet-N for ImageNet-shaped input. ``width_mult`` scales the
    channels (at least 8); ``small_input`` swaps the 7x7/s2 stem and its
    3/2/1 max pool for a 3x3/s1 stem (cifar-style)."""

    def __init__(self, depth: int = 50, classes: int = 1000, in_ch: int = 3,
                 width_mult: float = 1.0, small_input: bool = False):
        super().__init__()
        block, counts, expansion = _RESNET_CFG[depth]
        w = lambda ch: max(8, int(ch * width_mult))
        self.small_input = small_input
        if small_input:
            self.stem = _ConvBN(in_ch, w(64), 3, stride=1, padding=1,
                                act=torch.relu)
        else:
            self.stem = _ConvBN(in_ch, w(64), 7, stride=2, padding=3,
                                act=torch.relu)
        c = w(64)
        self.layer_names: List[str] = []
        for li, (planes, n) in enumerate(zip([64, 128, 256, 512], counts)):
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 0) else 1
                name = f"layer{li}_{bi}"
                setattr(self, name, block(c, w(planes), stride))
                self.layer_names.append(name)
                c = w(planes) * expansion
        self.head = Linear(c, classes)

    def forward(self, x, train=False, mutable=None, **kw):
        h = self.stem(x, train=train, mutable=mutable)
        if not self.small_input:
            h = P.max_pool2d(h, 3, 2, padding=1)
        for name in self.layer_names:
            h = getattr(self, name)(h, train=train, mutable=mutable)
        return self.head(P.global_avg_pool2d(h))

    def loss(self, x, labels, train=False, mutable=None):
        return _xent(self(x, train=train, mutable=mutable), labels)


def resnet50(classes: int = 1000, **kw) -> ResNet:
    return ResNet(50, classes, **kw)


class AlexNet(Module):
    """5 convs with LRN after the first two, 3 pools, two dropout-4096
    fcs. Input [B, 224, 224, 3]."""

    def __init__(self, classes: int = 1000, in_ch: int = 3):
        super().__init__()
        self.c1 = Conv2D(in_ch, 96, 11, stride=4, padding=2, act="relu")
        self.c2 = Conv2D(96, 256, 5, padding=2, act="relu")
        self.c3 = Conv2D(256, 384, 3, padding=1, act="relu")
        self.c4 = Conv2D(384, 384, 3, padding=1, act="relu")
        self.c5 = Conv2D(384, 256, 3, padding=1, act="relu")
        self.fc1 = Linear(6 * 6 * 256, 4096, act="relu")
        self.fc2 = Linear(4096, 4096, act="relu")
        self.out = Linear(4096, classes)

    def forward(self, x, train=False,
                generator: Optional[torch.Generator] = None, **kw):
        live = train and generator is not None
        h = P.max_pool2d(lrn(self.c1(x)), 3, 2)
        h = P.max_pool2d(lrn(self.c2(h)), 3, 2)
        h = P.max_pool2d(self.c5(self.c4(self.c3(h))), 3, 2)
        h = self.fc1(h.reshape(h.shape[0], -1))
        if live:
            h = dropout(h, 0.5, generator)
        h = self.fc2(h)
        if live:
            h = dropout(h, 0.5, generator)
        return self.out(h)

    def loss(self, x, labels, train=False, generator=None):
        return _xent(self(x, train=train, generator=generator), labels)


class _Inception(Module):
    """One inception-v1 block: 1x1 / 1x1-3x3 / 1x1-5x5 / pool-1x1
    branches, concatenated over channels. The three 1x1 convs that read x
    run as one conv over their concatenated weights (one pass over x),
    as in JAX."""

    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = Conv2D(cin, c1, 1, act="relu")
        self.b3r = Conv2D(cin, c3r, 1, act="relu")
        self.b3 = Conv2D(c3r, c3, 3, padding=1, act="relu")
        self.b5r = Conv2D(cin, c5r, 1, act="relu")
        self.b5 = Conv2D(c5r, c5, 5, padding=2, act="relu")
        self.bp = Conv2D(cin, proj, 1, act="relu")
        self.cout = c1 + c3 + c5 + proj

    def forward(self, x, **kw):
        w = torch.cat([self.b1.w, self.b3r.w, self.b5r.w], dim=-1)
        bias = torch.cat([self.b1.b, self.b3r.b, self.b5r.b])
        fused = torch.relu(conv_ops.conv2d(x, w) + bias)
        c1, c3r = self.b1.w.shape[-1], self.b3r.w.shape[-1]
        a = fused[..., :c1]
        b = self.b3(fused[..., c1:c1 + c3r])
        c = self.b5(fused[..., c1 + c3r:])
        d = self.bp(P.max_pool2d(x, 3, 1, padding=1))
        return torch.cat([a, b, c, d], dim=-1)


class _AuxHead(Module):
    """An auxiliary classifier: 5/3 avg pool, 1x1 conv, fc with dropout
    0.7."""

    def __init__(self, cin, classes):
        super().__init__()
        self.conv = Conv2D(cin, 128, 1, act="relu")
        self.fc = Linear(4 * 4 * 128, 1024, act="relu")
        self.out = Linear(1024, classes)

    def forward(self, x, train=False, generator=None, **kw):
        h = self.conv(P.avg_pool2d(x, 5, 3))
        h = self.fc(h.reshape(h.shape[0], -1))
        if train and generator is not None:
            h = dropout(h, 0.7, generator)
        return self.out(h)


class GoogleNet(Module):
    """GoogLeNet / inception v1 with its two auxiliary towers. Input [B,
    224, 224, 3]; training mode returns (main, aux1, aux2) logits, which
    :meth:`loss` weighs 1, 0.3, 0.3."""

    def __init__(self, classes: int = 1000, in_ch: int = 3):
        super().__init__()
        self.stem1 = Conv2D(in_ch, 64, 7, stride=2, padding=3, act="relu")
        self.stem2 = Conv2D(64, 64, 1, act="relu")
        self.stem3 = Conv2D(64, 192, 3, padding=1, act="relu")
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.aux1 = _AuxHead(512, classes)
        self.aux2 = _AuxHead(528, classes)
        self.head = Linear(1024, classes)

    def forward(self, x, train=False,
                generator: Optional[torch.Generator] = None, **kw):
        h = lrn(P.max_pool2d(self.stem1(x), 3, 2, padding=1))
        h = self.stem3(self.stem2(h))
        h = P.max_pool2d(lrn(h), 3, 2, padding=1)
        h = self.i3b(self.i3a(h))
        h = self.i4a(P.max_pool2d(h, 3, 2, padding=1))
        a1 = self.aux1(h, train=train, generator=generator) if train else None
        h = self.i4d(self.i4c(self.i4b(h)))
        a2 = self.aux2(h, train=train, generator=generator) if train else None
        h = P.max_pool2d(self.i4e(h), 3, 2, padding=1)
        h = P.global_avg_pool2d(self.i5b(self.i5a(h)))
        if train and generator is not None:
            h = dropout(h, 0.4, generator)
        main = self.head(h)
        return (main, a1, a2) if train else main

    def loss(self, x, labels, train=False, generator=None):
        out = self(x, train=train, generator=generator)
        if not train:
            return _xent(out, labels)
        main, a1, a2 = out
        return (_xent(main, labels) + 0.3 * _xent(a1, labels)
                + 0.3 * _xent(a2, labels))
