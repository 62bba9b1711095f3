"""Prebuilt net compositions (python/paddle/v2/fluid/nets.py analog:
simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu-style gates)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from . import layers
from .framework import Variable


def simple_img_conv_pool(input: Variable, num_filters: int, filter_size: int,
                         pool_size: int, pool_stride: int,
                         act: Optional[str] = None,
                         pool_type: str = "max") -> Variable:
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, act=act)
    return layers.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def img_conv_group(input: Variable, conv_num_filter: Sequence[int],
                   pool_size: int, conv_padding: Union[int, Sequence[int]] = 1,
                   conv_filter_size: Union[int, Sequence[int]] = 3,
                   conv_act: Optional[str] = None,
                   conv_with_batchnorm: Union[bool, Sequence[bool]] = False,
                   pool_stride: int = 1,
                   pool_type: str = "max") -> Variable:
    """VGG-style conv stack + one pool (nets.py img_conv_group)."""
    def extend(v):
        return list(v) if hasattr(v, "__len__") else [v] * len(conv_num_filter)

    paddings = extend(conv_padding)
    sizes = extend(conv_filter_size)
    with_bn = extend(conv_with_batchnorm)
    tmp = input
    for nf, pad, fs, bn in zip(conv_num_filter, paddings, sizes, with_bn):
        tmp = layers.conv2d(tmp, num_filters=nf, filter_size=fs, padding=pad,
                            act=None if bn else conv_act)
        if bn:
            tmp = layers.batch_norm(tmp, act=conv_act)
    return layers.pool2d(tmp, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type=pool_type)


def sequence_conv_pool(input: Variable, lengths: Variable, num_filters: int,
                       filter_size: int, act: str = "tanh",
                       pool_type: str = "max") -> Variable:
    conv = layers.sequence_conv(input, lengths, num_filters=num_filters,
                                filter_size=filter_size, act=act)
    return layers.sequence_pool(conv, lengths, pool_type=pool_type)
