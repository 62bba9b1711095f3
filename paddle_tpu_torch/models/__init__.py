from .image import (VGG, AlexNet, GoogleNet, LeNet, ResNet, SmallNet,
                    resnet50)
from .mlp import MnistMLP
from .seq2seq import AttentionSeq2Seq, DecoderState
from .text_cls import BiLSTMTextCls, LSTMTextCls
from .transformer import TransformerBlock, TransformerLM
from .transformer_nmt import CrossAttentionBlock, TransformerSeq2Seq

__all__ = ["AlexNet", "AttentionSeq2Seq", "BiLSTMTextCls",
           "CrossAttentionBlock", "DecoderState", "GoogleNet", "LSTMTextCls",
           "LeNet", "MnistMLP", "ResNet", "SmallNet", "TransformerBlock",
           "TransformerLM", "TransformerSeq2Seq", "VGG", "resnet50"]
