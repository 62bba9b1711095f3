from .embeddings import DeepFM, Recommender, Word2Vec
from .generative import GAN, VAE
from .image import (VGG, AlexNet, GoogleNet, LeNet, ResNet, SmallNet,
                    resnet50)
from .mlp import MnistMLP
from .seq2seq import AttentionSeq2Seq, DecoderState
from .tagger import BiLSTMCRFTagger, LinearCRFTagger
from .text_cls import BiLSTMTextCls, ConvTextCls, LSTMTextCls
from .transformer import TransformerBlock, TransformerLM
from .transformer_nmt import CrossAttentionBlock, TransformerSeq2Seq

__all__ = ["AlexNet", "AttentionSeq2Seq", "BiLSTMCRFTagger",
           "BiLSTMTextCls", "ConvTextCls", "CrossAttentionBlock", "DeepFM",
           "DecoderState", "GAN", "GoogleNet", "LSTMTextCls", "LeNet",
           "LinearCRFTagger", "MnistMLP", "Recommender", "ResNet",
           "SmallNet", "TransformerBlock", "TransformerLM",
           "TransformerSeq2Seq", "VAE", "VGG", "Word2Vec", "resnet50"]
