from .seq2seq import AttentionSeq2Seq, DecoderState
from .text_cls import BiLSTMTextCls, LSTMTextCls
from .transformer import TransformerBlock, TransformerLM
from .transformer_nmt import CrossAttentionBlock, TransformerSeq2Seq

__all__ = ["AttentionSeq2Seq", "BiLSTMTextCls", "CrossAttentionBlock",
           "DecoderState", "LSTMTextCls", "TransformerBlock",
           "TransformerLM", "TransformerSeq2Seq"]
