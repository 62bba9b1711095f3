from .text_cls import BiLSTMTextCls, LSTMTextCls
from .transformer import TransformerBlock, TransformerLM
from .transformer_nmt import CrossAttentionBlock, TransformerSeq2Seq

__all__ = ["BiLSTMTextCls", "CrossAttentionBlock", "LSTMTextCls",
           "TransformerBlock", "TransformerLM", "TransformerSeq2Seq"]
