from .text_cls import BiLSTMTextCls, LSTMTextCls
from .transformer import TransformerBlock, TransformerLM

__all__ = ["BiLSTMTextCls", "LSTMTextCls", "TransformerBlock",
           "TransformerLM"]
