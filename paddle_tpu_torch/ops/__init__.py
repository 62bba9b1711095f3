from . import (activations, beam_search, conv, crf, ctc, cuda_kernels,
               detection, loss, math, metrics, nce, norm, pool, random, rnn,
               rnn_kernels, sequence, sparse)

__all__ = ["activations", "beam_search", "conv", "crf", "ctc",
           "cuda_kernels", "detection", "loss", "math", "metrics", "nce",
           "norm", "pool", "random", "rnn", "rnn_kernels", "sequence",
           "sparse"]
