from . import (activations, conv, crf, ctc, cuda_kernels, detection, loss,
               math, metrics, nce, norm, pool, random, rnn, rnn_kernels,
               sequence)

__all__ = ["activations", "conv", "crf", "ctc", "cuda_kernels", "detection",
           "loss", "math", "metrics", "nce", "norm", "pool", "random", "rnn",
           "rnn_kernels", "sequence"]
