from . import (activations, conv, cuda_kernels, loss, metrics, norm, pool,
               random, rnn, rnn_kernels, sequence)

__all__ = ["activations", "conv", "cuda_kernels", "loss", "metrics", "norm",
           "pool", "random", "rnn", "rnn_kernels", "sequence"]
