from . import (activations, cuda_kernels, loss, norm, rnn, rnn_kernels,
               sequence)

__all__ = ["activations", "cuda_kernels", "loss", "norm", "rnn",
           "rnn_kernels", "sequence"]
