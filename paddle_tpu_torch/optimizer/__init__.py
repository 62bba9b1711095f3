from .optimizers import SGD, Adam, Momentum, Optimizer

__all__ = ["Adam", "Momentum", "Optimizer", "SGD"]
