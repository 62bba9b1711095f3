from .optimizers import SGD, Adam, Optimizer

__all__ = ["Adam", "Optimizer", "SGD"]
