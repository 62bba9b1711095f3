from . import event
from .trainer import Trainer

__all__ = ["Trainer", "event"]
