"""Learning-rate schedules — the counterpart of
``paddle_tpu/optimizer/lr_scheduler.py`` (the reference's
LearningRateScheduler.cpp types and fluid's learning_rate_decay).

Each schedule maps the optimizer's f32 step *tensor* to a 0-d f32 tensor
by torch ops, so that inside the trainer's CUDA graph the rate follows
the step the graph reads, as JAX's schedules follow the traced step: a
schedule that turned the step into a Python number would freeze the rate
at its value at capture.
"""

from __future__ import annotations

import torch


def constant_lr(lr: float):
    def sched(step):
        return torch.full((), float(lr), dtype=torch.float32,
                          device=step.device)
    return sched


def _decay_power(step, decay_steps, staircase):
    p = step / decay_steps
    return torch.floor(p) if staircase else p


def exponential_decay(lr: float, decay_steps: int, decay_rate: float,
                      staircase: bool = False):
    def sched(step):
        return lr * torch.pow(decay_rate,
                              _decay_power(step, decay_steps, staircase))
    return sched


def natural_exp_decay(lr: float, decay_steps: int, decay_rate: float,
                      staircase: bool = False):
    def sched(step):
        return lr * torch.exp(-decay_rate * _decay_power(
            step, decay_steps, staircase))
    return sched


def inverse_time_decay(lr: float, decay_steps: int, decay_rate: float,
                       staircase: bool = False):
    def sched(step):
        return lr / (1.0 + decay_rate * _decay_power(step, decay_steps,
                                                     staircase))
    return sched


def poly_decay(lr: float, decay_steps: int, end_lr: float = 1e-4,
               power: float = 1.0, cycle: bool = False):
    def sched(step):
        step = step.to(torch.float32)
        if cycle:
            decay = decay_steps * torch.clamp(
                torch.ceil(step / decay_steps), min=1.0)
        else:
            decay = torch.full_like(step, float(decay_steps))
        s = torch.minimum(step, decay)
        return (lr - end_lr) * torch.pow(1.0 - s / decay, power) + end_lr
    return sched


def piecewise_decay(boundaries, values):
    def sched(step):
        lr = torch.full((), float(values[0]), dtype=torch.float32,
                        device=step.device)
        for b, v in zip(boundaries, values[1:]):
            lr = torch.where(step >= b, torch.full_like(lr, float(v)), lr)
        return lr
    return sched


def discexp_lr(lr: float, decay_rate: float, decay_steps: int):
    """gen-1 'discexp': lr * decay_rate^floor(step/decay_steps)."""
    return exponential_decay(lr, decay_steps, decay_rate, staircase=True)


def linear_warmup(base_sched, warmup_steps: int, start_frac: float = 0.0):
    def sched(step):
        warm = start_frac + (1.0 - start_frac) * (step / max(warmup_steps, 1))
        return (torch.where(step < warmup_steps, warm,
                            torch.ones_like(warm)) * base_sched(step))
    return sched
