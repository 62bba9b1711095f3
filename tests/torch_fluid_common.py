"""Helpers of the fluid parity tests (tests/test_torch_fluid*.py): one
program built with each package's fluid API, run by both executors from
the same weights."""

import numpy as np
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.convert import scope_from_numpy


def host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class Pair:
    """``build(fluid)`` run once against each package's default programs;
    ``jout``/``tout`` are what it returned. The JAX startup program runs
    (unless ``startup=False``) and its scope becomes the port's through
    ``convert.scope_from_numpy``."""

    def __init__(self, build, startup: bool = True, jax_kw=None,
                 torch_kw=None):
        jfluid.reset_default_programs()
        self.jout = build(jfluid)
        self.jmain = jfluid.default_main_program()
        self.jstart = jfluid.default_startup_program()
        tfluid.reset_default_programs()
        self.tout = build(tfluid)
        self.tmain = tfluid.default_main_program()
        self.tstart = tfluid.default_startup_program()
        self.jexe = jfluid.Executor(scope=jfluid.Scope(), **(jax_kw or {}))
        if startup:
            self.jexe.run(self.jstart)
        self.texe = tfluid.Executor(
            scope=scope_from_numpy(self.jax_vars(), "cpu"), device="cpu",
            **(torch_kw or {}))

    def jax_vars(self):
        return {n: np.asarray(v) for n, v in self.jexe.scope.vars.items()}

    def run(self, feed, fetch, jprog=None, tprog=None, **kw):
        """(JAX's fetches, the port's fetches) as numpy, one run each."""
        names = [f if isinstance(f, str) else f.name for f in fetch]
        j = self.jexe.run(jprog or self.jmain, feed=feed, fetch_list=names,
                          **kw)
        t = self.texe.run(tprog or self.tmain, feed=feed, fetch_list=names,
                          **kw)
        return [np.asarray(v) for v in j], [host(v) for v in t]

    def steps(self, n, feed, fetch, atol=1e-5, rtol=1e-5, **kw):
        """``n`` runs of both, every fetch equal; returns the port's."""
        out = []
        for _ in range(n):
            j, t = self.run(feed, fetch, **kw)
            for a, b in zip(j, t):
                np.testing.assert_allclose(b, a, atol=atol, rtol=rtol)
            out.append(t)
        return out

    def assert_scopes_close(self, atol=1e-5, rtol=1e-5):
        """Every variable of JAX's scope equals the port's."""
        for name, want in self.jax_vars().items():
            np.testing.assert_allclose(host(self.texe.scope.get(name)), want,
                                       atol=atol, rtol=rtol, err_msg=name)


def assert_adaptive_close(pair, grads, lr, steps, atol=1e-5, rtol=1e-5,
                          floor=1e-4, rel_floor=1e-2):
    """Every parameter of ``grads`` (name -> JAX's first-step gradient)
    equal to JAX's after ``steps`` updates of an adaptive optimizer (Adam,
    Adagrad and kin): to ``atol`` + ``rtol`` of the entry, and where the
    entry's gradient is below ``floor`` (100 times the optimizers' eps of
    1e-6) or ``rel_floor`` of its tensor's largest, up to 5 * ``lr`` more
    a step. Such an entry's accumulator stays small, so each update
    divides its gradient by about its own size (g / (c |g| + eps)): the
    update is up to lr / c (c = sqrt(1 - decay) >= 0.22 for the decays
    used here) and carries the gradient's relative rounding error, which
    the entry's smallness makes large, however right both sides are."""
    for name, g in grads.items():
        g = np.abs(np.asarray(g))
        want = np.asarray(pair.jexe.scope.get(name))
        got = host(pair.texe.scope.get(name))
        noisy = g < max(floor, rel_floor * g.max())
        allow = atol + rtol * np.abs(want) + np.where(noisy, 5 * lr * steps,
                                                      0.0)
        bad = np.abs(got - want) > allow
        assert not bad.any(), (name, np.abs(got - want)[bad].max())
