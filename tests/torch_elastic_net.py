"""Shared workloads of the port's elastic tests — the torch copy of
``tests/elastic_testnet.py``, plus the LSTM flagship's.

torch only: no jax, nothing of ``paddle_tpu`` (the subprocess worker,
``tests/torch_elastic_worker.py``, and ``chip_smoke.py`` import it). One
definition of (loss, optimizer, data) serves the master, the thread
workers, the subprocess workers and the sequential references, so every
participant computes the same per-shard math.
"""

import numpy as np


def build(steps: int = 5, batch: int = 32, seed: int = 0):
    """-> (loss_fn, make_optimizer, batches): JAX's testnet (8 -> 16 relu
    -> 2, mean cross entropy, Adam(0.01)) and its batches, the same numpy
    draws. The weights come from the caller (the tests carry JAX's
    ``params0`` across)."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Adam

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16, act="relu")
            self.fc2 = nn.Linear(16, 2)

        def forward(self, x, **kw):
            return self.fc2(self.fc1(x))

    model = Net()

    def loss_fn(params, x, y):
        logits = model.call(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(logp, y.long()[:, None], 1).mean()

    rs = np.random.RandomState(seed)
    batches = [(rs.randn(batch, 8).astype(np.float32),
                rs.randint(0, 2, batch).astype(np.int32))
               for _ in range(steps)]
    return loss_fn, (lambda: Adam(0.01)), batches


#: the LSTM flagship (benchmarks/lstm_textcls.py): vocab 30000, embed 128,
#: H 256, two classes, batches of 64 x 100 with lengths 30..100
FLAGSHIP = dict(vocab=30000, embed=128, hidden=256, classes=2, batch=64,
                seq_len=100, min_len=30, lr=2e-3)


def flagship(steps: int = 4, seed: int = 0, **over):
    """-> (loss_fn, make_params(device), make_optimizer, batches): the
    LSTM text classifier's f32 loss (``LSTMTextCls``, last-step pooling,
    the fused kernels #9/#10 on the card), its seeded weights and Adam,
    and ``steps`` seeded global batches (data, lengths, labels)."""
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.optimizer import Adam
    cfg = dict(FLAGSHIP, **over)
    model = LSTMTextCls(cfg["vocab"], cfg["embed"], cfg["hidden"],
                        cfg["classes"], pool="last")

    def loss_fn(params, data, lengths, labels):
        return model.call(params, SeqBatch(data, lengths), labels)

    def make_params(device):
        from paddle_tpu_torch.core.pytree import tree_map
        return tree_map(lambda v: v.detach().clone(),
                        model.init(seed, device).tree())

    rs = np.random.RandomState(seed + 1)
    B, T = cfg["batch"], cfg["seq_len"]
    batches = []
    for _ in range(steps):
        data = rs.randint(0, cfg["vocab"], (B, T)).astype(np.int32)
        lengths = rs.randint(cfg["min_len"], T + 1, B).astype(np.int32)
        labels = (data[np.arange(B), lengths - 1] % 2).astype(np.int32)
        batches.append((data, lengths, labels))
    return loss_fn, make_params, (lambda: Adam(cfg["lr"])), batches


WORKLOADS = {"testnet": lambda: build()[0],
             "flagship": lambda: flagship()[0]}


def shard_bounds(n_rows: int, shards: int):
    """The master's fixed shard partition (``ElasticMaster._shard_bounds``)."""
    S = min(shards, n_rows) or 1
    base, rem = divmod(n_rows, S)
    bounds, lo = [], 0
    for j in range(S):
        hi = lo + base + (1 if j < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def sequential_reference(loss_fn, params, make_optimizer, batches, *,
                         shards: int = 4, device="cpu", on_step=None):
    """The elastic fit done in one process: per step, each fixed shard's
    loss and gradients (``elastic.loss_and_grads``) through one graph (as
    a worker runs them), the shard-ordered host reduce
    (``elastic.reduce_shards``), then the optimizer's ``apply_`` through
    one graph (as the master runs it). ``on_step(step, params, loss)``
    after each update. Returns (params, loss)."""
    import torch

    from paddle_tpu_torch.core.graphs import GraphCache
    from paddle_tpu_torch.trainer.elastic import (_host_f32, _on_device,
                                                  loss_and_grads,
                                                  reduce_shards)
    device = torch.device(device)
    opt = make_optimizer()
    grads_g = GraphCache("tests.elastic_reference.grad", device)
    upd_g = GraphCache("tests.elastic_reference.update", device)
    params = _on_device(params, device)
    state = _on_device(opt.init(params), device)

    def grad_body(params, batch):
        return loss_and_grads(loss_fn, params, *batch)

    def update_body(grads, opt_state, params):
        opt.apply_(grads, opt_state, params)
        return params, opt_state

    loss = float("nan")
    for step, batch in enumerate(batches):
        n = batch[0].shape[0]
        bounds = shard_bounds(n, shards)
        outs = []
        for lo, hi in bounds:
            lv, g = grads_g.run("grad", grad_body, {
                "params": params,
                "batch": tuple(torch.from_numpy(np.ascontiguousarray(
                    a[lo:hi])) for a in batch)})
            outs.append((float(lv), _host_f32(g)))
        rows = [hi - lo for lo, hi in bounds]
        acc = _on_device(reduce_shards([g for _, g in outs], rows, n),
                         device)
        params, state = upd_g.run(
            "update", update_body,
            {"grads": acc, "opt_state": state, "params": params},
            donate=("opt_state", "params"))
        loss = float(sum(r / n * lv for r, (lv, _) in zip(rows, outs)))
        if on_step is not None:
            on_step(step, params, loss)
    return params, loss
