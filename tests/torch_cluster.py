"""What the port's cluster_train worker scripts share
(tests/torch_cluster_{train,restart,death}_script.py): the toy model of
JAX's scripts (4 -> 2, mean cross entropy, SGD 0.1) behind a
``DataParallel`` over the world's mesh, and the world's clean exit.
torch only: no jax, nothing of ``paddle_tpu``."""

import torch

torch.set_num_threads(1)


def dp_step_fn(mesh, params=None):
    """(DataParallel, placed params, placed optimizer state): ``params``
    a host tree ({"fc": {"w", "b"}}), default the seed-0 draws."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.optimizer import SGD

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 2)

        def forward(self, x, **kw):
            return self.fc(x)

    model = Net().init(0, "cpu")

    def loss(p, x, y):
        logp = torch.log_softmax(model.call(p, x), -1)
        return -torch.gather(logp, 1, y.long()[:, None]).mean()

    tree = model.tree() if params is None else {
        "fc": {k: torch.as_tensor(v) for k, v in params["fc"].items()}}
    dp = pp.DataParallel(loss, SGD(0.1), mesh=mesh)
    placed, opt_state = dp.init(tree)
    return dp, placed, opt_state


def host(params):
    """The replicated parameters as numpy ({"fc": {"w", "b"}})."""
    from paddle_tpu_torch.parallel.sharding import to_global
    return {"fc": {k: to_global(v).detach().cpu().numpy()
                   for k, v in params["fc"].items()}}


def finish():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
