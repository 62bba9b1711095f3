"""Worlds of gloo ranks for the parallel plane's tests (on the CPU; the
card tests' ranks all sit on cuda:0).

torch only: no jax, nothing of ``paddle_tpu``. Not collected (no
``test_`` prefix). :func:`run_world` spawns ``world`` processes
(``torch.multiprocessing``'s spawn context), each a gloo rank of one
``torch.distributed`` world over a ``FileStore`` under the test's
``tmp_path`` (no port, so parallel test workers cannot clash). Each rank
takes one CPU thread, runs every case of the list in order and pickles
its results; a case that raises records its traceback and the rest go
on. A rank that dies, or a world that outlives ``timeout`` seconds,
fails the test and leaves no process behind.

The case functions below run on every rank; they take numpy inputs made
in the test process (where the JAX package computes the reference) and
return numpy results.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import sys
import time
import traceback

import numpy as np

WORLD = 4
TIMEOUT_S = 90.0


def run_world(tmp_path, cases, world: int = WORLD,
              timeout: float = TIMEOUT_S):
    """Run ``cases`` — (name, "module:function", kwargs) — on a fresh
    world; returns one {name: ("ok", result) | ("error", traceback)}
    dict a rank."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    os.makedirs(str(tmp_path), exist_ok=True)
    store = os.path.join(str(tmp_path), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, str(tmp_path), cases),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs
                   if p.exitcode is not None and p.exitcode != 0]
            if bad:
                raise AssertionError(
                    f"rank {procs.index(bad[0])} exited with "
                    f"{bad[0].exitcode}")
            if time.monotonic() > deadline:
                raise AssertionError(f"the world outlived {timeout} s")
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    out = []
    for r in range(world):
        with open(os.path.join(str(tmp_path), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, store, out_dir, cases):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    for name, target, kwargs in cases:
        mod, fn = target.split(":")
        try:
            results[name] = ("ok", getattr(importlib.import_module(mod),
                                           fn)(**kwargs))
        except Exception:  # noqa: BLE001 - recorded for the test to show
            results[name] = ("error", traceback.format_exc())
    results["_imports_jax"] = ("ok", "jax" in sys.modules or any(
        m.split(".")[0] == "paddle_tpu" for m in sys.modules))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def result(ranks, name, rank: int = 0):
    """One rank's result of a case; a case that raised fails here with
    its traceback."""
    status, value = ranks[rank][name]
    if status != "ok":
        raise AssertionError(f"case {name} on rank {rank}:\n{value}")
    return value


# ---------------------------------------------------------------------------
# rank-side helpers
# ---------------------------------------------------------------------------

def _np(x):
    import torch

    from paddle_tpu_torch.parallel.sharding import to_global
    x = to_global(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _t(a):
    import torch
    return torch.as_tensor(np.asarray(a))


def _mesh(**axes):
    from paddle_tpu_torch import parallel as pp
    return pp.make_mesh(device="cpu", **axes)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def mesh_shapes():
    import torch

    from paddle_tpu_torch import parallel as pp
    out = {}
    m = _mesh(data=-1)
    out["wild"] = (m.shape, m.axis_names)
    m = _mesh(data=2, model=2)
    out["data_model"] = (m.shape, m.axis_names,
                         m.coordinate("data"), m.coordinate("model"))
    try:
        _mesh(data=3, model=3)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    sub = _mesh(data=2)
    out["sub_member"] = sub.member
    if sub.member:
        with sub:
            out["sub_sum"] = float(pp.all_reduce(torch.ones(()), "data"))
    else:
        try:
            with sub:
                pp.all_reduce(torch.ones(()), "data")
            out["sub_outside"] = None
        except (RuntimeError, NameError) as e:
            out["sub_outside"] = str(e)
    with pp.use_mesh(m) as cur:
        out["ambient"] = pp.current_mesh() is cur
    out["after"] = pp.current_mesh() is None
    return out


def collectives(x):
    import torch

    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import P
    mesh = _mesh(data=4)

    def f(x):
        s = pp.all_reduce(x, "data")
        mean = pp.all_reduce(x, "data", "mean")
        mx = pp.all_reduce(x, "data", "max")
        mn = pp.all_reduce(x, "data", "min")
        g = pp.all_gather(x, "data")
        gu = pp.all_gather(x, "data", tiled=False).reshape(-1)
        rs = pp.reduce_scatter(g, "data")
        idx = pp.axis_index("data")
        nxt = pp.permute_ring(idx.to(torch.float32).reshape(1), "data")
        prv = pp.permute_ring(idx.to(torch.float32).reshape(1), "data", -1)
        bc = pp.broadcast(x, "data", root=2)
        a2a = pp.all_to_all(x, "data", split_axis=0, concat_axis=0)
        return s, mean, mx, mn, g, gu, rs, nxt, prv, bc, a2a

    fn = pp.shard_map(f, mesh=mesh, in_specs=P("data"),
                      out_specs=(P("data"),) * 11)
    return _np(fn(_t(x)))


def _net():
    from paddle_tpu_torch.nn import Linear, Module

    class Net(Module):
        def __init__(self):
            super().__init__()
            self.l1 = Linear(12, 32, act="relu")
            self.l2 = Linear(32, 3)

        def forward(self, x):
            return self.l2(self.l1(x))
    return Net()


def _net_loss(params0):
    import torch

    from paddle_tpu_torch.convert import params_from_numpy
    model = params_from_numpy(params0, _net(), device="cpu")

    def loss(params, x, y):
        logp = torch.log_softmax(model.call(params, x), -1)
        return -torch.gather(logp, 1, y.long()[:, None]).mean()
    return model, loss


def dp_steps(params0, x, y, steps, opt, layout=None):
    """DataParallel steps on data=4 (or ``layout`` on fsdp=2, tp=2)."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import P, local
    model, loss = _net_loss(params0)
    make = {"sgd": lambda: O.SGD(0.1), "adam": lambda: O.Adam(1e-2)}[opt]
    if layout is None:
        mesh = _mesh(data=4)
        dp = pp.DataParallel(loss, make(), mesh=mesh)
    else:
        mesh = _mesh(fsdp=2, tp=2)
        dp = pp.DataParallel(loss, make(), mesh=mesh,
                             param_rules=pp.SpecLayout(
                                 rules=[(pat, P(*spec)) for pat, spec in
                                        layout]))
    p, s = dp.init(model.tree())
    bx, by = dp.shard_batch((_t(x), _t(y)))
    losses = []
    for _ in range(steps):
        p, s, l = dp.step(p, s, bx, by)
        losses.append(float(l))
    from paddle_tpu_torch.core.pytree import tree_items
    nbytes = sum(local(leaf).nbytes for _, leaf in tree_items(p)) + sum(
        local(leaf).nbytes for _, leaf in tree_items(s["slots"]))
    specs = {"/".join(path): tuple(pp.sharding.spec_of(leaf))
             for path, leaf in tree_items(p)}
    return {"params": _np(p), "losses": losses, "bytes": nbytes,
            "specs": specs}


def single_steps(params0, x, y, steps, opt):
    """The same steps on one rank, the whole batch (no mesh)."""
    import torch

    from paddle_tpu_torch import optimizer as O
    model, loss = _net_loss(params0)
    o = {"sgd": lambda: O.SGD(0.1), "adam": lambda: O.Adam(1e-2)}[opt]()
    p = model.tree()
    s = o.init(p)
    for _ in range(steps):
        leaves = {k: {n: t.detach().requires_grad_(True)
                      for n, t in v.items()} for k, v in p.items()}
        lv = loss(leaves, _t(x), _t(y))
        flat = [t for v in leaves.values() for t in v.values()]
        gs = iter(torch.autograd.grad(lv, flat))
        grads = {k: {n: next(gs) for n in v} for k, v in leaves.items()}
        p, s = o.update(grads, s, p)
    return _np(p)


def zero1_steps(params0, x, y, steps):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import local
    model, loss = _net_loss(params0)
    z = pp.Zero1DataParallel(loss, O.Adam(1e-2), mesh=_mesh(data=4))
    zs = z.init(model.tree())
    b = z.shard_batch((_t(x), _t(y)))
    for _ in range(steps):
        zs, _ = z.step(zs, *b)
    return {"params": _np(z.params(zs)),
            "flat": (tuple(local(zs.flat).shape), tuple(zs.flat.shape)),
            "slots": [(tuple(local(v).shape), tuple(v.shape)) for v in
                      zs.opt_state["slots"]["flat"].values()]}


def trainer_mesh(params0, x, y, steps, ckpt_dir):
    """Trainer(mesh=) and Trainer(layout=) under use_mesh against a
    single-rank Trainer, on the same global batches; a mesh Trainer's
    checkpoint (the gathered tensors) and its resume on another mesh."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer.checkpoint import load_checkpoint
    model, loss = _net_loss(params0)
    batches = [(_t(x), _t(y))] * steps

    def reader():
        return iter(batches)

    out = {}
    t1 = Trainer(loss, O.Adam(1e-2), device="cpu")
    out["single"] = _np(t1.train(reader, model.tree(),
                                 handle_signals=False)[0])
    out["single2"] = _np(Trainer(loss, O.Adam(1e-2), device="cpu").train(
        reader, model.tree(), num_passes=2, handle_signals=False)[0])
    tc = Trainer(loss, O.Adam(1e-2), mesh=_mesh(data=4), output_dir=ckpt_dir)
    p, _ = tc.train(reader, model.tree(), handle_signals=False)
    saved, _, state = load_checkpoint(ckpt_dir, device="cpu")
    out["ckpt"] = (_np(p), _np(saved), state["pass_id"])
    bad = np.array(x, copy=True)
    bad[0, 0] = np.nan               # a non-finite loss on the 2nd batch
    skipping = [batches[0], (_t(bad), _t(y)), batches[0]]
    for name, kw in (("skip_single", {"device": "cpu"}),
                     ("skip_mesh", {"mesh": _mesh(data=4)})):
        ts = Trainer(loss, O.Adam(1e-2), on_nonfinite="skip", **kw)
        out[name] = (_np(ts.train(lambda: iter(skipping), model.tree(),
                                  handle_signals=False)[0]),
                     ts.train_stats["skipped_batches"])
    tr = Trainer(loss, O.Adam(1e-2), mesh=_mesh(data=2, fsdp=2),
                 layout=pp.SpecLayout(), output_dir=ckpt_dir)
    out["resumed"] = _np(tr.train(reader, model.tree(), num_passes=1,
                                  resume=True, handle_signals=False)[0])
    t4 = Trainer(loss, O.Adam(1e-2), mesh=_mesh(data=4))
    out["mesh"] = _np(t4.train(reader, model.tree(),
                               handle_signals=False)[0])
    try:
        Trainer(loss, O.Adam(1e-2), device="cpu", layout=pp.SpecLayout())
        out["no_mesh"] = None
    except ValueError as e:
        out["no_mesh"] = str(e)
    with pp.use_mesh(_mesh(data=2, fsdp=2)):
        tl = Trainer(loss, O.Adam(1e-2), layout=pp.SpecLayout())
    out["layout"] = _np(tl.train(reader, model.tree(),
                                 handle_signals=False)[0])
    out["test_cost"] = tl.test(reader, model.tree())["cost"]
    return out


def tp_layers(params, x, table, ids):
    import torch

    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.nn import Module
    from paddle_tpu_torch.parallel.sharding import P

    class TPNet(Module):
        def __init__(self):
            super().__init__()
            self.up = pp.ColumnParallelLinear(16, 64, act="relu")
            self.down = pp.RowParallelLinear(64, 8)

        def forward(self, x):
            return self.down(self.up(x))

    net = params_from_numpy(params, TPNet(), device="cpu")
    xt = _t(x)
    out = {"dense": _np(net(xt))}
    mesh = _mesh(data=2, model=2)
    rules = pp.ShardingRules(pp.tensor_parallel.collect_tp_rules(net)
                             + [(r".*", P())])
    out["rules"] = [(pat, tuple(spec)) for pat, spec in
                    pp.tensor_parallel.collect_tp_rules(net)]
    sp = rules.apply(mesh, net.tree())
    with mesh:
        out["tp"] = _np(net.call(sp, xt))
    fn = pp.shard_map(lambda p, x: net.call(p, x), mesh=mesh,
                      in_specs=(P(), P("data")), out_specs=P("data"))
    out["tp_data"] = _np(fn(sp, xt))
    emb = params_from_numpy({"table": table}, pp.ShardedEmbedding(64, 16),
                            device="cpu")
    m4 = _mesh(model=4)
    se = pp.ShardingRules(pp.tensor_parallel.collect_tp_rules(emb)).apply(
        m4, emb.tree())
    with m4:
        out["emb"] = _np(emb.call(se, torch.as_tensor(ids)))
    return out


def _stage_fn(p, mb):
    import torch
    return torch.tanh(mb @ p["w"] + p["b"])


def pipeline(params, x, x6, y6, x4, y4):
    import torch

    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.nn import Linear
    mesh = _mesh(pipe=4)
    stage = params_from_numpy(params, pp.PipelineStage(
        lambda: Linear(16, 16, act="tanh"), n_stages=4), device="cpu")
    tree = stage.tree()
    out = {"sequential": _np(stage(_t(x)))}
    run = pp.pipeline_spmd(_stage_fn, mesh, n_microbatches=4)
    out["spmd"] = _np(run(tree, _t(x)))

    def loss_fn(o, y):
        return torch.mean((o - y) ** 2)

    for n, xs, ys in ((6, x6, y6), (4, x4, y4)):
        step = pp.pipeline_1f1b(_stage_fn, loss_fn, mesh, n_microbatches=n)
        out[f"1f1b_{n}"] = _np(step(tree, _t(xs), _t(ys)))
    # autodiff through the GPipe ring trains
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree.items()}
    y = torch.zeros(8, 16) + 0.5
    l0 = torch.mean((run(leaves, _t(x)) - y) ** 2)
    grads = torch.autograd.grad(l0, list(leaves.values()))
    new = {k: v.detach() - 0.5 * g for (k, v), g in zip(leaves.items(),
                                                        grads)}
    l1 = torch.mean((run(new, _t(x)) - y) ** 2)
    out["trains"] = (float(l0), float(l1))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------

def ring_cases(q, k, v, g, q36, k36, v36, qu, ku, vu, gu):
    import warnings

    import torch

    from paddle_tpu_torch import parallel as pp
    mesh = _mesh(seq=4)
    out = {}

    def run(fn, qq, kk, vv, gg):
        leaves = [_t(a).requires_grad_(True) for a in (qq, kk, vv)]
        o = fn(*leaves)
        grads = torch.autograd.grad((o * _t(gg)).sum(), leaves)
        return _np(o), _np(list(grads))

    for name, causal, layout in (("full", False, None),
                                 ("zigzag", True, None),
                                 ("contiguous", True, "contiguous")):
        out[name] = run(lambda a, b, c: pp.ring_self_attention(
            mesh, a, b, c, causal=causal, layout=layout), q, k, v, g)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        o = pp.ring_self_attention(mesh, _t(q36), _t(k36), _t(v36),
                                   causal=True)
    out["fallback"] = (_np(o), [str(x.message) for x in w])
    out["ulysses"] = run(lambda a, b, c: pp.ulysses_attention(mesh, a, b, c),
                         qu, ku, vu, gu)
    out["ulysses_causal"] = run(lambda a, b, c: pp.ulysses_attention(
        mesh, a, b, c, causal=True), qu, ku, vu, gu)
    return out


def lm_seq_cases(params, ids, ids33, vocab, d, heads, layers):
    import torch

    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.parallel.sharding import P
    mesh = _mesh(seq=4)
    out = {}
    for remat in (False, True):
        model = params_from_numpy(params, TransformerLM(
            vocab, d_model=d, n_heads=heads, n_layers=layers, max_len=33,
            remat=remat), device="cpu")
        ids_t = _t(ids)
        positions = torch.arange(ids_t.shape[1]).expand(ids_t.shape)
        fwd = pp.shard_map(
            lambda p, i, pos: model.call(p, i, positions=pos, seq_axis="seq"),
            mesh=mesh, in_specs=(P(), P(None, "seq"), P(None, "seq")),
            out_specs=P(None, "seq"))
        tag = "remat_" if remat else ""
        with torch.no_grad():
            out[tag + "forward"] = _np(fwd(model.tree(), ids_t, positions))
        i33 = _t(ids33)
        ids_in, targets = i33[:, :-1], i33[:, 1:]
        pos = torch.arange(ids_in.shape[1]).expand(ids_in.shape)
        mask = (torch.arange(ids_in.shape[1]) < 29).expand(ids_in.shape)
        loss = pp.shard_map(
            lambda p, a, b, c, m: model.call(p, a, b, mask=m, positions=c,
                                             seq_axis="seq",
                                             method="shifted_loss"),
            mesh=mesh, in_specs=(P(), P(None, "seq"), P(None, "seq"),
                                 P(None, "seq"), P(None, "seq")),
            out_specs=P())
        items = [(path, t.detach().requires_grad_(True))
                 for path, t in tree_items(model.tree())]
        from paddle_tpu_torch.core.pytree import tree_from_items
        lv = loss(tree_from_items(items), ids_in, targets, pos, mask)
        grads = torch.autograd.grad(lv, [t for _, t in items])
        out[tag + "loss"] = float(lv)
        out[tag + "grads"] = {"/".join(path): g.numpy() for (path, _), g in
                              zip(items, grads)}
    try:
        model.loss(_t(ids33), seq_axis="seq")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    try:
        with mesh:
            model.blocks[0].attend(*(torch.zeros(2, 8, 4, 8),) * 3,
                                   kv_lens=torch.ones(2), seq_axis="seq")
        out["kv_lens"] = None
    except NotImplementedError as e:
        out["kv_lens"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe.py
# ---------------------------------------------------------------------------

def moe_cases(params, x, y_target):
    import torch

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.moe import moe_ffn_dense
    mesh = _mesh(expert=4)
    p = {k: _t(v) for k, v in params.items()}
    xt = _t(x)
    T_local = xt.shape[0] // 4
    out = {}
    for k in (1, 2):
        moe = pp.ExpertParallelMoE(mesh, k=k, capacity=T_local)
        y, aux = moe(moe.shard_params(p), moe.shard_tokens(xt))
        out[f"k{k}"] = (_np(y), float(aux))
    moe = pp.ExpertParallelMoE(mesh, k=1, capacity=1)
    out["drops"] = _np(moe(moe.shard_params(p), moe.shard_tokens(xt))[0])

    # gradients through the all_to_all pipeline against the dense ones
    moe = pp.ExpertParallelMoE(mesh, k=1, capacity=T_local)
    leaves = {kk: v.clone().requires_grad_(True) for kk, v in p.items()}
    y, aux = moe(leaves, xt)
    gs = torch.autograd.grad(torch.mean(y * y) + 0.01 * aux,
                             list(leaves.values()))
    dl = {kk: v.clone().requires_grad_(True) for kk, v in p.items()}
    outs, auxes = [], []
    for s in range(4):
        yd, a = moe_ffn_dense(dl, xt[s * T_local:(s + 1) * T_local], k=1,
                              capacity=T_local)
        outs.append(yd)
        auxes.append(a)
    yd = torch.cat(outs)
    gd = torch.autograd.grad(torch.mean(yd * yd)
                             + 0.01 * torch.stack(auxes).mean(),
                             list(dl.values()))
    out["grads"] = (_np(list(gs)), _np(list(gd)))

    # an Adam step loop over the expert mesh fits random targets
    moe = pp.ExpertParallelMoE(mesh, k=2, capacity=T_local)
    opt = O.Adam(3e-3)
    sp = {kk: v.clone() for kk, v in p.items()}
    state = opt.init(sp)
    yt = _t(y_target)
    losses = []
    for _ in range(30):
        leaves = {kk: v.detach().requires_grad_(True) for kk, v in sp.items()}
        y, aux = moe(leaves, xt)
        lv = torch.mean((y - yt) ** 2) + 0.01 * aux
        grads = dict(zip(leaves, torch.autograd.grad(lv,
                                                     list(leaves.values()))))
        sp, state = opt.update(grads, state, sp)
        losses.append(float(lv))
    out["losses"] = losses
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_gpu.py: gloo ranks on cuda:0
# ---------------------------------------------------------------------------

def gpu_ring():
    """The zigzag ring over seq = 2 ranks on cuda:0 against one
    flash_attention call, forward and backward (f32)."""
    import torch

    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pp.make_mesh(seq=2, device="cuda:0")
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 128, 2, 64, generator=gen).cuda()
                  for _ in range(4))
    out = {}
    for name, fn in (("ring", lambda a, b, c: pp.ring_self_attention(
            mesh, a, b, c, causal=True)),
            ("flash", lambda a, b, c: ck.flash_attention(a, b, c,
                                                         causal=True))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ck.reset_launch_counts()
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, grad_outputs=g)
        torch.cuda.synchronize()
        out[name] = [t.detach().cpu().numpy() for t in [o, *grads]]
        out[name + "_launches"] = dict(ck.LAUNCHES)
    return out


def gpu_raw_op(op: str):
    """One transport of gloo tried raw on a CUDA tensor: where gloo does
    not take CUDA tensors it may abort the process (a send from device
    memory), so each is tried in a world of its own."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank), device="cuda:0")
    if op == "broadcast":
        dist.broadcast(x.clone(), src=0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif op == "all_to_all":
        dist.all_to_all_single(torch.empty_like(x), x)
    else:
        r = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, r, (rank - 1) % world)]
        for q in dist.batch_isend_irecv(ops):
            q.wait()
    torch.cuda.synchronize()
    return True


def gpu_staged():
    """The transports the port's collectives staged through pinned host
    memory for CUDA tensors over gloo."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel import collectives as cc
    torch.cuda.set_device(0)
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank), device="cuda:0")
    mesh = pp.make_mesh(data=world, device="cuda:0")
    cc.reset_staged()
    with mesh:
        pp.all_reduce(x, "data")
        pp.all_gather(x, "data")
        pp.reduce_scatter(x, "data")
        pp.all_to_all(x, "data", 0, 0)
        pp.broadcast(x, "data", 1)
        pp.permute_ring(x, "data")
    torch.cuda.synchronize()
    return sorted(op for op, _ in cc.STAGED)
