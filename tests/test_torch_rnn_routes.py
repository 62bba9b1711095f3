"""The recurrences' routes (paddle_tpu_torch/ops/rnn_kernels.py
``plan_route``, ops/rnn.py) against the JAX package's, on the CPU.

JAX routes a call by its VMEM plan: the fused kernel on a batch tile
(``block_b``) where one fits, ``_lstm_scan`` where none does, and a
backward that no tile fits replays the scan under ``jax.vjp``. The port
routes by the card's residency: one launch ("whole"), one launch a row
tile ("tiles"), or the step loop ("scan"). Here the planner's routes are
checked at the H100's limits for the LSTM bench rows, and the routes are
driven at small shapes under forced small limits
(``rnn_kernels.forced_limits``), where each tile runs the kernels' plain
versions: against the untiled plain run and against JAX's ``lstm`` /
``gru`` (on the CPU JAX runs its scan). Tolerances: values 1e-5 and
gradients 2e-5 absolute and relative, as tests/test_torch_rnn.py (f32 on
both sides; the routes differ only in summation order: the tiles' dU
partials are summed in tile order, the untiled sum runs over all rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import SeqBatch as JSeqBatch
from paddle_tpu.models import AttentionSeq2Seq as JSeq2Seq
from paddle_tpu.models import LSTMTextCls as JLSTM
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core import SeqBatch
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.models import AttentionSeq2Seq, LSTMTextCls
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops import rnn_kernels as rk

ATOL = 1e-5
GRAD_TOL = 2e-5

#: forced limits and the routes they give at hidden width 8 (checked by
#: test_forced_limits_give_the_routes_the_tests_drive)
BIG = (1, 232448)       # one SM: #9 B <= 64, #10 B <= 32, #11 64, #12 32
SMALL_SMEM = (1, 40000)  # the backwards' shared memory does not fit
TINY = (1, 4096)         # nothing fits: the step loop


def _names(training, kind):
    if kind == "lstm":
        return ("lstm_seq_train", "lstm_seq_bwd") if training else (
            "lstm_seq",)
    return ("gru_seq", "gru_seq_bwd") if training else ("gru_seq",)


def _sizes(route):
    return route.kind, [n for _, n in route.tiles]


# (B, H) -> (#9's route, #10's route) on an H100 in f32
LSTM_TABLE = {
    (64, 512): (("whole", [64]), ("tiles", [32, 32])),
    (128, 256): (("whole", [128]), ("whole", [128])),
    (128, 512): (("whole", [128]), ("tiles", [32] * 4)),
    (256, 256): (("whole", [256]), ("tiles", [128, 128])),
    (256, 512): (("tiles", [128, 128]), ("tiles", [32] * 8)),
    (64, 1280): (("scan", []), ("scan", [])),
    (128, 1280): (("scan", []), ("scan", [])),
    (256, 1280): (("scan", []), ("scan", [])),
}


@pytest.mark.parametrize("B,H", sorted(LSTM_TABLE))
def test_lstm_bench_rows_take_the_stated_routes_on_an_h100(B, H):
    fwd, bwd = LSTM_TABLE[(B, H)]
    assert _sizes(rk.plan_route("lstm_seq_train", B, H)) == fwd
    assert _sizes(rk.plan_route("lstm_seq", B, H)) == fwd
    assert _sizes(rk.plan_route("lstm_seq_bwd", B, H)) == bwd


@pytest.mark.parametrize("B,fwd,bwd", [
    (64, ("whole", [64]), ("whole", [64])),
    (128, ("whole", [128]), ("tiles", [64, 64])),
    (256, ("whole", [256]), ("tiles", [64] * 4)),
    (300, ("tiles", [256, 44]), ("tiles", [64] * 4 + [44]))])
def test_gru_routes_at_the_seq2seq_width_on_an_h100(B, fwd, bwd):
    assert _sizes(rk.plan_route("gru_seq", B, 512)) == fwd
    assert _sizes(rk.plan_route("gru_seq_bwd", B, 512)) == bwd


def test_tiles_are_the_widest_that_fit_and_cover_the_batch():
    for name in rk.KERNEL_KINDS:
        for B, H in [(300, 512), (1000, 256), (77, 1024)]:
            rt = rk.plan_route(name, B, H)
            if rt.kind != "tiles":
                continue
            widest = rt.tiles[0][1]
            assert [r for r, _ in rt.tiles] == list(range(0, B, widest))
            assert sum(n for _, n in rt.tiles) == B
            whole = rk.plan_route(name, widest, H)
            assert whole.kind == "whole"
            assert rk.plan_route(name, widest + 1, H).kind != "whole"
            if name in ("lstm_seq", "lstm_seq_train", "gru_seq"):
                assert all(p is not None for p in rt.plans)


def test_width_not_a_multiple_of_4_takes_the_scan():
    for name in rk.KERNEL_KINDS:
        assert rk.plan_route(name, 8, 6).kind == "scan"


@pytest.mark.parametrize("lim,B,want", [
    (BIG, 70, [("tiles", [64, 6]), ("tiles", [32, 32, 6]),
               ("tiles", [64, 6]), ("tiles", [32, 32, 6])]),
    (BIG, 40, [("whole", [40]), ("tiles", [32, 8]), ("whole", [40]),
               ("tiles", [32, 8])]),
    (SMALL_SMEM, 40, [("whole", [40]), ("scan", []), ("whole", [40]),
                      ("scan", [])]),
    (TINY, 40, [("scan", [])] * 4)])
def test_forced_limits_give_the_routes_the_tests_drive(lim, B, want):
    got = [_sizes(rk.plan_route(n, B, 8, torch.float32, *lim))
           for n in ("lstm_seq_train", "lstm_seq_bwd", "gru_seq",
                     "gru_seq_bwd")]
    assert got == want


def _lstm_inputs(B, T, D, H, seed=0):
    rs = np.random.RandomState(seed)
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    lens = rs.randint(0, T + 1, B).astype(np.int32)
    lens[:3] = (0, 1, T)
    return dict(x=arr(B, T, D), lengths=lens, w=arr(D, 4 * H, scale=0.4),
                u=arr(H, 4 * H, scale=0.3), b=arr(4 * H, scale=0.1),
                h0=arr(B, H, scale=0.5), c0=arr(B, H, scale=0.5),
                g=arr(B, T, H), g_h=arr(B, H), g_c=arr(B, H))


def _gru_inputs(B, T, D, H, seed=0):
    a = _lstm_inputs(B, T, D, H, seed)
    rs = np.random.RandomState(seed + 1)
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    a.update(w=arr(D, 3 * H, scale=0.4), u=arr(H, 3 * H, scale=0.3),
             b=arr(3 * H, scale=0.1))
    return a


LSTM_ARGS = ("x", "w", "u", "b", "h0", "c0")
GRU_ARGS = ("x", "w", "u", "b", "h0")


def _port(kind, a, reverse, lim=None):
    """(outputs, grads) of the port's ``lstm``/``gru`` under ``lim``."""
    names = LSTM_ARGS if kind == "lstm" else GRU_ARGS
    leaves = {k: torch.tensor(a[k], requires_grad=True) for k in names}
    lens = torch.tensor(a["lengths"])
    ck.reset_launch_counts()

    def run():
        if kind == "lstm":
            out, st = R.lstm(leaves["x"], lens, leaves["w"], leaves["u"],
                             leaves["b"], leaves["h0"], leaves["c0"],
                             reverse=reverse, forget_bias=1.0)
            return out, st.h, st.c
        out, h = R.gru(leaves["x"], lens, leaves["w"], leaves["u"],
                       leaves["b"], leaves["h0"], reverse=reverse)
        return out, h

    if lim is None:
        outs = run()
    else:
        with rk.forced_limits(*lim):
            outs = run()
    cots = [torch.tensor(a[k]) for k in ("g", "g_h", "g_c")][:len(outs)]
    grads = torch.autograd.grad(outs, [leaves[k] for k in names], cots)
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads], dict(ck.ROUTES))


def _jax(kind, a, reverse):
    names = LSTM_ARGS if kind == "lstm" else GRU_ARGS
    lens = jnp.asarray(a["lengths"])

    def f(*args):
        if kind == "lstm":
            out, st = JR.lstm(args[0], lens, *args[1:], reverse=reverse,
                              forget_bias=1.0)
            return out, st.h, st.c
        out, h = JR.gru(args[0], lens, *args[1:], reverse=reverse)
        return out, h

    outs, vjp = jax.vjp(f, *(jnp.asarray(a[k]) for k in names))
    cots = tuple(jnp.asarray(a[k]) for k in ("g", "g_h", "g_c"))
    grads = vjp(cots[:len(outs)])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _close_all(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"{what} #{i}")


ROUTE_CASES = [
    # (limits, B, the routes counted: (name, route) -> count)
    (BIG, 70, "tiles", "tiles"),
    (BIG, 40, "whole", "tiles"),
    (SMALL_SMEM, 40, "whole", "scan"),
    (TINY, 40, "scan", "scan"),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("lim,B,fwd,bwd", ROUTE_CASES)
def test_routed_training_matches_untiled_plain_and_jax(lim, B, fwd, bwd,
                                                       kind, reverse):
    """Values and every gradient (dx, dW, dU, db, dh0, dc0) of a training
    call on each route against the untiled plain run and against JAX."""
    make = _lstm_inputs if kind == "lstm" else _gru_inputs
    a = make(B, 9, 5, 8)
    outs, grads, routes = _port(kind, a, reverse, lim)
    f_name, b_name = _names(True, kind)
    assert routes == {(f_name, fwd): 1, (b_name, bwd): 1}
    u_outs, u_grads, u_routes = _port(kind, a, reverse)
    assert u_routes == {}
    _close_all(outs, u_outs, ATOL, "values vs untiled")
    _close_all(grads, u_grads, GRAD_TOL, "grads vs untiled")
    j_outs, j_grads = _jax(kind, a, reverse)
    _close_all(outs, j_outs, ATOL, "values vs JAX")
    _close_all(grads, j_grads, GRAD_TOL, "grads vs JAX")


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_tiled_inference_writes_every_tile(kind):
    make = _lstm_inputs if kind == "lstm" else _gru_inputs
    a = make(70, 9, 5, 8, seed=4)
    names = LSTM_ARGS if kind == "lstm" else GRU_ARGS
    args = [torch.tensor(a[k]) for k in names]
    lens = torch.tensor(a["lengths"])
    fn = R.lstm if kind == "lstm" else R.gru
    want = fn(args[0], lens, *args[1:])
    ck.reset_launch_counts()
    with torch.no_grad(), rk.forced_limits(*BIG):
        got = fn(args[0], lens, *args[1:])
    assert ck.ROUTES == {(_names(False, kind)[0], "tiles"): 1}
    flat = lambda r: [r[0]] + list(r[1] if isinstance(r[1], tuple)
                                    else (r[1],))
    _close_all([t.numpy() for t in flat(got)],
               [t.numpy() for t in flat(want)], ATOL, "inference")


def test_tiled_kernel_wrappers_match_untiled_plain():
    """The wrappers themselves: each tile's rows of out, hT, cT and c_seq,
    and the backward's dxw, dh0, dc0 and the tile-ordered dU sum."""
    B, T, H = 70, 6, 8
    rs = np.random.RandomState(2)
    t = lambda *s, scale=1.0: torch.tensor(
        (rs.randn(*s) * scale).astype(np.float32))
    xw, u, b = t(B, T, 4 * H), t(H, 4 * H, scale=0.3), t(4 * H, scale=0.1)
    h0, c0 = t(B, H), t(B, H)
    lens = torch.tensor(rs.randint(0, T + 1, B).astype(np.int32))
    want = rk.lstm_sequence_fused(xw, lens, u, b, h0, c0, save_cell=True)
    with rk.forced_limits(*BIG):
        got = rk.lstm_sequence_fused(xw, lens, u, b, h0, c0, save_cell=True)
    _close_all([g.numpy() for g in got], [w.numpy() for w in want], ATOL,
               "forward")
    cot = (t(B, T, H), t(B, H), t(B, H))
    bw = rk.lstm_sequence_fused_bwd(xw, lens, u, b, h0, c0, want[0],
                                    want[3], *cot)
    with rk.forced_limits(*BIG):
        bg = rk.lstm_sequence_fused_bwd(xw, lens, u, b, h0, c0, want[0],
                                        want[3], *cot)
        again = rk.lstm_sequence_fused_bwd(xw, lens, u, b, h0, c0, want[0],
                                           want[3], *cot)
    _close_all([g.numpy() for g in bg], [w.numpy() for w in bw], GRAD_TOL,
               "backward")
    for g, a2 in zip(bg, again):
        assert torch.equal(g, a2)          # tile order: the same bits


def test_a_scan_shape_handed_to_a_wrapper_raises():
    xw = torch.zeros(40, 3, 32)
    with rk.forced_limits(*TINY), pytest.raises(ValueError,
                                                 match="step loop"):
        rk.lstm_sequence_fused(xw, torch.full((40,), 3), torch.zeros(8, 32))


def test_misaligned_tile_views_are_copied():
    """bf16 rows of 6 elements (12 bytes): tiles after the first start off
    the 16-byte rule and run on aligned copies, written back."""
    x = torch.arange(5 * 7 * 6, dtype=torch.float32).reshape(5, 7, 6)
    out = torch.zeros_like(x)
    seen = []

    def one(tin, touts, _):
        seen.append(all(t.data_ptr() % 16 == 0 for t in tin + touts))
        touts[0].copy_(tin[0] * 2)

    rt = rk.Route("tiles", ((0, 2), (2, 2), (4, 1)), (None,) * 3)
    xb, ob = x.to(torch.bfloat16)[:, :, :6], out.to(torch.bfloat16)
    rk._run_tiles(rt, [xb.reshape(5, 42)[:, :6]], [ob[:, 0]], one)
    assert all(seen)
    assert torch.equal(ob[:, 0], xb.reshape(5, 42)[:, :6] * 2)


# ---------------------------------------------------------------------------
# the models through the tiled and scan routes
# ---------------------------------------------------------------------------

VOCAB, EMBED, HIDDEN = 64, 8, 8


def _flat_grads(leaves, grads):
    return {"/".join(p): g.numpy() for (p, _), g in zip(tree_items(leaves),
                                                         grads)}


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (k,))
    else:
        yield prefix, tree


def _want(tree):
    return {"/".join(p): np.asarray(v) for p, v in _items(tree)}


@pytest.mark.parametrize("lim,fwd,bwd", [(BIG, "whole", "tiles"),
                                         (SMALL_SMEM, "whole", "scan"),
                                         (TINY, "scan", "scan")])
def test_lstm_textcls_loss_and_grads_match_jax_on_each_route(lim, fwd, bwd):
    jm = JLSTM(VOCAB, EMBED, HIDDEN)
    jp = jm.init(jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              LSTMTextCls(VOCAB, EMBED, HIDDEN), "cpu")
    rs = np.random.RandomState(1)
    B, T = 40, 12
    data = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    lens = rs.randint(1, T + 1, B).astype(np.int32)
    labels = rs.randint(0, 2, B).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, JSeqBatch(jnp.asarray(data), jnp.asarray(lens)),
        jnp.asarray(labels)))(jp)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.tree())
    ck.reset_launch_counts()
    with rk.forced_limits(*lim):
        loss = model.call(leaves, SeqBatch(torch.tensor(data),
                                           torch.tensor(lens)),
                          torch.tensor(labels))
        grads = torch.autograd.grad(loss,
                                    [v for _, v in tree_items(leaves)])
    assert ck.ROUTES == {("lstm_seq_train", fwd): 1, ("lstm_seq_bwd", bwd): 1}
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    got, want = _flat_grads(leaves, grads), _want(jg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("lim,fwd,bwd", [(BIG, "whole", "tiles"),
                                         (TINY, "scan", "scan")])
def test_seq2seq_loss_and_grads_match_jax_on_each_route(lim, fwd, bwd):
    S_V, T_V, E, H = 50, 40, 8, 8
    jm = JSeq2Seq(S_V, T_V, embed_dim=E, hidden=H)
    jp = jm.init(jax.random.PRNGKey(3))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              AttentionSeq2Seq(S_V, T_V, embed_dim=E,
                                               hidden=H), "cpu")
    rs = np.random.RandomState(5)
    B, S, T = 40, 9, 7
    src = rs.randint(3, S_V, (B, S)).astype(np.int32)
    tin = rs.randint(3, T_V, (B, T)).astype(np.int32)
    tout = rs.randint(3, T_V, (B, T)).astype(np.int32)
    slen = rs.randint(1, S + 1, B).astype(np.int32)
    tlen = rs.randint(1, T + 1, B).astype(np.int32)
    j = lambda d, n: JSeqBatch(jnp.asarray(d), jnp.asarray(n))
    p = lambda d, n: SeqBatch(torch.tensor(d), torch.tensor(n))
    jl, jg = jax.value_and_grad(lambda q: jm.loss(
        q, j(src, slen), j(tin, tlen), j(tout, tlen)))(jp)
    leaves = tree_map(lambda q: q.detach().requires_grad_(True),
                      model.tree())
    ck.reset_launch_counts()
    with rk.forced_limits(*lim):
        loss = model.call(leaves, p(src, slen), p(tin, tlen),
                          p(tout, tlen), method="loss")
        grads = torch.autograd.grad(loss,
                                    [v for _, v in tree_items(leaves)])
    # the encoder's two directions
    assert ck.ROUTES == {("gru_seq", fwd): 2, ("gru_seq_bwd", bwd): 2}
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    got, want = _flat_grads(leaves, grads), _want(jg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)
