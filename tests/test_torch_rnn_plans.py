"""The recurrent forward kernels' plans (paddle_tpu_torch/ops/rnn_kernels.py
``forward_plan``, ``forward_plans``) and their tiling, on the CPU.

The plans are pure functions of (B, H, SMs, shared memory a block): held
here at an H100's 132 SMs and 227 KB (232448 bytes) to the grids PERF.md
states for the benches, to every shape the 4-unit x 32-row forwards they
replace took (the rule below, from those kernels' source and their
registers), and to the batch limits the module docstring states, past
which a caller must split the batch.

The tiling is held by a plain-torch model of the product a step of
csrc/recur.cuh ``Prod::dot`` computes: k in the kernel's lane slices (k =
64 it + 4 kl + kk, zero past H), the 16 lanes' partials summed by the
reduce-scatter's tree, a pair of warps' sums added where it splits the
column steps, U's columns past H zero where H is not a multiple of the
units (the tail units). The model's LSTM and GRU forwards at every
plan the wrappers can choose are held against the JAX Pallas kernels in
interpret mode and the plain versions: atol/rtol 1e-5 (f32 on every
side, only the order of sums differs). The kernels themselves run only on
the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import rnn_kernels as rk

SMS, SMEM = rk.H100
ATOL = RTOL = 1e-5


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,B,H,units,rows,parts,grid", [
    ("lstm", 64, 256, 8, 16, 2, (32, 4)),     # the flagship text classifier
    ("lstm", 128, 256, 8, 32, 1, (32, 4)),    # SUITE_ROWS (128, 256)
    ("gru", 64, 512, 16, 16, 2, (32, 4)),     # the seq2seq encoder
    ("gru", 128, 512, 16, 32, 1, (32, 4)),    # its generate at B = 128
    ("gru", 37, 512, 16, 16, 2, (32, 3)),     # a partial row tile
])
def test_bench_shapes_get_the_stated_plans(kind, B, H, units, rows, parts,
                                           grid):
    """PERF.md's plans: one block an SM (256 threads), U's columns (and
    512 bytes a pair of warps) in shared memory."""
    p = rk.forward_plan(kind, B, H, SMS, SMEM)
    assert (p.units, p.rows, p.parts, p.grid, p.per_sm) == (
        units, rows, parts, grid, 1)
    gates = 4 if kind == "lstm" else 3
    assert p.threads == 32 * parts * rows // rk.rows_a_warp(kind, units)
    assert p.smem == gates * 64 * -(-H // 64) * units * 4 + (
        p.threads // 64 * 512 if parts == 2 else 0)


def _parent_took(kind, B, H):
    """Whether the forwards these replace (4 hidden units x 32 batch rows,
    256 threads a block, U's columns and 32 staged f32 rows in shared
    memory) launched (B, H) on an H100: their grid (H/4) x ceil(B/32) had
    to fit one wave at the blocks an SM their registers left (ptxas for
    sm_90a: the LSTM bodies 72-78 registers, 3 blocks; the GRU's 89-96 at
    launch bounds (256, 2), 2 blocks) and their shared memory left."""
    if H % 4:
        return False
    smem = (16 if kind == "lstm" else 12) * H + 128 * (H + 4)
    if smem > SMEM:
        return False
    per_sm = min(3 if kind == "lstm" else 2, (SMEM + 1024) // (smem + 1024))
    return (H // 4) * -(-B // 32) <= SMS * per_sm


def _max_batch(took, H):
    lo, hi = 0, 1
    while took(hi, H):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if took(mid, H) else (lo, mid)
    return lo


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_every_shape_the_parent_took_still_plans(kind):
    """For every H a multiple of 4 up to 1280: the largest, half the
    largest and the smallest B the replaced forwards took still plan (so
    does every B between, the plans' grids growing with B), but the LSTM's
    at H = 4 past B = 8448, which the docstring states."""
    new_max = lambda H: _max_batch(
        lambda B, h: rk.forward_plan(kind, B, h, SMS, SMEM) is not None, H)
    old_max = lambda H: _max_batch(lambda B, h: _parent_took(kind, B, h), H)
    checked = 0
    for H in range(4, 1284, 4):
        top = old_max(H)
        if top == 0:
            continue
        want = min(top, 8448) if (kind, H) == ("lstm", 4) else top
        assert new_max(H) >= want, (kind, H, top)
        for B in {1, (top + 1) // 2, want}:
            assert rk.forward_plan(kind, B, H, SMS, SMEM) is not None
        checked += 1
    assert checked >= 200                 # every H to 816 (LSTM), 1020
    if kind == "lstm":
        assert (old_max(4), new_max(4)) == (12672, 8448)


@pytest.mark.parametrize("kind,H,limit", [
    ("lstm", 256, 256), ("lstm", 512, 128), ("lstm", 1280, 0),
    ("gru", 256, 528), ("gru", 512, 256), ("gru", 1024, 64),
])
def test_split_the_batch_exactly_at_the_documented_limits(kind, H, limit):
    """The module docstring's limits: B <= limit plans, limit + 1 does not
    (a caller splits the batch there; the wrapper raises ValueError)."""
    doc = " ".join(rk.__doc__.split())
    name = "LSTM forwards take" if kind == "lstm" else "GRU forward takes"
    assert name in doc
    if limit:
        assert f"B <= {limit} at H = {H}" in doc
        assert rk.forward_plan(kind, limit, H, SMS, SMEM) is not None
    else:
        assert f"no B at H = {H}" in doc
    assert rk.forward_plan(kind, limit + 1, H, SMS, SMEM) is None


def test_no_plan_for_a_width_that_is_not_a_multiple_of_4():
    for kind in ("lstm", "gru"):
        assert rk.forward_plan(kind, 8, 10, SMS, SMEM) is None
        assert rk.forward_plans(kind, 8, 6, SMS, SMEM) == []


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_every_plan_fits_one_wave(kind):
    """Each plan forward_plans lists keeps its grid resident: blocks
    within the SMs times the blocks an SM holds (128 registers a thread,
    the shared memory), U's columns within a block's shared memory; the
    cheapest first."""
    for B in (1, 5, 37, 64, 128, 300, 1000):
        for H in (4, 12, 64, 256, 512, 1024):
            plans = rk.forward_plans(kind, B, H, SMS, SMEM)
            assert [p.cost for p in plans] == sorted(p.cost for p in plans)
            for p in plans:
                blocks = p.grid[0] * p.grid[1]
                assert p.grid == (-(-H // p.units), -(-B // p.rows))
                assert p.threads <= 256 and p.parts in (1, 2)
                assert p.smem <= SMEM
                assert blocks <= SMS * rk._blocks_an_sm(p.threads, p.smem,
                                                        SMEM)
                assert p.per_sm == -(-blocks // SMS)


# ---------------------------------------------------------------------------
# the tiling, as a plain-torch model
# ---------------------------------------------------------------------------

def tiled_dot(h, w, units, parts=1):
    """h [B, H] @ w [H, NG, H] as csrc/recur.cuh Prod::dot forms it on a
    grid of ``units``-unit blocks: U's columns past H zero (the tail units
    of the last block), the 16 lanes' k slices 64 it + 4 kl + kk (zero past
    H), each lane's partial summed over its column steps it and kk in
    order, the 16 partials by the reduce-scatter's tree over lane bits 8,
    4, 2, 1 (which half-warp takes a column does not change its sum); with
    ``parts`` = 2 the two warps of a pair take the even and the odd column
    steps and the first adds the second's sums to its own. -> [B, NG, H]."""
    B, H = h.shape
    NG = w.shape[1]
    nit = -(-H // 64)
    Hu = units * -(-H // units)
    hp = torch.zeros(B, 64 * nit)
    hp[:, :H] = h
    wp = torch.zeros(64 * nit, NG, Hu)
    wp[:H, :, :H] = w
    lanes = torch.arange(16)
    total = None
    for part in range(parts):
        acc = torch.zeros(16, B, NG, Hu)
        for it in range(part, nit, parts):
            for kk in range(4):
                k = 64 * it + 4 * lanes + kk                   # [16]
                acc = acc + hp[:, k].t()[:, :, None, None] * wp[k][:, None]
        p = acc.view(2, 2, 2, 2, B, NG, Hu)                    # kl bits
        for _ in range(3):
            p = p[0] + p[1]
        p = p[0] + p[1]
        total = p if total is None else total + p
    return total[:, :, :H]


def tiled_lstm(xw, lengths, u, b, h0, c0, forget_bias, units, parts):
    B, T, G = xw.shape
    H = G // 4
    w = u.view(H, 4, H)
    lens = lengths.float()[:, None]
    h, c, outs, cells = h0, c0, [], []
    for t in range(T):
        gates = (xw[:, t].view(B, 4, H) + tiled_dot(h, w, units, parts)
                 ) + b.view(4, H)
        i, f = torch.sigmoid(gates[:, 0]), torch.sigmoid(
            gates[:, 1] + forget_bias)
        g, o = torch.tanh(gates[:, 2]), torch.sigmoid(gates[:, 3])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = (t < lens).float()
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        outs.append(m * h)
        cells.append(c)
    return torch.stack(outs, 1), h, c, torch.stack(cells, 1)


def tiled_gru(xw, lengths, u, h0, units, parts):
    B, T, G = xw.shape
    H = G // 3
    w = u.view(H, 3, H)
    lens = lengths.float()[:, None]
    h, outs = h0, []
    for t in range(T):
        x = xw[:, t].view(B, 3, H)
        zr = torch.sigmoid(x[:, :2] + tiled_dot(h, w[:, :2], units, parts))
        z, r = zr[:, 0], zr[:, 1]
        c = torch.tanh(x[:, 2] + tiled_dot(r * h, w[:, 2:], units,
                                           parts)[:, 0])
        h_new = (1 - z) * h + z * c
        m = (t < lens).float()
        h = m * h_new + (1 - m) * h
        outs.append(m * h)
    return torch.stack(outs, 1), h


def _arrays(B, T, H, gates, seed):
    rs = np.random.RandomState(seed)
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    lens = rs.randint(0, T + 1, B).astype(np.int32)
    lens[:2] = (0, T)
    return (arr(B, T, gates * H, scale=0.7), lens, arr(H, gates * H,
                                                      scale=0.3),
            arr(gates * H, scale=0.1), arr(B, H, scale=0.5),
            arr(B, H, scale=0.5))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL)


# (B, T, H): H = 12 and 36 are 4 mod 8 (tail units in every plan), 36 and
# 40 not multiples of 64 (k past H in the last column step), B = 5 a
# partial row tile
SHAPES = [(5, 6, 12), (3, 4, 36), (9, 5, 40)]


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_tiled_lstm_at_every_plan_matches_jax_and_plain(B, T, H):
    xw, lens, u, b, h0, c0 = _arrays(B, T, H, 4, seed=H)
    fb = 1.0
    want = pk.lstm_sequence_fused(*(jnp.asarray(a) for a in (
        xw, lens, u, b, h0, c0)), forget_bias=fb, block_b=2,
        save_cell=True, interpret=True)
    t = [torch.from_numpy(a) for a in (xw, lens, u, b, h0, c0)]
    plain = rk.lstm_sequence_fused(*t, forget_bias=fb, save_cell=True)
    tilings = {(p.units, p.parts)
               for p in rk.forward_plans("lstm", B, H, SMS, SMEM)}
    assert {n for n, _ in tilings} == {8, 16}
    for n, parts in sorted(tilings):
        if H % n:                              # the last block's tail units
            assert -(-H // n) * n - H in (4, 8, 12)
        got = tiled_lstm(*t[:4], t[4], t[5], fb, n, parts)
        for g, w, p in zip(got, want, plain):
            _close(g, w)
            _close(g, p)


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_tiled_gru_at_every_plan_matches_jax_and_plain(B, T, H):
    xw, lens, u, _, h0, _ = _arrays(B, T, H, 3, seed=H + 1)
    want = pk.gru_sequence_fused(jnp.asarray(xw), jnp.asarray(lens),
                                 jnp.asarray(u), h0=jnp.asarray(h0),
                                 block_b=2, interpret=True)
    t = [torch.from_numpy(a) for a in (xw, lens, u, h0)]
    plain = rk.gru_sequence_fused(t[0], t[1], t[2], h0=t[3])
    tilings = {(p.units, p.parts)
               for p in rk.forward_plans("gru", B, H, SMS, SMEM)}
    assert {n for n, _ in tilings} == {8, 16}
    for n, parts in sorted(tilings):
        got = tiled_gru(*t, n, parts)
        for g, w, p in zip(got, want, plain):
            _close(g, w)
            _close(g, p)
