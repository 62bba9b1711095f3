"""The phase split of the port's GRU backward kernel
(``csrc/gru_seq_bwd.cu``), written out in plain PyTorch and held against
the JAX package's ``gru_sequence_fused_bwd`` (the Pallas kernel in
interpret mode, as tests/test_torch_gru.py runs it) and against the port's
plain version, on the CPU.

The kernel first compacts the live (b, t) rows -- a step at or past a
sample's length adds nothing to any output -- sample by sample, each
sample's steps in order, and finds the sample of row i as the last b whose
prefix sum of lengths is <= i (samples of length 0 share their
successor's prefix). It then runs in three phases over those rows only:
(1) the gates as products over all live rows, [z|r] from h_{t-1} and, after
a grid barrier, c from r*h_{t-1}; (2) the reverse recurrence, in which only
rows live at the step are read and a row past its length keeps its dh;
(3) dU as products over all live rows, in stages of 64 rows each summed on
its own and added in order. :func:`phase_split_bwd` is that phase split,
that compaction and that skipping of dead rows; it does not model the
kernel's order of sums inside a product (a tensor-core tile, a warp's
reduce-scatter), which is the matmul's here. The CUDA kernel itself,
which has no CPU version, is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerances, as tests/test_torch_gru.py states them: f32 outputs atol/rtol
1e-5 (both sides compute in f32 and differ only in summation order); bf16
outputs one bf16 ulp (rtol 2**-7, atol 1e-6: the same f32 values rounded
once); du, an f32 sum of B*T products, rtol 1e-5 plus 1e-5 of its largest
magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import rnn_kernels as rk
from paddle_tpu_torch.ops.rnn import _reverse_within_length

ATOL = RTOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6
STAGE = 64              # rows of a dU stage (the kernel's kTK)

# (B, T, H, lengths): B=37 spans two batch tiles of 32 with lengths 0, 1
# and T among random ones; H=12 gives a block of 8 units half empty and
# bf16 rows of 4k + 4 elements; a single step
CASES = [
    (37, 9, 16, "ragged"),
    (5, 7, 12, [0, 1, 7, 3, 5]),
    (3, 1, 8, [1, 0, 1]),
]


def _lengths(B, T, lens, rs):
    if lens != "ragged":
        return np.asarray(lens, np.int32)
    out = rs.randint(0, T + 1, B).astype(np.int32)
    out[:3] = (0, 1, T)
    return out


def _inputs(B, T, H, lens, seed):
    rs = np.random.RandomState(seed)
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return dict(xw=arr(B, T, 3 * H, scale=0.7),
                lengths=_lengths(B, T, lens, rs), u=arr(H, 3 * H, scale=0.3),
                h0=arr(B, H, scale=0.5), g_out=arr(B, T, H),
                g_ht=arr(B, H))


def live_rows(lengths, T):
    """The kernel's compaction: (b, t) of each live row i, found as the
    last sample whose prefix sum of lengths is <= i."""
    lens = [min(max(int(n), 0), T) for n in lengths]
    pre = np.concatenate([[0], np.cumsum(lens)]).astype(int)
    rows = []
    for i in range(pre[-1]):
        lo, hi = 0, len(lens)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if pre[mid] <= i:
                lo = mid
            else:
                hi = mid
        rows.append((lo, i - pre[lo]))
    return rows


def phase_split_bwd(xw, lengths, u, h0, out, g_out, g_ht):
    """``gru_sequence_fused_bwd`` in the kernel's phase split: every
    product and adjoint in f32 over the live rows only, outputs in xw's
    dtype, du in f32."""
    B, T, G = xw.shape
    H = G // 3
    dt = xw.dtype
    f = lambda a: a.to(torch.float32)
    u32 = f(u)
    rows = live_rows(lengths.tolist(), T)
    bi = torch.tensor([b for b, _ in rows], dtype=torch.long)
    ti = torch.tensor([t for _, t in rows], dtype=torch.long)
    n = len(rows)
    # 0. h_{t-1} of each live row, as saved (the I/O dtype)
    h_prev = torch.cat([h0[:, None], out[:, :-1]], dim=1)       # [B, T, H]
    hp = f(h_prev[bi, ti]) if n else torch.zeros(0, H)
    xl = f(xw[bi, ti]) if n else torch.zeros(0, G)
    # 1. the gates of every live row: [z|r], then c from r*h_{t-1}
    zr = torch.sigmoid(xl[:, :2 * H] + hp @ u32[:, :2 * H])
    z, r = zr[:, :H], zr[:, H:]
    rh = r * hp
    c = torch.tanh(xl[:, 2 * H:] + rh @ u32[:, 2 * H:])
    # 2. the reverse recurrence: at step t only the rows live at t
    row_of = {bt: i for i, bt in enumerate(rows)}
    dg = torch.zeros(n, G)
    dh = f(g_ht).clone()
    uz, ur, uc = u32[:, :H], u32[:, H:2 * H], u32[:, 2 * H:]
    t_max = max((t + 1 for _, t in rows), default=0)
    for t in reversed(range(t_max)):
        live = [b for b in range(B) if (b, t) in row_of]
        if not live:
            continue
        idx = torch.tensor([row_of[(b, t)] for b in live])
        lb = torch.tensor(live)
        dhp = dh[lb] + f(g_out[lb, t])
        zt, rt, ct, hpt = z[idx], r[idx], c[idx], hp[idx]
        dgz = (dhp * (ct - hpt)) * zt * (1.0 - zt)
        dgc = (dhp * zt) * (1.0 - ct * ct)
        drh = dgc @ uc.t()
        dgr = (drh * hpt) * rt * (1.0 - rt)
        dg[idx] = torch.cat([dgz, dgr, dgc], dim=1)
        dh[lb] = ((dhp * (1.0 - zt)) + drh * rt) + dgz @ uz.t() + dgr @ ur.t()
    dxw = torch.zeros(B, T, G)
    if n:
        dxw[bi, ti] = dg
    # 3. dU over the live rows, a stage of STAGE rows at a time
    du = torch.zeros(H, G)
    for s in range(0, n, STAGE):
        sl = slice(s, s + STAGE)
        du = du + torch.cat([hp[sl].t() @ dg[sl, :2 * H],
                             rh[sl].t() @ dg[sl, 2 * H:]], dim=1)
    return dxw.to(dt), dh.to(dt), du


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dname):
    for name, g, w in zip(("dxw", "dh0", "du"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        if name == "du":
            w32 = _np32(w)
            atol, rtol = 1e-5 * np.abs(w32).max(), 1e-5
        elif dname == "float32":
            atol, rtol = ATOL, RTOL
        else:
            atol, rtol = BF16_ATOL, BF16_RTOL
        np.testing.assert_allclose(_np32(g), _np32(w), atol=atol, rtol=rtol,
                                   err_msg=name)


def _case(B, T, H, lens, tdt, jdt, reverse, seed):
    """The backward's inputs for both sides in the I/O dtype: the forward's
    out from JAX (Pallas interpret); ``reverse`` hands the kernel the
    within-length flipped xw, as ``gru(reverse=True)`` does."""
    a = _inputs(B, T, H, lens, seed)
    xw = torch.from_numpy(a["xw"])
    lengths = torch.from_numpy(a["lengths"])
    if reverse:
        xw = _reverse_within_length(xw, lengths)
    xw = xw.to(tdt)
    j = lambda x: jnp.asarray(_np32(x) if isinstance(x, torch.Tensor)
                              else x, jdt)
    jl = jnp.asarray(a["lengths"])
    jx, ju, jh0 = j(xw), j(a["u"]), j(a["h0"])
    out, _ = pk.gru_sequence_fused(jx, jl, ju, h0=jh0, interpret=True)
    jcot = (j(a["g_out"]), j(a["g_ht"]))
    t = lambda x: torch.from_numpy(np.array(_np32(x))).to(tdt)
    targs = (xw, lengths, t(a["u"]), t(a["h0"]), t(out), t(a["g_out"]),
             t(a["g_ht"]))
    return (jx, jl, ju, jh0, out) + jcot, targs


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dname,tdt,jdt", DTYPES)
@pytest.mark.parametrize("B,T,H,lens", CASES)
def test_phase_split_matches_pallas_interpret(B, T, H, lens, dname, tdt,
                                              jdt, reverse):
    jargs, targs = _case(B, T, H, lens, tdt, jdt, reverse, seed=3)
    want = pk.gru_sequence_fused_bwd(*jargs, block_b=8, interpret=True)
    got = phase_split_bwd(*targs)
    assert [g.dtype for g in got] == [tdt, tdt, torch.float32]
    _check(got, want, dname)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dname,tdt,jdt", DTYPES)
@pytest.mark.parametrize("B,T,H,lens", CASES)
def test_phase_split_matches_the_plain_version(B, T, H, lens, dname, tdt,
                                               jdt, reverse):
    """The kernel's phase split and the port's plain version (the
    reference's one loop over all rows and steps) agree to summation
    order."""
    _, targs = _case(B, T, H, lens, tdt, jdt, reverse, seed=4)
    want = rk.gru_sequence_fused_bwd(*targs)
    _check(phase_split_bwd(*targs), want, dname)


def test_phase_split_skips_dead_rows_exactly():
    """A sample of length 0 passes its cotangent through unchanged and gets
    zero dxw at every step; a sample's steps at or past its length get
    zero dxw."""
    _, targs = _case(5, 7, 12, [0, 1, 7, 3, 5], torch.float32, jnp.float32,
                     False, seed=5)
    dxw, dh0, _ = phase_split_bwd(*targs)
    assert not dxw[0].any()
    assert torch.equal(dh0[0], targs[-1][0])
    for b, n in enumerate([0, 1, 7, 3, 5]):
        assert not dxw[b, n:].any()


def test_live_rows_are_compacted_sample_by_sample():
    """The binary search of the kernel's compaction (the last sample whose
    prefix is <= i) gives each live (b, t) once, in order, with samples of
    length 0 and lengths past T (clamped) among them."""
    lens = [0, 3, 0, 0, 1, 5, 9, 0]
    T = 5
    want = [(b, t) for b, n in enumerate(lens) for t in range(min(n, T))]
    assert live_rows(lens, T) == want
    assert live_rows([0, 0], T) == []
