"""Recurrent sequence kernels — the counterpart of the LSTM and GRU bodies
of ``paddle_tpu/ops/pallas_kernels.py``:

* :func:`lstm_sequence_fused` replaces ``_lstm_seq_kernel`` (inference
  forward) and, with ``save_cell=True``, ``_lstm_seq_train_kernel`` (the
  training forward, which also saves the cell sequence);
* :func:`lstm_sequence_fused_bwd` replaces ``_lstm_seq_bwd_kernel`` (the
  reverse recurrence of the backward);
* :func:`gru_sequence_fused` replaces ``_gru_seq_kernel`` (the GRU
  forward, in training and inference alike: its backward needs only the
  outputs);
* :func:`gru_sequence_fused_bwd` replaces ``_gru_seq_bwd_kernel``.

Each wrapper launches its hand-written CUDA kernel (``csrc/lstm_seq.cu``,
``csrc/lstm_seq_bwd.cu``, ``csrc/gru_seq.cu``, ``csrc/gru_seq_bwd.cu``)
for tensors on the card and takes the plain
PyTorch version beside it for tensors on the CPU, or when a caller asks
with ``route="plain"``. A kernel runs the whole sequence in one launch
and carries h and c in f32 from the first step to the last; the JAX
wrappers' ``chunk_t`` tiles time for VMEM and has no counterpart here
(in bf16 it rounds h and c to bf16 at each chunk boundary, which the
port never does), and their ``block_b`` is the row tile of the routes
below.

The plain versions follow the op order of the JAX kernel bodies: all
arithmetic in f32, stores in the input dtype; LSTM gates i, f, g, o with
``forget_bias`` added to f before the sigmoid; GRU gates z, r, candidate
with U packed [u_z | u_r | u_c] and the bias added to xw before the
recurrence; step t of sample b is live when ``t < lengths[b]``, and a dead
step freezes the state and outputs 0. Launches are counted in
``cuda_kernels.LAUNCHES`` under ``lstm_seq``, ``lstm_seq_train``,
``lstm_seq_bwd``, ``gru_seq`` and ``gru_seq_bwd``.

Every kernel keeps its whole grid resident (grid barriers every step),
so each has a batch limit, and a call is routed by :func:`plan_route`
from the shape and the card's SMs and shared memory before anything is
launched: "whole" (one launch), "tiles" (one launch for each tile of the
most rows that fit, in row order; the backwards sum the tiles' dU
partials in f32 in tile order) or "scan" (no tile fits: ``ops/rnn.py``
runs the step loop, as JAX takes ``_lstm_scan`` where no VMEM plan
fits). ``cuda_kernels.ROUTES`` counts the routes taken. A launch that
fails raises; nothing steps down to the plain versions. The backwards take fixed partitions: #10 4
hidden units x 32 batch rows a block, #12 8 x 32. The forwards (#8, #9,
#11) take a plan from :func:`forward_plan`: ``units`` (8 or 16) hidden
units x ``rows`` (8, 16 or 32) batch rows a block, one warp or a pair of
warps (``parts``) for each 4 rows (2 in the LSTM's 16-unit blocks), the
plan whose grid fits one wave at the least modelled cost a step on the
busiest SM; a hidden width that is not a multiple of the units masks the
tail units.
On an H100 (132 SMs, 227 KB a block) the LSTM forwards take B <= 256 at
H = 256, B <= 128 at H = 512 and no B at H = 1280 (no 8-unit block fits
two an SM); the GRU forward takes B <= 528 at H = 256, B <= 256 at H =
512 and B <= 64 at H = 1024. That is every (B, H) the 4-unit x 32-row
forwards they replace took, but the LSTM's at H = 4 past B = 8448 (those
took 3 blocks of 256 threads an SM; these plan for 2). Handed straight
to a kernel, a shape past its limit raises ``ValueError`` ("split the
batch"), as does a hidden width that is not a multiple of 4 (which the
planner routes to the scan).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .cuda_kernels import (LAUNCHES, ROUTES, _DTYPE_CODE, _check_float,
                           _opaque,
                           _raise_on, _route, _stream)

#: the kernels give each block a multiple of this many hidden units: H
#: must be a multiple
KERNEL_HIDDEN_MULTIPLE = 4
#: the C entries' code when the grid does not fit in one wave of the card,
#: or a block's slice of U does not fit its shared memory
#: (cudaErrorCooperativeLaunchTooLarge)
_TOO_LARGE = 720


# ---------------------------------------------------------------------------
# the forwards' plans
# ---------------------------------------------------------------------------

#: hidden units and batch rows a block of a forward kernel may take, and
#: the warps that may share a product's k (csrc/recur.cuh KSplit)
FORWARD_UNITS = (8, 16)
FORWARD_ROWS = (8, 16, 32)
FORWARD_PARTS = (1, 2)
#: an H100 SXM: SMs, and the shared memory a block may opt in to
H100 = (132, 232448)
#: the forwards' gates and state exchanges a step
_FORWARD_KINDS = {"lstm": (4, 1), "gru": (3, 2)}


def rows_a_warp(kind: str, units: int) -> int:
    """Batch rows a warp of a forward kernel takes (csrc/recur.cuh): 4,
    but 2 for the LSTM's 16-unit blocks (a lane's 64 accumulators)."""
    return 2 if (kind, units) == ("lstm", 16) else 4


class ForwardPlan(NamedTuple):
    """A forward kernel's launch: ``units`` x ``rows`` a block, ``grid``
    (ceil(H / units), ceil(B / rows)) blocks of ``threads`` (``parts``
    warps for each :func:`rows_a_warp` rows, sharing the products' k) with
    ``smem`` bytes of shared memory (U's gate columns of the block's
    units, f32, and 512 bytes a pair of warps where parts is 2),
    ``per_sm`` blocks on the busiest SM."""
    units: int
    rows: int
    parts: int
    grid: Tuple[int, int]
    per_sm: int
    threads: int
    smem: int
    cost: float


#: the cycles a pair of warps takes to add its sums (KSplit)
_PAIR = 300
#: the cycles a step's product waits for L2 each time its ring of row
#: loads runs dry (the ring holds 16 / rows-a-warp column steps of 64 in
#: the bodies for one block an SM, 8 / rows-a-warp in those for two or
#: more)
_L2_WAIT = 1000


def _blocks_an_sm(threads: int, smem: int, smem_optin: int) -> int:
    """Blocks of one forward kernel an SM holds at once: the bodies a
    grid of more blocks than SMs launches are compiled for at most 128
    registers a thread (``__launch_bounds__(256, 2)``), so 512 threads an
    SM (a grid of at most one block an SM takes the bodies compiled for
    255); Hopper gives each block 1 KB of shared memory beyond its own,
    out of ``smem_optin`` + 1 KB an SM; at most 32 blocks."""
    return min(512 // threads, (smem_optin + 1024) // (smem + 1024), 32)


def forward_plans(kind: str, B: int, H: int, sms: int = H100[0],
                  smem_optin: int = H100[1]) -> List[ForwardPlan]:
    """Every plan of the ``kind`` ("lstm": #8, #9; "gru": #11) forward
    whose grid fits the card in one wave, cheapest first.

    The cost counts the busiest SM's work a step, in cycles of an SM:
    its FMAs (the blocks' rows, at most B, x units x gates x H) at 32 a
    cycle on each of the 4 schedulers that has a warp with a row, or at
    32 x rows a warp a cycle where shared memory bounds them (a lane's
    16-byte load of U feeds 4 x rows-a-warp FMAs, at 8 such loads a
    cycle), stretched by up to 2x where fewer than 8 warps hide the
    latencies; _L2_WAIT each time an exchange's ring of row loads runs
    dry; and the bytes it reads from L2 (rows x H x 4 an exchange; the
    GRU has two a step) at 64 a cycle. (Weights fitted to the H100
    sweep of ``chip_smoke.py --rnn-sweep``: the L2 round trips after a
    grid barrier and the latency-bound products lead; the bytes follow.)
    Ties go to fewer blocks (fewer at each grid barrier), then to less
    shared memory and fewer threads. An H that is not a multiple of 4 has
    no plan."""
    gates, exchanges = _FORWARD_KINDS[kind]
    if B <= 0 or H <= 0 or H % KERNEL_HIDDEN_MULTIPLE:
        return []
    plans = []
    steps = -(-H // 64)                         # column steps of 64 k
    for units, rows, parts in itertools.product(
            FORWARD_UNITS, FORWARD_ROWS, FORWARD_PARTS):
        rl = rows_a_warp(kind, units)
        threads = 32 * parts * rows // rl
        smem = gates * 64 * steps * units * 4 + (threads // 64 * 512
                                                 if parts == 2 else 0)
        if threads > 256 or smem > smem_optin:
            continue
        grid = (-(-H // units), -(-B // rows))
        blocks = grid[0] * grid[1]
        if blocks > sms * _blocks_an_sm(threads, smem, smem_optin):
            continue
        per_sm = -(-blocks // sms)
        live = per_sm * min(rows, B)
        fma = live * min(units, H) * gates * H
        warps = per_sm * parts * -(-min(rows, B) // rl)   # with a live row
        ring = (16 if per_sm == 1 else 8) // rl * parts
        issue = max(fma / (32 * min(4, warps)), fma / (32 * rl))
        cost = (issue * (2 - min(warps, 8) / 8)
                + exchanges * (-(-steps // ring) * _L2_WAIT
                               + (_PAIR if parts == 2 else 0))
                + live * H * 4 * exchanges / 64)
        plans.append(ForwardPlan(units, rows, parts, grid, per_sm, threads,
                                 smem, cost))
    return sorted(plans, key=lambda p: (p.cost, p.grid[0] * p.grid[1],
                                        p.smem, p.threads))


def forward_plan(kind: str, B: int, H: int, sms: int = H100[0],
                 smem_optin: int = H100[1]) -> Optional[ForwardPlan]:
    """The plan the ``kind`` forward launches with (:func:`forward_plans`'
    cheapest), or None where no grid fits: split the batch."""
    plans = forward_plans(kind, B, H, sms, smem_optin)
    return plans[0] if plans else None


@functools.lru_cache(maxsize=None)
def card_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of card ``index``."""
    import ctypes
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.load().lib.paddle_card_limits(ctypes.byref(sms),
                                                   ctypes.byref(smem))
    _raise_on(err, "card_limits")
    return sms.value, smem.value


def _card_plan(kind: str, name: str, xw: torch.Tensor, B: int,
               H: int) -> ForwardPlan:
    plan = forward_plan(kind, B, H, *card_limits(xw.device.index or 0))
    if plan is None:
        _raise_launch(_TOO_LARGE, name, B, H)
    return plan


# ---------------------------------------------------------------------------
# routes: one launch, a launch per row tile, or the step loop
# ---------------------------------------------------------------------------

#: the kernel family of each wrapper's count name
KERNEL_KINDS = {"lstm_seq": "lstm", "lstm_seq_train": "lstm",
                "lstm_seq_bwd": "lstm_bwd", "gru_seq": "gru",
                "gru_seq_bwd": "gru_bwd"}
#: the backwards' fixed partitions (csrc/lstm.cuh, csrc/gru_seq_bwd.cu):
#: hidden units and batch rows a block of 256 threads, and the blocks an
#: SM their launch bounds leave room for (#10: 128 registers a thread,
#: two; #12: up to 255, one). This, _lstm_bwd_smem and _gru_bwd_smem
#: repeat the C side's layouts; the card test
#: test_bwd_planner_meets_the_kernels_limit_on_card holds them together.
_BWD_BLOCK = {"lstm_bwd": (4, 32, 2), "gru_bwd": (8, 32, 1)}


def _lstm_bwd_smem(H: int, itemsize: int, budget: int) -> int:
    """The LSTM backward's dynamic shared memory (``make_plan`` of
    csrc/lstm_seq_bwd.cu): the phases' layouts at the most steps a stage
    (4, 2, 1) that fit ``budget``."""
    hp = -(-H // 16) * 16
    ldh, ldx, cols = hp + 4, hp + (4 if itemsize == 4 else 8), 16
    ut = cols * ldh * 4
    ns = 4
    while True:
        rows = 32 * ns
        stage = rows * ldx * itemsize
        p1 = ut + 2 * stage + 8192
        p3 = 2 * (stage + rows * (cols + 4) * 4)
        if ns == 1 or (p1 <= budget and p3 <= budget):
            break
        ns //= 2
    p2 = (hp + 32) * (cols + 4) * 4
    return 32 * 4 + max(p1, p2, p3)


def _gru_bwd_smem(B: int, H: int) -> int:
    """The GRU backward's dynamic shared memory (``bwd_smem_bytes`` of
    csrc/gru_seq_bwd.cu): the rows' lengths, then the larger of two
    stages of 64 x 64 tiles and U's rows of a block's units."""
    head = -(-(B + 2) * 4 // 16) * 16
    stages = 2 * (64 * 68 * 4 + 64 * 72 * 4)
    return head + max(stages, 3 * -(-H // 64) * 128 * 16)


def _bwd_fits(kind: str, B: int, H: int, itemsize: int, sms: int,
              smem_optin: int) -> bool:
    """Whether a backward's grid for B rows is resident at once (the
    check ``launch_cooperative`` of csrc/lstm.cuh makes on the card)."""
    units, rows, bound = _BWD_BLOCK[kind]
    if B <= 0 or H <= 0 or H % KERNEL_HIDDEN_MULTIPLE:
        return False
    blocks = -(-H // units) * -(-B // rows)
    if kind == "lstm_bwd":
        smem = _lstm_bwd_smem(H, itemsize,
                              110 * 1024 if blocks > sms else 200 * 1024)
    else:
        smem = _gru_bwd_smem(B, H)
    if smem > smem_optin:
        return False
    per_sm = min(bound, (smem_optin + 1024) // (smem + 1024))
    return blocks <= per_sm * sms


class Route(NamedTuple):
    """How one call of a recurrent kernel runs: ``kind`` "whole" (one
    launch over the batch), "tiles" (one launch for each contiguous row
    range ``(first row, rows)`` of ``tiles``, in row order) or "scan" (no
    tile fits: the caller runs the step loop); ``plans`` holds each
    tile's forward plan (None for a backward)."""
    kind: str
    tiles: Tuple[Tuple[int, int], ...]
    plans: Tuple[Optional[ForwardPlan], ...]


@functools.lru_cache(maxsize=4096)
def plan_route(name: str, B: int, H: int, dtype: torch.dtype = torch.float32,
               sms: int = H100[0], smem_optin: int = H100[1]) -> Route:
    """The route of kernel ``name`` (a ``LAUNCHES`` name of this module)
    for B rows of hidden width H in ``dtype`` on a card of ``sms`` SMs and
    ``smem_optin`` bytes of shared memory a block — the counterpart of the
    JAX wrappers' ``_fused_plan`` / ``_fused_bwd_plan``, with the card's
    residency in place of VMEM. "whole" where the grid of all B rows fits
    at once; else "tiles" of the most rows whose grid fits (as JAX takes
    the widest ``block_b``), the last tile holding the rest; else
    "scan". A pure function of its arguments: nothing is tried on the
    card."""
    kind = KERNEL_KINDS[name]
    if kind in _FORWARD_KINDS:
        plan_of = lambda b: forward_plan(kind, b, H, sms, smem_optin)
        fits = lambda b: plan_of(b) is not None
    else:
        itemsize = torch.empty((), dtype=dtype).element_size()
        plan_of = lambda b: None
        fits = lambda b: _bwd_fits(kind, b, H, itemsize, sms, smem_optin)
    if B <= 0 or fits(B):
        return Route("whole", ((0, B),), (plan_of(B),))
    lo, hi = 0, B                       # fits(lo) (or lo = 0), not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    if lo == 0:
        return Route("scan", (), ())
    tiles = tuple((r, min(lo, B - r)) for r in range(0, B, lo))
    return Route("tiles", tiles, tuple(plan_of(n) for _, n in tiles))


_FORCED: List[Tuple[int, int]] = []


@contextlib.contextmanager
def forced_limits(sms: int, smem_optin: int):
    """Plan every call inside the block, on the CPU too, for a card of
    ``sms`` SMs and ``smem_optin`` bytes of shared memory a block (on the
    CPU each tile then runs the kernels' plain versions): how tests drive
    the tiled and scan routes at small shapes."""
    _FORCED.append((sms, smem_optin))
    try:
        yield
    finally:
        _FORCED.pop()


def limits_for(device: torch.device) -> Optional[Tuple[int, int]]:
    """The limits the planner takes for tensors on ``device``: forced ones
    (:func:`forced_limits`), else the card's, else None (a CPU call runs
    the plain versions over the whole batch, unplanned)."""
    if _FORCED:
        return _FORCED[-1]
    if device.type == "cuda":
        return card_limits(device.index if device.index is not None
                           else torch.cuda.current_device())
    return None


def route_for(name: str, xw: torch.Tensor, H: int,
              route: Optional[str] = None) -> Optional[Route]:
    """The planner's route for a call of ``name`` on xw's rows, or None
    for an unplanned call (``route="plain"``, or the CPU with no forced
    limits)."""
    if route == "plain":
        return None
    lim = limits_for(xw.device)
    if lim is None:
        return None
    return plan_route(name, xw.shape[0], H, xw.dtype, *lim)


def count_route(name: str, kind: str) -> None:
    ROUTES[(name, kind)] = ROUTES.get((name, kind), 0) + 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels take it: itself where contiguous and 16-byte
    aligned, else a fresh (aligned) copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _run_tiles(rt: Route, ins, outs, one) -> None:
    """Run ``one(tile inputs, tile outputs, plan)`` for each tile of
    ``rt`` in row order over the rows of the row-indexed tensors ``ins``
    and ``outs`` (written in place; a tile view that breaks the 16-byte
    rule is computed into an aligned copy and copied back)."""
    for (r0, n), plan in zip(rt.tiles, rt.plans):
        views = [t[r0:r0 + n] for t in outs]
        touts = [_aligned(v) for v in views]
        one([_aligned(t[r0:r0 + n]) for t in ins], touts, plan)
        for v, t in zip(views, touts):
            if t is not v:
                v.copy_(t)


def _no_scan(rt: Route, name: str, B: int, H: int) -> None:
    if H % KERNEL_HIDDEN_MULTIPLE:
        raise ValueError(f"{name}: hidden width {H} not taken by the kernel "
                         f"(a multiple of {KERNEL_HIDDEN_MULTIPLE}); the step "
                         "loop takes it (ops.rnn.lstm / ops.rnn.gru)")
    if rt.kind == "scan":
        raise ValueError(
            f"{name}: B={B}, H={H}: no row tile's grid is resident on the "
            "card at once; the step loop takes this shape (ops.rnn.lstm / "
            "ops.rnn.gru route it there)")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _defaults(xw, lengths, u, b, h0, c0):
    """Fill the optional arguments as the JAX wrapper does: zero bias and
    zero initial state in xw's dtype, lengths on xw's device."""
    B, T, G = xw.shape
    if G % 4:
        raise ValueError(f"xw last dim {G} must be 4*H (i/f/g/o gates)")
    H = G // 4
    if u.shape != (H, G):
        raise ValueError(f"u {tuple(u.shape)} is not [{H}, {G}]")
    z = lambda *shape: torch.zeros(shape, dtype=xw.dtype, device=xw.device)
    b = z(G) if b is None else b
    h0 = z(B, H) if h0 is None else h0
    c0 = z(B, H) if c0 is None else c0
    return lengths.to(xw.device), b, h0, c0


# ---------------------------------------------------------------------------
# forward (replaces _lstm_seq_kernel and _lstm_seq_train_kernel)
# ---------------------------------------------------------------------------

@_opaque
def lstm_sequence_fused_plain(xw, lengths, u, b, h0, c0, *,
                              forget_bias: float, save_cell: bool):
    """The op order of ``_lstm_seq_kernel`` / ``_lstm_seq_train_kernel``
    over [B, T, *] tensors: (out, hT, cT[, c_seq]) in xw's dtype."""
    B, T, G = xw.shape
    H = G // 4
    dt = xw.dtype
    u32, bias = _f32(u), _f32(b)
    lens = _f32(lengths)[:, None]
    h, c = _f32(h0), _f32(c0)
    outs, cells = [], []
    for t in range(T):
        gates = _f32(xw[:, t]) + h @ u32 + bias
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H] + forget_bias)
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = (t < lens).to(torch.float32)
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outs.append((m * h).to(dt))
        if save_cell:
            cells.append(c.to(dt))
    res = (torch.stack(outs, dim=1), h.to(dt), c.to(dt))
    return res + (torch.stack(cells, dim=1),) if save_cell else res


def _check_lstm_args(name, xw, lengths, u, b, h0, c0, extra=()):
    """What the LSTM kernels take (see :func:`_check_args`)."""
    B, T, G = xw.shape
    H = G // 4
    return _check_args(name, xw, lengths, H, [
        ("u", u, (H, G)), ("b", b, (G,)), ("h0", h0, (B, H)),
        ("c0", c0, (B, H))] + list(extra))


def _check_args(name, xw, lengths, H, shapes):
    """What the kernels take: contiguous, 16-byte aligned f32 or bf16
    tensors of xw's dtype with the (name, tensor, shape) ``shapes``, H a
    multiple of KERNEL_HIDDEN_MULTIPLE, lengths [B]. Returns the lengths
    as contiguous int32."""
    B, T, G = xw.shape
    if H % KERNEL_HIDDEN_MULTIPLE:
        raise ValueError(f"{name}: hidden width {H} not taken by the kernel "
                         f"(a multiple of {KERNEL_HIDDEN_MULTIPLE})")
    for arg, t, shape in [("xw", xw, (B, T, G))] + list(shapes):
        _check_float(f"{name} {arg}", t, xw.dtype)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"{list(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte "
                             "aligned")
    if lengths.shape != (B,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} != ({B},)")
    return lengths.to(dtype=torch.int32).contiguous()


def _raise_launch(err: int, name: str, B: int, H: int) -> None:
    if err == _TOO_LARGE:
        raise ValueError(
            f"{name}: B={B}, H={H} needs more blocks, or more shared memory "
            "per block, than the card holds at once (the kernel's grid "
            "barrier needs every block resident); split the batch")
    _raise_on(err, name)


def _lstm_outs(xw, save_cell):
    B, T, G = xw.shape
    H = G // 4
    out = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    h_t = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    c_t = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    return (out, h_t, c_t) + ((torch.empty_like(out),) if save_cell else ())


def _lstm_sequence_fused_kernel(xw, lengths, u, b, h0, c0, forget_bias,
                                save_cell, plan=None, outs=None):
    B, T, G = xw.shape
    H = G // 4
    name = "lstm_seq_train" if save_cell else "lstm_seq"
    lens = _check_lstm_args("lstm_sequence_fused", xw, lengths, u, b, h0, c0)
    res = tuple(outs) if outs is not None else _lstm_outs(xw, save_cell)
    out, h_t, c_t = res[:3]
    c_seq = res[3] if save_cell else None
    if B == 0 or T == 0:
        h_t.copy_(h0)
        c_t.copy_(c0)
        return res
    plan = plan or _card_plan("lstm", name, xw, B, H)
    h_x = torch.empty((2, B, H), dtype=torch.float32, device=xw.device)
    lib = _build.load().lib
    entry = lib.paddle_lstm_seq_train if save_cell else lib.paddle_lstm_seq
    args = [xw.data_ptr(), lens.data_ptr(), u.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr()]
    if save_cell:
        args.append(c_seq.data_ptr())
    with torch.cuda.device(xw.device):
        err = entry(*args, h_x.data_ptr(), B, T, H, float(forget_bias),
                    plan.units, plan.rows, plan.parts, _DTYPE_CODE[xw.dtype],
                    _stream(xw.device))
    _raise_launch(err, name, B, H)
    LAUNCHES[name] += 1
    return res


def lstm_sequence_fused(xw: torch.Tensor, lengths: torch.Tensor,
                        u: torch.Tensor, b: Optional[torch.Tensor] = None,
                        h0: Optional[torch.Tensor] = None,
                        c0: Optional[torch.Tensor] = None, *,
                        forget_bias: float = 0.0, save_cell: bool = False,
                        route: Optional[str] = None,
                        plan: Optional[Route] = None):
    """Masked LSTM over a whole sequence — the
    ``pallas_kernels.lstm_sequence_fused`` contract: xw = x@W [B, T, 4H],
    lengths [B] int, u [H, 4H], b [4H], h0/c0 [B, H] (zeros when None) ->
    (out [B, T, H], hT [B, H], cT [B, H]) in xw's dtype, plus the
    post-mask cell sequence c_seq [B, T, H] when ``save_cell`` (the
    residual :func:`lstm_sequence_fused_bwd` consumes).

    On the card the call takes the route of :func:`plan_route` (``plan``
    where the caller decided it already): one launch, or one launch for
    each row tile, each writing its rows of the outputs; a shape no tile
    of takes raises (``ops.rnn.lstm`` runs the step loop there)."""
    lengths, b, h0, c0 = _defaults(xw, lengths, u, b, h0, c0)
    name = "lstm_seq_train" if save_cell else "lstm_seq"
    kernel = _route(route, xw, lengths, u, b, h0, c0) == "kernel"
    rt = plan if plan is not None else route_for(name, xw, u.shape[0], route)
    if rt is None:
        return lstm_sequence_fused_plain(xw, lengths, u, b, h0, c0,
                                         forget_bias=forget_bias,
                                         save_cell=save_cell)
    _no_scan(rt, name, xw.shape[0], u.shape[0])
    count_route(name, rt.kind)
    if kernel and rt.kind == "whole":
        return _lstm_sequence_fused_kernel(xw, lengths, u, b, h0, c0,
                                           forget_bias, save_cell,
                                           rt.plans[0])
    outs = _lstm_outs(xw, save_cell)

    def one(tin, touts, tplan):
        if kernel:
            _lstm_sequence_fused_kernel(*tin[:2], u, b, *tin[2:],
                                        forget_bias, save_cell, tplan, touts)
            return
        got = lstm_sequence_fused_plain(*tin[:2], u, b, *tin[2:],
                                        forget_bias=forget_bias,
                                        save_cell=save_cell)
        for o, g in zip(touts, got):
            o.copy_(g)

    _run_tiles(rt, [xw, lengths, h0, c0], outs, one)
    return outs


# ---------------------------------------------------------------------------
# backward (replaces _lstm_seq_bwd_kernel)
# ---------------------------------------------------------------------------

@_opaque
def lstm_sequence_fused_bwd_plain(xw, lengths, u, b, h0, c0, out_seq, c_seq,
                                  g_out, g_ht, g_ct, *, forget_bias: float):
    """The op order of ``_lstm_seq_bwd_kernel``: gates recomputed from xw
    and the saved masked output (h0 at t = 0), the adjoints in f32, dU
    summed over steps in f32. -> (dxw [B, T, 4H], dh0, dc0 [B, H]) in xw's
    dtype and du [H, 4H] f32."""
    B, T, G = xw.shape
    H = G // 4
    dt = xw.dtype
    u32, bias = _f32(u), _f32(b)
    lens = _f32(lengths)[:, None]
    h0, c0 = _f32(h0), _f32(c0)
    dh, dc = _f32(g_ht), _f32(g_ct)
    du = torch.zeros((H, G), dtype=torch.float32, device=xw.device)
    dxw = torch.empty_like(xw)
    for t in reversed(range(T)):
        h_prev = _f32(out_seq[:, t - 1]) if t > 0 else h0
        c_prev = _f32(c_seq[:, t - 1]) if t > 0 else c0
        gates = _f32(xw[:, t]) + h_prev @ u32 + bias
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H] + forget_bias)
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_cur = f * c_prev + i * g
        tc = torch.tanh(c_cur)
        m = (t < lens).to(torch.float32)
        dh_t = dh + m * _f32(g_out[:, t])
        dhp = m * dh_t
        dct = m * dc + dhp * o * (1.0 - tc * tc)
        do_ = dhp * tc
        dgi = (dct * g) * i * (1.0 - i)
        dgf = (dct * c_prev) * f * (1.0 - f)
        dgg = (dct * i) * (1.0 - g * g)
        dgo = do_ * o * (1.0 - o)
        dgates = torch.cat([dgi, dgf, dgg, dgo], dim=1)
        dxw[:, t] = dgates.to(dt)
        du = du + h_prev.t() @ dgates
        dh = (1.0 - m) * dh_t + dgates @ u32.t()
        dc = (1.0 - m) * dc + dct * f
    return dxw, dh.to(dt), dc.to(dt), du


def _lstm_sequence_fused_bwd_kernel(xw, lengths, u, b, h0, c0, out_seq, c_seq,
                                    g_out, g_ht, g_ct, forget_bias,
                                    outs=None):
    B, T, G = xw.shape
    H = G // 4
    seq, vec = (B, T, H), (B, H)
    lens = _check_lstm_args(
        "lstm_sequence_fused_bwd", xw, lengths, u, b, h0, c0,
        [("out_seq", out_seq, seq), ("c_seq", c_seq, seq),
         ("g_out", g_out, seq), ("g_ht", g_ht, vec), ("g_ct", g_ct, vec)])
    dxw, dh0, dc0 = outs if outs is not None else (
        torch.empty_like(xw),
        torch.empty((B, H), dtype=xw.dtype, device=xw.device),
        torch.empty((B, H), dtype=xw.dtype, device=xw.device))
    du = torch.empty((H, G), dtype=torch.float32, device=xw.device)
    if B == 0 or T == 0:
        dh0.copy_(g_ht)
        dc0.copy_(g_ct)
        du.zero_()
        return dxw, dh0, dc0, du
    lib = _build.load().lib
    tiles = -(-B // lib.paddle_lstm_batch_tile())
    # f32 scratch: the recomputed gates of every step [T, B, 4H], which the
    # kernel overwrites with the gate cotangents; the blocks' partials of
    # dh, two steps' worth [2, H / 4, B, H]; the batch tiles' dU partials
    f32 = dict(dtype=torch.float32, device=xw.device)
    gates = torch.empty((T, B, G), **f32)
    dh_part = torch.empty((2, H // 4, B, H), **f32)
    du_part = torch.empty((tiles, H, G), **f32) if tiles > 1 else None
    with torch.cuda.device(xw.device):
        err = lib.paddle_lstm_seq_bwd(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out_seq.data_ptr(),
            c_seq.data_ptr(), g_out.data_ptr(), g_ht.data_ptr(),
            g_ct.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            du.data_ptr(), gates.data_ptr(), dh_part.data_ptr(),
            None if du_part is None else du_part.data_ptr(), B, T, H,
            float(forget_bias), _DTYPE_CODE[xw.dtype], _stream(xw.device))
    _raise_launch(err, "lstm_seq_bwd", B, H)
    LAUNCHES["lstm_seq_bwd"] += 1
    return dxw, dh0, dc0, du


def _tiled_bwd(rt: Route, ins, outs, run) -> torch.Tensor:
    """A backward over the tiles of ``rt``: ``run(tile inputs, tile
    outputs)`` writes each tile's rows of ``outs`` and returns its dU
    partial [H, G] f32; the partials are summed in f32 in tile order (no
    atomics: the same inputs give the same bits)."""
    parts = []
    _run_tiles(rt, ins, outs, lambda tin, touts, _: parts.append(
        run(tin, touts)))
    du = parts[0]
    for p in parts[1:]:
        du = du + p
    return du


def lstm_sequence_fused_bwd(xw, lengths, u, b, h0, c0, out_seq, c_seq, g_out,
                            g_ht, g_ct, *, forget_bias: float = 0.0,
                            route: Optional[str] = None,
                            plan: Optional[Route] = None):
    """Backward of :func:`lstm_sequence_fused` from its ``save_cell``
    residuals — the ``pallas_kernels.lstm_sequence_fused_bwd`` contract:
    -> (dxw [B, T, 4H], dh0 [B, H], dc0 [B, H]) in xw's dtype and
    du [H, 4H] f32. Routed as the forward; on the "tiles" route each
    tile's dU partial is summed in tile order."""
    lengths = lengths.to(xw.device)
    kernel = _route(route, xw, lengths, u, b, h0, c0, out_seq, c_seq, g_out,
                    g_ht, g_ct) == "kernel"
    rt = (plan if plan is not None
          else route_for("lstm_seq_bwd", xw, u.shape[0], route))
    if rt is None:
        return lstm_sequence_fused_bwd_plain(
            xw, lengths, u, b, h0, c0, out_seq, c_seq, g_out, g_ht, g_ct,
            forget_bias=forget_bias)
    _no_scan(rt, "lstm_seq_bwd", xw.shape[0], u.shape[0])
    count_route("lstm_seq_bwd", rt.kind)
    if kernel and rt.kind == "whole":
        return _lstm_sequence_fused_bwd_kernel(xw, lengths, u, b, h0, c0,
                                               out_seq, c_seq, g_out, g_ht,
                                               g_ct, forget_bias)
    B, H = xw.shape[0], u.shape[0]
    outs = (torch.empty_like(xw),
            torch.empty((B, H), dtype=xw.dtype, device=xw.device),
            torch.empty((B, H), dtype=xw.dtype, device=xw.device))

    def run(tin, touts):
        xw_, len_, h0_, c0_, *rest = tin
        if kernel:
            return _lstm_sequence_fused_bwd_kernel(
                xw_, len_, u, b, h0_, c0_, *rest, forget_bias, touts)[3]
        got = lstm_sequence_fused_bwd_plain(xw_, len_, u, b, h0_, c0_, *rest,
                                            forget_bias=forget_bias)
        for o, g in zip(touts, got):
            o.copy_(g)
        return got[3]

    du = _tiled_bwd(rt, [xw, lengths, h0, c0, out_seq, c_seq, g_out, g_ht,
                         g_ct], outs, run)
    return outs + (du,)


# ---------------------------------------------------------------------------
# GRU forward (replaces _gru_seq_kernel)
# ---------------------------------------------------------------------------

def _gru_gates(xw_t, h, u32, H):
    """z, r, r*h and c of one step in the JAX kernel body's op order (f32;
    u32 packed [u_z | u_r | u_c], the bias already in xw_t)."""
    z = torch.sigmoid(xw_t[:, :H] + h @ u32[:, :H])
    r = torch.sigmoid(xw_t[:, H:2 * H] + h @ u32[:, H:2 * H])
    rh = r * h
    c = torch.tanh(xw_t[:, 2 * H:] + rh @ u32[:, 2 * H:])
    return z, r, rh, c


@_opaque
def gru_sequence_fused_plain(xw, lengths, u, h0):
    """The op order of ``_gru_seq_kernel`` over [B, T, 3H] tensors (the
    bias already added to xw): (out [B, T, H], hT [B, H]) in xw's dtype,
    h carried in f32."""
    B, T, G = xw.shape
    H = G // 3
    dt = xw.dtype
    u32 = _f32(u)
    lens = _f32(lengths)[:, None]
    h = _f32(h0)
    outs = []
    for t in range(T):
        z, _, _, c = _gru_gates(_f32(xw[:, t]), h, u32, H)
        h_new = (1.0 - z) * h + z * c
        m = (t < lens).to(torch.float32)
        h = m * h_new + (1.0 - m) * h
        outs.append((m * h).to(dt))
    return torch.stack(outs, dim=1), h.to(dt)


def _gru_shapes(xw, u):
    B, T, G = xw.shape
    if G % 3:
        raise ValueError(f"xw last dim {G} must be 3*H (z/r/candidate gates)")
    H = G // 3
    if tuple(u.shape) != (H, G):
        raise ValueError(f"u {tuple(u.shape)} is not [{H}, {G}]")
    return B, T, H


def _gru_outs(xw, H):
    B, T, _ = xw.shape
    return (torch.empty((B, T, H), dtype=xw.dtype, device=xw.device),
            torch.empty((B, H), dtype=xw.dtype, device=xw.device))


def _gru_sequence_fused_kernel(xw, lengths, u, h0, plan=None, outs=None):
    B, T, H = _gru_shapes(xw, u)
    lens = _check_args("gru_sequence_fused", xw, lengths, H,
                       [("u", u, (H, 3 * H)), ("h0", h0, (B, H))])
    out, h_t = outs if outs is not None else _gru_outs(xw, H)
    if B == 0 or T == 0:
        h_t.copy_(h0)
        return out, h_t
    plan = plan or _card_plan("gru", "gru_seq", xw, B, H)
    # the two f32 exchanges of the grid: h and r*h of every unit
    h_x = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    rh_x = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    lib = _build.load().lib
    with torch.cuda.device(xw.device):
        err = lib.paddle_gru_seq(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), h0.data_ptr(),
            out.data_ptr(), h_t.data_ptr(), h_x.data_ptr(), rh_x.data_ptr(),
            B, T, H, plan.units, plan.rows, plan.parts,
            _DTYPE_CODE[xw.dtype], _stream(xw.device))
    _raise_launch(err, "gru_seq", B, H)
    LAUNCHES["gru_seq"] += 1
    return out, h_t


def gru_sequence_fused(xw: torch.Tensor, lengths: torch.Tensor,
                       u: torch.Tensor, b: Optional[torch.Tensor] = None,
                       h0: Optional[torch.Tensor] = None, *,
                       route: Optional[str] = None,
                       plan: Optional[Route] = None):
    """Masked GRU over a whole sequence — the
    ``pallas_kernels.gru_sequence_fused`` contract: xw = x@W [B, T, 3H],
    lengths [B] int, u [H, 3H] packed [u_z | u_r | u_c], b [3H] (added to
    xw in xw's dtype before the recurrence, as the JAX wrapper does), h0
    [B, H] (zeros when None) -> (out [B, T, H], hT [B, H]) in xw's dtype.

    The kernel runs all T steps in one launch for each row tile of its
    route (:func:`plan_route`, as :func:`lstm_sequence_fused`; the JAX
    ``chunk_t`` tiles VMEM and has no counterpart: it rounds h to bf16 at
    chunk boundaries, which the port never does) and saves nothing beyond
    this contract: :func:`gru_sequence_fused_bwd` recomputes the gates
    from xw and ``out``."""
    _gru_shapes(xw, u)
    if b is not None:
        xw = xw + b
    if h0 is None:
        h0 = torch.zeros((xw.shape[0], u.shape[0]), dtype=xw.dtype,
                         device=xw.device)
    lengths = lengths.to(xw.device)
    kernel = _route(route, xw, lengths, u, h0) == "kernel"
    rt = plan if plan is not None else route_for("gru_seq", xw, u.shape[0],
                                                 route)
    if rt is None:
        return gru_sequence_fused_plain(xw, lengths, u, h0)
    _no_scan(rt, "gru_seq", xw.shape[0], u.shape[0])
    count_route("gru_seq", rt.kind)
    if kernel and rt.kind == "whole":
        return _gru_sequence_fused_kernel(xw, lengths, u, h0, rt.plans[0])
    outs = _gru_outs(xw, u.shape[0])

    def one(tin, touts, tplan):
        if kernel:
            _gru_sequence_fused_kernel(tin[0], tin[1], u, tin[2], tplan,
                                       touts)
            return
        for o, g in zip(touts, gru_sequence_fused_plain(tin[0], tin[1], u,
                                                        tin[2])):
            o.copy_(g)

    _run_tiles(rt, [xw, lengths, h0], outs, one)
    return outs


# ---------------------------------------------------------------------------
# GRU backward (replaces _gru_seq_bwd_kernel)
# ---------------------------------------------------------------------------

@_opaque
def gru_sequence_fused_bwd_plain(xw, lengths, u, h0, out_seq, g_out, g_ht):
    """The op order of ``_gru_seq_bwd_kernel``: gates recomputed from xw
    and h_{t-1} = the saved masked output (h0 at t = 0) in f32, the
    adjoints in f32, dU summed over steps in f32. -> (dxw [B, T, 3H],
    dh0 [B, H]) in xw's dtype and du [H, 3H] f32."""
    B, T, G = xw.shape
    H = G // 3
    dt = xw.dtype
    u32 = _f32(u)
    uz, ur, uc = u32[:, :H], u32[:, H:2 * H], u32[:, 2 * H:]
    lens = _f32(lengths)[:, None]
    h0 = _f32(h0)
    dh = _f32(g_ht)
    du = torch.zeros((H, G), dtype=torch.float32, device=xw.device)
    dxw = torch.empty_like(xw)
    for t in reversed(range(T)):
        h_prev = _f32(out_seq[:, t - 1]) if t > 0 else h0
        z, r, rh, c = _gru_gates(_f32(xw[:, t]), h_prev, u32, H)
        m = (t < lens).to(torch.float32)
        dh_t = dh + m * _f32(g_out[:, t])
        dhp = m * dh_t
        dgz = (dhp * (c - h_prev)) * z * (1.0 - z)
        dgc = (dhp * z) * (1.0 - c * c)
        drh = dgc @ uc.t()
        dgr = (drh * h_prev) * r * (1.0 - r)
        dh = ((1.0 - m) * dh_t + dhp * (1.0 - z) + drh * r + dgz @ uz.t()
              + dgr @ ur.t())
        dxw[:, t] = torch.cat([dgz, dgr, dgc], dim=1).to(dt)
        du = du + torch.cat([h_prev.t() @ dgz, h_prev.t() @ dgr,
                             rh.t() @ dgc], dim=1)
    return dxw, dh.to(dt), du


def _gru_sequence_fused_bwd_kernel(xw, lengths, u, h0, out_seq, g_out, g_ht,
                                   outs=None):
    B, T, H = _gru_shapes(xw, u)
    G = 3 * H
    seq, vec = (B, T, H), (B, H)
    lens = _check_args(
        "gru_sequence_fused_bwd", xw, lengths, H,
        [("u", u, (H, G)), ("h0", h0, vec), ("out_seq", out_seq, seq),
         ("g_out", g_out, seq), ("g_ht", g_ht, vec)])
    dxw, dh0 = outs if outs is not None else (
        torch.empty_like(xw),
        torch.empty((B, H), dtype=xw.dtype, device=xw.device))
    du = torch.empty((H, G), dtype=torch.float32, device=xw.device)
    if B == 0 or T == 0:
        dh0.copy_(g_ht)
        du.zero_()
        return dxw, dh0, du
    lib = _build.load().lib
    # scratch for the B*T (b, t) rows, of which the kernel uses the live
    # ones, compacted: the gates z, r, c of each (overwritten by their
    # cotangents) and r*h_{t-1} in f32, h_{t-1} in xw's dtype, and each
    # row's b*T + t
    rows = B * T
    f32 = dict(dtype=torch.float32, device=xw.device)
    gates = torch.empty((rows, G), **f32)
    rh_seq = torch.empty((rows, H), **f32)
    hp_seq = torch.empty((rows, H), dtype=xw.dtype, device=xw.device)
    rowmap = torch.empty(rows, dtype=torch.int32, device=xw.device)
    with torch.cuda.device(xw.device):
        err = lib.paddle_gru_seq_bwd(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), h0.data_ptr(),
            out_seq.data_ptr(), g_out.data_ptr(), g_ht.data_ptr(),
            dxw.data_ptr(), dh0.data_ptr(), du.data_ptr(), gates.data_ptr(),
            rh_seq.data_ptr(), hp_seq.data_ptr(), rowmap.data_ptr(), B, T, H,
            _DTYPE_CODE[xw.dtype], _stream(xw.device))
    _raise_launch(err, "gru_seq_bwd", B, H)
    LAUNCHES["gru_seq_bwd"] += 1
    return dxw, dh0, du


def gru_sequence_fused_bwd(xw, lengths, u, h0, out_seq, g_out, g_ht, *,
                           route: Optional[str] = None,
                           plan: Optional[Route] = None):
    """Backward of :func:`gru_sequence_fused` — the
    ``pallas_kernels.gru_sequence_fused_bwd`` contract: xw with the bias
    added (its gradient is also the bias's, summed outside), the saved
    out_seq and the cotangents g_out [B, T, H], g_ht [B, H] ->
    (dxw [B, T, 3H], dh0 [B, H]) in xw's dtype and du [H, 3H] f32. The
    kernel keeps its recomputed gates and f32 cotangents of the live
    steps in scratch allocated per call; nothing is read from the forward
    but ``out_seq``. Routed as :func:`lstm_sequence_fused_bwd`."""
    _gru_shapes(xw, u)
    lengths = lengths.to(xw.device)
    kernel = _route(route, xw, lengths, u, h0, out_seq, g_out,
                    g_ht) == "kernel"
    rt = (plan if plan is not None
          else route_for("gru_seq_bwd", xw, u.shape[0], route))
    if rt is None:
        return gru_sequence_fused_bwd_plain(xw, lengths, u, h0, out_seq,
                                            g_out, g_ht)
    _no_scan(rt, "gru_seq_bwd", xw.shape[0], u.shape[0])
    count_route("gru_seq_bwd", rt.kind)
    if kernel and rt.kind == "whole":
        return _gru_sequence_fused_bwd_kernel(xw, lengths, u, h0, out_seq,
                                              g_out, g_ht)
    B, H = xw.shape[0], u.shape[0]
    outs = (torch.empty_like(xw),
            torch.empty((B, H), dtype=xw.dtype, device=xw.device))

    def run(tin, touts):
        xw_, len_, h0_, *rest = tin
        if kernel:
            return _gru_sequence_fused_bwd_kernel(xw_, len_, u, h0_, *rest,
                                                  touts)[2]
        got = gru_sequence_fused_bwd_plain(xw_, len_, u, h0_, *rest)
        for o, g in zip(touts, got):
            o.copy_(g)
        return got[2]

    du = _tiled_bwd(rt, [xw, lengths, h0, out_seq, g_out, g_ht], outs, run)
    return outs + (du,)


# the recurrences' roofline byte model (JAX's ``_lstm_sequence_fused_bytes``,
# registered for lstm_sequence_fused and, with three gates,
# gru_sequence_fused): opaque to the meta-tensor cost count, as a Pallas
# custom call is to XLA's

def _lstm_sequence_fused_bytes(*, batch, seq_len, hidden, itemsize=4,
                               gates=4):
    """HBM bytes of one fused-RNN forward launch: the [B, T, G*H] gate
    input streams in once, [B, T, H] outputs stream out, the recurrent
    [H, G*H] weights load once."""
    return float(itemsize) * (batch * seq_len * hidden * gates      # xw in
                              + batch * seq_len * hidden            # out
                              + hidden * hidden * gates)            # U


def _register_cost_models():
    from ..obs import roofline
    roofline.register_kernel_cost("lstm_sequence_fused",
                                  _lstm_sequence_fused_bytes)
    roofline.register_kernel_cost(
        "gru_sequence_fused",
        functools.partial(_lstm_sequence_fused_bytes, gates=3))


_register_cost_models()
