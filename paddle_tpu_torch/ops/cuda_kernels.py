"""Attention kernels — the counterpart of
``paddle_tpu/ops/pallas_kernels.py`` for the TPU attention kernels the
serving, decode and transformer-training paths run:

* :func:`flash_attention_fwd` replaces ``_fa_fwd_kernel`` (prefill and
  every training forward);
* :func:`flash_attention_bwd` replaces ``_fa_bwd_dq_kernel`` and
  ``_fa_bwd_dkv_kernel`` (the training backward), bound to autograd by
  :class:`_FlashAttention` in place of the JAX custom VJP ``_flash``;
* :func:`decode_attention` replaces ``_decode_attn_kernel`` and, over an
  int8 cache, ``_decode_attn_q_kernel`` (the dense decode step);
* :func:`paged_decode_attention` replaces ``_paged_attn_kernel`` and, over
  int8 pools, ``_paged_attn_q_kernel`` (the paged decode step).

:func:`quantize_kv` is the int8 KV codebook those reads dequantize.

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``, built
by ``ops/_build.py``) for tensors on the card, and takes the plain PyTorch
version beside it for tensors on the CPU — because they lie on the CPU,
not as a fallback: on a CUDA tensor a wrapper launches or raises. A caller
may also ask for the plain version explicitly with ``route="plain"`` (the
counterpart of the JAX entries' ``route=``), which the solo reference
decode uses on the card.

In bf16 the forward (#1) and both backward kernels (#2 dq, #3 dk/dv)
run tensor-core bodies (wgmma on TMA-fed tiles); they round P (#1), dS
(#2) and Pᵀ, dSᵀ (#3) to bf16 before the second product, where the plain
versions keep f32. In f32 the three kernels run on the tensor cores
too, at f32 accuracy: each product is three TF32 products of split
operands (``csrc/tf32x3.cuh``), on tiles fed by 16-byte ``cp.async``
copies. Every attention kernel needs q, k and v (and, for the backward,
o and dO) at a 16-byte-aligned base with strides of 16-byte multiples:
the wrappers copy a view that breaks the rule into a contiguous buffer
first (the ``copy16`` route).

Head widths. #1-#3 are built for D = 64, 128 and 256
(``KERNEL_HEAD_DIMS``; at 256 the simple bodies of ``csrc/flash_wide.cu``);
the wrappers zero-pad q, k and v (and o, dO) of any other width up to 256
to the next of them and slice the outputs back (the ``pad64``,
``pad128`` and ``pad256`` routes), which is exact: a zero column adds
+0.0 to every score and the padded output columns are dropped; the scale
is the real width's. #4-#7 read every multiple of 8 up to 256 natively,
with no copy of a cache; a width that is not a multiple of 8 is
zero-padded to the next one (q, and the cache or pools the read takes:
the ``pad8`` route, a copy a call). Wider heads raise (ROADMAP B.1.5).
``ROUTES`` counts each call that took a route other than the kernel's
own, by (kernel, route).

The decode reads (#4 and #6, and #5 and #7 over int8) run one split
body: each (sample, head) read is split across blocks when the card
would otherwise sit half empty (:func:`decode_splits`), each block walks
one chunk of rows, and the last block of a read to finish merges the
chunks' partial softmax sums in chunk order. A paged read equals the
dense read of its gathered pages bit for bit at the same split count.

The plain versions follow the op order of ``_dense_attention`` and
``_dense_decode_attention``. ``SHORT_SEQ_DENSE``, ``decode_route`` and
``_default_blocks`` of the JAX package are TPU routing and set nothing
here.

``LAUNCHES`` counts kernel launches per wrapper: a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from ..obs.xplane import current_stamp, site_range

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the attention bodies #1-#3 are compiled for; any other
#: width up to MAX_HEAD_DIM is zero-padded to the next of them
KERNEL_HEAD_DIMS = (64, 128, 256)
#: the widest head every kernel takes (#4-#7 read each multiple of 8 up to
#: it natively, and pad the other widths to the next multiple of 8)
MAX_HEAD_DIM = 256

#: launches of every kernel of the port, by kernel (the LSTM and GRU
#: wrappers of ops/rnn_kernels.py count here too)
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkv": 0,
                            "decode_attention": 0,
                            "decode_attention_q": 0,
                            "paged_decode_attention": 0,
                            "paged_decode_attention_q": 0,
                            "lstm_seq": 0, "lstm_seq_train": 0,
                            "lstm_seq_bwd": 0, "gru_seq": 0,
                            "gru_seq_bwd": 0}


#: the routes the wrappers took, by (kernel, route): the recurrences'
#: "whole", "tiles" or "scan" (ops/rnn_kernels.py ``plan_route``; the
#: counterpart of JAX's ``kernels.routes_total``), and the attention
#: kernels' "pad64", "pad128", "pad256" (a head width zero-padded to a
#: built one), "pad8" (#4-#7: a width padded to a multiple of 8) and
#: "copy16" (a view copied to meet the 16-byte rule). A call counts
#: where its route is decided; a graph replays the counts its capture
#: took, as LAUNCHES.
ROUTES: Dict[Tuple[str, str], int] = {}


def _count_route(route: str, *kernels: str) -> None:
    for name in kernels:
        ROUTES[(name, route)] = ROUTES.get((name, route), 0) + 1


def reset_launch_counts() -> None:
    """Set every count of LAUNCHES and ROUTES to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTES.clear()


def _opaque(plain):
    """A kernel's plain version that a roofline cost count does not see
    (``obs.roofline.opaque``): the kernel counts as zero FLOPs and bytes
    there, as a Pallas custom call does in XLA's analysis, and its wrapper
    adds the registered byte model instead."""
    import functools

    @functools.wraps(plain)
    def run(*args, **kwargs):
        from ..obs.roofline import opaque
        with opaque():
            return plain(*args, **kwargs)
    return run


def _count_kernel_route(kernel: str, route: str) -> None:
    """``kernels.routes_total`` for a decode read, in JAX's labels
    ("kernel", or "dense" where the plain version runs)."""
    from .. import obs
    obs.count("kernels.routes_total", kernel=kernel,
              route="dense" if route == "plain" else route)


def _route(route: Optional[str], *tensors: torch.Tensor) -> str:
    """"kernel" for CUDA tensors, "plain" for CPU tensors or when asked."""
    if route not in (None, "plain"):
        raise ValueError(f"unknown route {route!r} (None or 'plain')")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    if route == "plain" or next(iter(devices)).type != "cuda":
        return "plain"
    return "kernel"


def _check_float(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not taken by the kernel "
                        "(float32 or bfloat16)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} differs from the call's "
                        f"{dtype}")


def _stream(device: torch.device) -> int:
    """The current stream of the tensors' card (the launch goes there)."""
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


# ---------------------------------------------------------------------------
# flash attention forward (replaces _fa_fwd_kernel)
# ---------------------------------------------------------------------------

@_opaque
def flash_attention_fwd_plain(q, k, v, *, causal: bool, scale: float,
                              kv_lens: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked dense attention with the row logsumexp: q [B,T,H,D], k/v
    [B,S,H,D] -> (o [B,T,H,D] in q's dtype, lse [B,T,H] f32). Op order of
    ``_dense_attention``: f32 einsum, * scale, kv_lens mask, causal mask,
    softmax, einsum, cast. ``kv_lens`` arrives clamped to [1, S] by
    :func:`flash_attention_fwd`."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    s = torch.where(_live(q.shape[1], k.shape[1], causal, kv_lens, s.device),
                    s, _NEG)
    lse = torch.logsumexp(s, dim=-1).transpose(1, 2).contiguous()
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
    return o, lse


def _live(T: int, S: int, causal: bool, kv_lens: Optional[torch.Tensor],
          device) -> torch.Tensor:
    """The (q, k) pairs that enter the softmax, broadcastable to the
    [B, H, T, S] scores: keys below each sample's kv_len and, with
    ``causal``, keys j <= i."""
    ok = torch.ones((1, 1, T, S), dtype=torch.bool, device=device)
    if kv_lens is not None:
        lens = kv_lens.to(device=device)
        ok = ok & (torch.arange(S, device=device)[None, :]
                   < lens[:, None])[:, None, None, :]
    if causal:
        ok = ok & torch.ones((T, S), dtype=torch.bool, device=device).tril()
    return ok


def _check_width(what: str, D: int) -> None:
    """Raises on a head width no kernel takes: past MAX_HEAD_DIM (no model
    of the repo or its catalogue has one; ROADMAP B.1.5)."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: head width {D} not taken by the kernels (widths 1 to "
            f"{MAX_HEAD_DIM}: {KERNEL_HEAD_DIMS} natively for #1-#3, the "
            "rest zero-padded to the next of them; wider heads are ROADMAP "
            "B.1.5)")


def _built_width(what: str, D: int) -> int:
    """The width #1-#3 run a head of width D at: D itself when it is
    built, else the next built width (the pad route)."""
    _check_width(what, D)
    return next(w for w in KERNEL_HEAD_DIMS if w >= D)


def _attention_shapes(what: str, q, k, v):
    """(B, T, S, H, D) of q [B,T,H,D], k/v [B,S,H,D] in one dtype with an
    innermost stride of 1 and a built head width, as the attention
    kernels take them; raises on anything else."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2:] != (H, D):
        raise ValueError(f"{what}: k/v {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} as [B, S, H, D]")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head width {D} not built (built for "
                         f"{KERNEL_HEAD_DIMS}; the wrappers pad the rest)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_float(name, t, q.dtype)
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs an innermost stride of 1")
    return B, T, S, H, D


def _breaks_tma(t: torch.Tensor) -> bool:
    """Whether ``t`` breaks the 16-byte rule of the attention kernels: a
    16-byte-aligned base, an innermost stride of 1, and batch, position
    and head strides that are multiples of 16 bytes (a dimension of size
    1 is never stepped)."""
    esize = t.element_size()
    return (t.data_ptr() % 16 != 0 or t.stride(-1) != 1
            or any(n > 1 and (st * esize) % 16
                   for n, st in zip(t.shape[:3], t.stride()[:3])))


def _check_tma(what: str, **tensors: torch.Tensor) -> None:
    """The bf16 attention kernels load [B, L, H, D] operands by TMA, and
    the f32 ones (#1, #2, #3) by 16-byte ``cp.async`` copies; both need
    the 16-byte rule (:func:`_breaks_tma`). The wrappers copy a view that
    breaks it (:func:`_kernel_operands`), so this raises only on a direct
    call of a launch with such a view."""
    for name, t in tensors.items():
        if _breaks_tma(t):
            raise ValueError(
                f"{what}: {name} (strides {tuple(t.stride())}, base "
                f"{t.data_ptr() % 16} bytes past 16) breaks the TMA rule of "
                "the attention kernels: a 16-byte-aligned base and strides "
                "of 16-byte multiples")


def _kernel_operands(what: str, kernels: Tuple[str, ...], *ts):
    """The operands of #1-#3 as the kernels take them: at a built head
    width the tensors as they are, with those that break the 16-byte rule
    copied into contiguous buffers (route "copy16"); at any other width
    every [..., D] operand zero-padded to the next built width ("pad64",
    "pad128", "pad256": fresh contiguous buffers). A route other than the kernel's
    own is counted in ROUTES under each of ``kernels``."""
    D = ts[0].shape[-1]
    W = _built_width(what, D)
    if W != D:
        route = f"pad{W}"
        out = tuple(torch.nn.functional.pad(t, (0, W - D)) for t in ts)
    elif any(_breaks_tma(t) for t in ts):
        route = "copy16"
        out = tuple(t.clone(memory_format=torch.contiguous_format)
                    if _breaks_tma(t) else t for t in ts)
    else:
        return ts
    _count_route(route, *kernels)
    return out


def _kernel_lens(what: str, kv_lens: Optional[torch.Tensor], B: int,
                 device) -> Optional[torch.Tensor]:
    if kv_lens is None:
        return None
    if kv_lens.shape != (B,):
        raise ValueError(f"{what}: kv_lens shape {tuple(kv_lens.shape)} != "
                         f"({B},)")
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _strides(*ts: torch.Tensor):
    """The batch, sequence and head strides of each [B, L, H, D] tensor."""
    return [s for t in ts for s in t.stride()[:3]]


def flash_fwd_by_route(q, k, v, causal, scale, kv_lens, launch):
    """#1's wrapper route around ``launch(q, k, v, causal, scale, kv_lens)
    -> (o, lse)``: the operands as :func:`_kernel_operands` gives them
    (padded to a built width, or copied to keep the 16-byte rule), o
    sliced back to the caller's width. The kernel route passes the launch
    of #1; the CPU tests pass the plain version, so the pad route's
    arithmetic is held to JAX's there."""
    B, T, H, D = q.shape
    if B == 0 or T == 0:
        return (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device),
                torch.empty((B, T, H), dtype=torch.float32, device=q.device))
    q, k, v = _kernel_operands("flash_attention_fwd", ("flash_attention_fwd",),
                               q, k, v)
    o, lse = launch(q, k, v, causal, scale, kv_lens)
    return (o if o.shape[-1] == D else o[..., :D].contiguous()), lse


def _flash_fwd_launch(q, k, v, causal, scale, kv_lens):
    """Kernel #1 on operands at a built width that keep the 16-byte rule."""
    what = "flash_attention_fwd"
    B, T, S, H, D = _attention_shapes(what, q, k, v)
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    _check_tma(what, q=q, k=k, v=v)
    lens = _kernel_lens(what, kv_lens, B, q.device)
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        err = lib.paddle_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens),
            o.data_ptr(), lse.data_ptr(), B, T, S, H, D,
            *_strides(q, k, v), float(scale), int(causal),
            _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(err, what)
    LAUNCHES[what] += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None,
                        route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with the row logsumexp — the ``_fa_fwd_call`` contract:
    q [B,T,H,D], k/v [B,S,H,D] (f32 or bf16; ``causal`` masks key j for
    query i when j > i, top-left aligned at any S and T, as JAX's
    ``tril(ones(T, S))``), optional ``kv_lens`` [B] masking each sample's
    keys at or past its length -> (o [B,T,H,D] in q's dtype, lse [B,T,H]
    f32). On the card D is any width up to 256 (module docstring: the pad
    routes).

    A length is clamped to [1, S] on both routes: a sample with no key has
    no softmax support, so it attends key 0 (``flash_attention`` then
    zeroes its output, as the JAX entry does)."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    if kv_lens is not None:
        kv_lens = kv_lens.clamp(1, k.shape[1])
    if _route(route, q, k, v) == "plain":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         scale=scale_v, kv_lens=kv_lens)
    return flash_fwd_by_route(q, k, v, causal, scale_v, kv_lens,
                              _flash_fwd_launch)


# ---------------------------------------------------------------------------
# flash attention backward (replaces _fa_bwd_dq_kernel, _fa_bwd_dkv_kernel)
# ---------------------------------------------------------------------------

@_opaque
def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool,
                              scale: float,
                              kv_lens: Optional[torch.Tensor] = None,
                              delta: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The ``_fa_bwd_call`` arithmetic written out: delta = rowsum(dO·O) in
    f32 (when not given), P recomputed from ``lse``, dS = P·(dP − delta),
    dQ = scale·dS·K, dK = dSᵀ·(scale·Q), dV = Pᵀ·dO. Masked pairs (keys at
    or past kv_len; with ``causal``, keys j > i) have P == 0 exactly, so
    masked keys get exactly zero dk and dv. Returns (dq in q's dtype, dk
    in k's, dv in v's)."""
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    if delta is None:
        delta = torch.sum(dof * o.float(), dim=-1)
    s = torch.einsum("bthd,bshd->bhts", qs, kf)
    s = torch.where(_live(q.shape[1], k.shape[1], causal, kv_lens, s.device),
                    s, _NEG)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta.float().transpose(1, 2)[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qs)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashBwdLaunch:
    """The checked arguments and the outputs of one kernel backward, with
    one method per kernel: :meth:`dq` (#2) then :meth:`dkv` (#3), each one
    launch on the current stream. ``flash_attention_bwd`` runs both;
    chip_smoke.py times each alone."""

    def __init__(self, q, k, v, o, lse, do, causal: bool, scale: float,
                 kv_lens: Optional[torch.Tensor],
                 delta: Optional[torch.Tensor]):
        what = "flash_attention_bwd"
        B, T, S, H, D = _attention_shapes(what, q, k, v)
        for name, t in (("o", o), ("do", do)):
            if t.shape != q.shape:
                raise ValueError(f"{what}: {name} {tuple(t.shape)} != q "
                                 f"{tuple(q.shape)}")
            _check_float(name, t, q.dtype)
        for name, t in (("lse", lse), ("delta", delta)):
            if t is not None and (t.shape != (B, T, H)
                                  or t.dtype != torch.float32):
                raise ValueError(f"{what}: {name} must be float32 [{B}, "
                                 f"{T}, {H}], got {t.dtype} "
                                 f"{tuple(t.shape)}")
        # o and dO are read as contiguous [B, T, H, D]: autograd's
        # cotangent of the forward's contiguous output already is, so
        # nothing is copied
        self.q, self.k, self.v = q, k, v
        self.o, self.do, self.lse = (o.contiguous(), do.contiguous(),
                                     lse.contiguous())
        _check_tma(what, q=q, k=k, v=v, o=self.o, do=self.do)
        self.compute_delta = delta is None
        self.delta = (torch.empty((B, T, H), dtype=torch.float32,
                                  device=q.device)
                      if delta is None else delta.contiguous())
        self.lens = _kernel_lens(what, kv_lens, B, q.device)
        self.dq_out = torch.empty((B, T, H, D), dtype=q.dtype,
                                  device=q.device)
        self.dk_out = torch.empty((B, S, H, D), dtype=k.dtype,
                                  device=q.device)
        self.dv_out = torch.empty((B, S, H, D), dtype=v.dtype,
                                  device=q.device)
        self.shape = (B, T, S, H, D)
        self.causal, self.scale = int(causal), float(scale)

    def _args(self):
        return (*self.shape, *_strides(self.q, self.k, self.v), self.scale,
                self.causal)

    def dq(self) -> None:
        """Kernel #2: dq, and delta when none was given (dk/dv reads it)."""
        with torch.cuda.device(self.q.device):
            err = _build.load().lib.paddle_flash_attention_bwd_dq(
                self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                self.o.data_ptr(), self.do.data_ptr(), self.lse.data_ptr(),
                self.delta.data_ptr(), _ptr(self.lens),
                self.dq_out.data_ptr(), *self._args(),
                int(self.compute_delta), _DTYPE_CODE[self.q.dtype],
                _stream(self.q.device))
        _raise_on(err, "flash_attention_bwd (dq)")
        LAUNCHES["flash_attention_bwd_dq"] += 1

    def dkv(self) -> None:
        """Kernel #3: dk and dv (after :meth:`dq` when it computes delta)."""
        with torch.cuda.device(self.q.device):
            err = _build.load().lib.paddle_flash_attention_bwd_dkv(
                self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                self.do.data_ptr(), self.lse.data_ptr(),
                self.delta.data_ptr(), _ptr(self.lens),
                self.dk_out.data_ptr(), self.dv_out.data_ptr(),
                *self._args(), _DTYPE_CODE[self.q.dtype],
                _stream(self.q.device))
        _raise_on(err, "flash_attention_bwd (dk/dv)")
        LAUNCHES["flash_attention_bwd_dkv"] += 1


def _flash_bwd_launch(q, k, v, o, lse, do, causal, scale, kv_lens, delta):
    """Kernels #2 then #3 on operands at a built width."""
    run = FlashBwdLaunch(q, k, v, o, lse, do, causal, scale, kv_lens, delta)
    B, T, S = run.shape[:3]
    if B == 0 or T == 0 or S == 0:
        return run.dq_out, run.dk_out.zero_(), run.dv_out.zero_()
    run.dq()
    run.dkv()
    return run.dq_out, run.dk_out, run.dv_out


def flash_bwd_by_route(q, k, v, o, lse, do, causal, scale, kv_lens, delta,
                       launch):
    """#2 and #3's wrapper route around ``launch(q, k, v, o, lse, do,
    causal, scale, kv_lens, delta) -> (dq, dk, dv)``, as
    :func:`flash_fwd_by_route` wraps #1: o and dO are padded (or copied)
    with q, k and v, and the gradients sliced back."""
    D = q.shape[-1]
    q, k, v, o, do = _kernel_operands(
        "flash_attention_bwd",
        ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), q, k, v, o, do)
    outs = launch(q, k, v, o, lse, do, causal, scale, kv_lens, delta)
    if q.shape[-1] != D:
        outs = tuple(t[..., :D].contiguous() for t in outs)
    return outs


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None,
                        delta: Optional[torch.Tensor] = None,
                        route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention from the forward's (o, lse) and the
    cotangent ``do`` — the ``_fa_bwd_call`` contract: q/o/do [B,T,H,D],
    k/v [B,S,H,D] in one dtype (f32 or bf16), lse [B,T,H] f32, optional
    ``delta`` = rowsum(dO·O) [B,T,H] f32. ``kv_lens`` is clamped to [1, S]
    as :func:`flash_attention_fwd` clamps it, so the two agree on which
    keys are live; ``causal`` is the forward's top-left-aligned mask.

    For CUDA tensors two kernels run on the current stream: dq (#2), which
    also computes delta when none is given, then dk/dv (#3)."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    if kv_lens is not None:
        kv_lens = kv_lens.clamp(1, k.shape[1])
    extra = () if delta is None else (delta,)
    if _route(route, q, k, v, o, lse, do, *extra) == "plain":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale_v, kv_lens=kv_lens,
                                         delta=delta)
    return flash_bwd_by_route(q, k, v, o, lse, do, causal, scale_v, kv_lens,
                              delta, _flash_bwd_launch)


class _FlashAttention(torch.autograd.Function):
    """Attention under autograd — the counterpart of the JAX custom VJP
    ``_flash``: the forward runs :func:`flash_attention_fwd` (kernel #1)
    and saves o and lse; the backward runs :func:`flash_attention_bwd`
    (kernels #2 and #3) with the same lengths, which it clamps as the
    forward does."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, scale, route):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     kv_lens=kv_lens, route=route)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens)
        ctx.causal, ctx.scale, ctx.route = causal, scale, route
        ctx.stamp = current_stamp()
        return o

    @staticmethod
    def backward(ctx, do):
        with site_range(ctx.stamp):
            return _FlashAttention._backward(ctx, do)

    @staticmethod
    def _backward(ctx, do):
        q, k, v, o, lse, kv_lens = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale,
                                         kv_lens=kv_lens, route=ctx.route)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    route: Optional[str] = None) -> torch.Tensor:
    """Fused attention, the counterpart of ``pallas_kernels.flash_attention``:
    q [B,T,H,D], k/v [B,S,H,D] -> o [B,T,H,D]. Differentiable: with grad
    enabled and q, k or v requiring grad it runs through
    :class:`_FlashAttention` (the backward kernels); otherwise the forward
    alone.

    A sample with ``kv_lens == 0`` has no softmax support: it attends key 0
    and its output is then zeroed, as in the JAX entry. The zeroing stays
    outside the autograd Function, so it also zeroes that sample's
    cotangent and no gradient reaches its keys."""
    valid = None if kv_lens is None else kv_lens > 0
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = _FlashAttention.apply(q, k, v, kv_lens, causal, scale_v, route)
    else:
        o, _ = flash_attention_fwd(q, k, v, causal=causal, scale=scale_v,
                                   kv_lens=kv_lens, route=route)
    if valid is not None:
        o = o * valid.to(device=o.device, dtype=o.dtype)[:, None, None, None]
    return o


# ---------------------------------------------------------------------------
# decode reads (replace _decode_attn_kernel, _decode_attn_q_kernel,
# _paged_attn_kernel and _paged_attn_q_kernel)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 rows for the KV cache — ``pallas_kernels.quantize_kv``:
    x [..., D] -> (q int8 [..., D], scale f32 [...]) with x ~= q * scale
    per row, scale = amax/127 (1.0 for an all-zero row). In f32 (bf16 is
    cast first), dividing by the scale and rounding half to even as
    ``jnp.round`` does, so the codes are the JAX codebook's bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


@_opaque
def decode_attention_plain(q, k, v, pos, *, scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The op order of ``_dense_decode_attention``: an int8 cache
    dequantizes up front (float(code) * scale), then f32 scores of
    q * scale against every row, rows j <= pos[b] live, an f32 softmax,
    o [B, H, D] f32."""
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    L = k.shape[1]
    s = torch.einsum("bhd,bjhd->bhj", q.float() * scale, k.float())
    valid = (torch.arange(L, device=s.device)[None, :]
             <= pos.to(s.device)[:, None])[:, None, :]
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhj,bjhd->bhd", p / l, v.float())


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense per-sample view of a page pool: pool [P, bs, ...] gathered by
    tables [B, NB] -> [B, NB*bs, ...]. The plain version reads through
    this; the kernels never materialize it."""
    B, NB = tables.shape
    g = pool[tables.long()]
    return g.reshape((B, NB * pool.shape[1]) + tuple(pool.shape[2:]))


@_opaque
def paged_decode_attention_plain(q, k_pool, v_pool, tables, pos, *,
                                 scale: float,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``gather_pages`` (of the scale pools too, for int8) + the op order
    of ``_dense_decode_attention`` (:func:`decode_attention_plain`)."""
    ks = None if k_scale is None else gather_pages(k_scale, tables)
    vs = None if v_scale is None else gather_pages(v_scale, tables)
    return decode_attention_plain(q, gather_pages(k_pool, tables),
                                  gather_pages(v_pool, tables), pos,
                                  scale=scale, k_scale=ks, v_scale=vs)


def _decode_query(what: str, q: torch.Tensor, pos: torch.Tensor):
    """(B, H, D, pos as contiguous int32) of a decode read's query
    q [B, H, D] (f32 or bf16, innermost stride 1, D a multiple of 8 up to
    MAX_HEAD_DIM, read natively); raises on anything the kernels do not
    take."""
    if q.dim() != 3:
        raise ValueError(f"{what}: q {tuple(q.shape)} is not [B, H, D]")
    B, H, D = q.shape
    _check_width(what, D)
    if D % 8:
        raise ValueError(f"{what}: head width {D} is not a multiple of 8 "
                         "(the wrappers pad it: the pad8 route)")
    _check_float("q", q, q.dtype)
    if q.stride(-1) != 1:
        raise ValueError(f"{what}: q needs an innermost stride of 1")
    if pos.shape != (B,):
        raise ValueError(f"{what}: pos {tuple(pos.shape)} != ({B},)")
    return B, H, D, pos.to(dtype=torch.int32).contiguous()


def _check_cache(what: str, q, k, v, k_scale, v_scale, scale_shape):
    """k/v in q's dtype, or int8 with f32 scales of ``scale_shape``."""
    if k_scale is None:
        for name, t in (("k", k), ("v", v)):
            _check_float(name, t, q.dtype)
        return
    for name, t in (("k", k), ("v", v)):
        if t.dtype != torch.int8:
            raise TypeError(f"{what}: {name} dtype {t.dtype} with scales "
                            "(the quantized kernel reads int8)")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != scale_shape:
            raise ValueError(f"{what}: {name} must be float32 "
                             f"{list(scale_shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _check_rows(what: str, *named) -> None:
    """The kernels read a cache row as 8-element vectors (16 bytes of bf16,
    8 of int8): innermost stride 1, the other strides multiples of 8, a
    16-byte-aligned start."""
    for name, t in named:
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs an innermost stride of "
                             "1, other strides that are multiples of 8 and "
                             "a 16-byte-aligned start")


#: the split rule of #4-#7 (:func:`decode_splits`), from chip_smoke.py's
#: phase-9 sweep on the H100 (PERF.md): split while the read has fewer than
#: DECODE_TARGET_BLOCKS blocks (about 6 blocks of 128 threads an SM: the time
#: kept falling to ~8 splits at 96 pairs and to 2-3 at 384), into chunks of at
#: least DECODE_MIN_CHUNK rows (shorter ones gained little or lost). The
#: int8 read's sweep put its best counts where #4's are, so one rule serves
#: both.
DECODE_TARGET_BLOCKS = 768
DECODE_MIN_CHUNK = 64
#: rows a block's row groups take in one step (csrc/decode_attn.cuh kGroups)
_DECODE_ROW_STEP = 16
#: the split reads' per-(b, h) tickets, one buffer per (card, stream), shared
#: by #4-#7 and zero between launches (the last block of a read resets its
#: own): the reads that share a buffer run in their stream's order. A CUDA
#: graph captured on a stream uses that stream's buffer, so its replays
#: must not overlap reads issued on that stream.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
#: buffers a larger one replaced: a graph captured over one still reads it
_RETIRED_TICKETS: list = []


def default_split_count(bh: int, L: int) -> int:
    """The split count :func:`decode_splits` asks for with no tuned entry
    (before rounding): enough blocks to reach ``DECODE_TARGET_BLOCKS``,
    each chunk at least ``DECODE_MIN_CHUNK`` rows."""
    return min(-(-DECODE_TARGET_BLOCKS // bh), L // DECODE_MIN_CHUNK)


def decode_splits(bh: int, L: int, splits: Optional[int] = None
                  ) -> Tuple[int, int]:
    """(splits, chunk) of a decode read (#4-#7) of ``L`` rows (a paged
    read's NB*bs) for ``bh`` = B*H (sample, head) pairs: ``splits``
    chunks of ``chunk`` rows tile [0, L), the last one not empty. One split where ``bh``
    blocks already fill the card or the read is short; more while the
    grid has fewer than ``DECODE_TARGET_BLOCKS`` blocks, each chunk at
    least ``DECODE_MIN_CHUNK`` rows, unless the autotune cache holds a
    measured count for this (bh, L) (``tune``'s ``decode_route`` space).
    ``splits`` asks for a count instead (then rounded as below). A chunk
    is a whole number of the walk's 16-row steps."""
    if L < 1 or bh < 1:
        raise ValueError(f"decode_splits: bh {bh} and L {L} must be >= 1")
    if splits is None:
        from ..tune import _decode_splits
        splits = _decode_splits(bh, L)
    if splits is None:
        splits = default_split_count(bh, L)
    splits = max(1, min(int(splits), L))
    if splits == 1:
        return 1, L
    chunk = -(-L // splits)
    chunk = -(-chunk // _DECODE_ROW_STEP) * _DECODE_ROW_STEP
    splits = -(-L // chunk)
    return (1, L) if splits == 1 else (splits, chunk)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The current stream's ticket buffer of at least ``n`` entries. It is
    made and zeroed outside any graph capture: one made inside a capture
    would be zeroed only when the graph replays, so a capture that needs a
    new buffer raises."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"decode_attention: a split read of {n} (sample, head) "
                "pairs is the first on this stream to need its tickets "
                "inside a CUDA graph capture; run one such read on the "
                "capture stream before capturing")
        if t is not None:
            _RETIRED_TICKETS.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _split_scratch(device: torch.device, bh: int, D: int, n_split: int):
    """(part, tickets) of a read split ``n_split`` ways: the chunks'
    partials (m, l, acc[D]) in f32 and the stream's tickets; (None, None)
    for one split."""
    if n_split == 1:
        return None, None
    part = torch.empty(bh * n_split * (D + 2), dtype=torch.float32,
                       device=device)
    return part, _tickets(device, bh)


def _decode_attention_kernel(q, k, v, pos, scale, k_scale, v_scale,
                             splits=None):
    """#4 (#5 with scales) on the card. ``splits`` asks for a split
    count other than :func:`decode_splits`' choice (the card tests and
    chip_smoke.py's sweep use it)."""
    what = "decode_attention"
    B, H, D, pos32 = _decode_query(what, q, pos)
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2:] != (H, D):
        raise ValueError(f"{what}: k/v {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} as [B, L, H, D]")
    L = k.shape[1]
    if L == 0:
        raise ValueError(f"{what}: an empty cache read (L = 0)")
    _check_cache(what, q, k, v, k_scale, v_scale, (B, L, H))
    if k.stride() != v.stride():
        raise ValueError(f"{what}: k and v must share strides")
    _check_rows(what, ("k", k), ("v", v))
    if k_scale is not None and k_scale.stride() != v_scale.stride():
        raise ValueError(f"{what}: k_scale and v_scale must share strides")
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return o
    lib = _build.load().lib
    n_split, chunk = decode_splits(B * H, L, splits)
    with torch.cuda.device(q.device):
        part, tickets = _split_scratch(q.device, B * H, D, n_split)
        split = (_ptr(part), _ptr(tickets), B, H, D, L, n_split, chunk,
                 q.stride(0), q.stride(1), *k.stride()[:3])
        tail = (float(scale), _DTYPE_CODE[q.dtype], _stream(q.device))
        if k_scale is None:
            name = "decode_attention"
            err = lib.paddle_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos32.data_ptr(),
                o.data_ptr(), *split, *tail)
        else:
            name = "decode_attention_q"
            err = lib.paddle_decode_attention_q(
                q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
                v_scale.data_ptr(), pos32.data_ptr(), o.data_ptr(), *split,
                *k_scale.stride(), *tail)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return o


def _scales(k_scale, v_scale) -> tuple:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    return () if k_scale is None else (k_scale, v_scale)


def decode_by_route(q: torch.Tensor, kv: Tuple[torch.Tensor, ...], launch,
                    kernel: str) -> torch.Tensor:
    """#4-#7's wrapper route around ``launch(q, kv) -> o``: at a width that
    is a multiple of 8 the operands as they are; at any other width q and
    the cache (or pools) ``kv`` zero-padded to the next multiple of 8
    (route "pad8", counted under ``kernel``) and o sliced back. Exact for
    the reason the flash pad routes are; an int8 cache pads with code 0
    and keeps its scales. The CPU tests pass the plain version as the
    launch."""
    D = q.shape[-1]
    if D % 8 == 0:
        return launch(q, kv)
    pad = (0, -D % 8)
    _count_route("pad8", kernel)
    o = launch(torch.nn.functional.pad(q, pad),
               tuple(torch.nn.functional.pad(t, pad) for t in kv))
    return o[..., :D].contiguous()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     route: Optional[str] = None) -> torch.Tensor:
    """Single-token KV-cache attention read — the
    ``pallas_kernels.decode_attention`` contract: q [B, H, D] (this step's
    query); k/v [B, L, H, D] cache views already bounded to the read length
    L (the decode step passes ``[:, :L]`` of its cache, read in place
    through the strides); pos [B] int32, rows j <= pos[b] live (a pos at or
    past L reads all L rows). With ``k_scale``/``v_scale`` [B, L, H] f32
    the cache is int8 (:func:`quantize_kv`) and dequantizes on load.
    Returns o [B, H, D] f32.

    For CUDA tensors it launches kernel #4, or #5 with scales; either
    splits the read into :func:`decode_splits`'s chunks."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    extra = _scales(k_scale, v_scale)
    taken = _route(route, q, k, v, pos, *extra)
    _count_kernel_route("decode_attention", taken)
    if taken == "plain":
        return decode_attention_plain(q, k, v, pos, scale=scale_v,
                                      k_scale=k_scale, v_scale=v_scale)
    from .. import obs
    if obs.is_active():
        obs.roofline.note_kernel_bytes(
            "decode_attention", obs.roofline.kernel_cost(
                "decode_attention", batch=q.shape[0], read=k.shape[1],
                n_heads=q.shape[1], d_head=q.shape[2],
                kv_dtype="int8" if k_scale is not None else None,
                itemsize=k.element_size()))
    return decode_by_route(
        q, (k, v), lambda q, kv: _decode_attention_kernel(
            q, *kv, pos, scale_v, k_scale, v_scale),
        "decode_attention_q" if k_scale is not None else "decode_attention")


def _paged_decode_attention_kernel(q, k_pool, v_pool, tables, pos, scale,
                                   k_scale, v_scale, splits=None,
                                   carry=True):
    """#6 (#7 with scales) on the card, split as :func:`decode_splits`
    splits NB*bs rows. ``splits`` asks for another count (the card tests
    and chip_smoke.py's sweep use it); ``carry=False`` looks up every
    row's table entry instead of carrying each page's (chip_smoke.py times
    the two)."""
    what = "paged_decode_attention"
    B, H, D, pos32 = _decode_query(what, q, pos)
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[2:] != (H, D):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)}"
                         f"/{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as [P, bs, H, D]")
    P, bs = k_pool.shape[:2]
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"{what}: tables {tuple(tables.shape)} is not "
                         f"[{B}, NB]")
    NB = tables.shape[1]
    if NB * bs == 0:
        raise ValueError(f"{what}: an empty read (NB = {NB}, bs = {bs})")
    _check_cache(what, q, k_pool, v_pool, k_scale, v_scale, (P, bs, H))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)) + (
            () if k_scale is None else (("k_scale", k_scale),
                                        ("v_scale", v_scale))):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        raise TypeError(f"{what}: tables must be contiguous int32")
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return o
    lib = _build.load().lib
    n_split, chunk = decode_splits(B * H, NB * bs, splits)
    with torch.cuda.device(q.device):
        part, tickets = _split_scratch(q.device, B * H, D, n_split)
        tail = (tables.data_ptr(), pos32.data_ptr(), o.data_ptr(),
                _ptr(part), _ptr(tickets), B, H, D, bs, NB, n_split, chunk,
                int(carry), q.stride(0), q.stride(1), float(scale),
                _DTYPE_CODE[q.dtype], _stream(q.device))
        if k_scale is None:
            name = "paged_decode_attention"
            err = lib.paddle_paged_decode_attention(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *tail)
        else:
            name = "paged_decode_attention_q"
            err = lib.paddle_paged_decode_attention_q(
                q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
                v_pool.data_ptr(), v_scale.data_ptr(), *tail)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return o


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           route: Optional[str] = None) -> torch.Tensor:
    """Single-token attention read through a block table — the
    ``pallas_kernels.paged_decode_attention`` contract: q [B, H, D]; pools
    [P, bs, H, D] f32/bf16, or int8 with ``k_scale``/``v_scale`` [P, bs, H]
    f32 scale pools; tables [B, NB] int32 whose entries past a request's
    live pages name the null page 0; pos [B] int32 with rows j <= pos[b]
    live (at most NB*bs rows are read). Returns o [B, H, D] f32.

    For CUDA tensors it launches kernel #6, or #7 with scales: the split
    body of #4 and #5 over the pools' row loaders, the NB*bs rows split
    into :func:`decode_splits`' chunks; it equals :func:`decode_attention`
    over ``gather_pages`` of the same pools bit for bit."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    extra = _scales(k_scale, v_scale)
    taken = _route(route, q, k_pool, v_pool, tables, pos, *extra)
    _count_kernel_route("paged_decode_attention", taken)
    if taken == "plain":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                            scale=scale_v, k_scale=k_scale,
                                            v_scale=v_scale)
    return decode_by_route(
        q, (k_pool, v_pool), lambda q, kv: _paged_decode_attention_kernel(
            q, *kv, tables, pos, scale_v, k_scale, v_scale),
        "paged_decode_attention_q" if k_scale is not None
        else "paged_decode_attention")


# ---------------------------------------------------------------------------
# Roofline cost models — the kernels are opaque to the meta-tensor cost count
# (obs/roofline.py), as Pallas custom calls are to XLA's: each registers the
# analytic HBM bytes of one launch with the obs cost ledger, JAX's models
# (ops/pallas_kernels.py:1386-1450 of the JAX package) copied, so the two
# packages' gauges follow one method. ops/rnn_kernels.py registers the
# recurrences'.
# ---------------------------------------------------------------------------

def _decode_attention_bytes(*, batch, read, n_heads, d_head, layers=1,
                            kv_dtype=None, itemsize=2, steps=1):
    """HBM bytes of ``steps`` decode_attention launches: k+v live cache
    rows stream once per step (int8 rows read 1 byte/element plus one f32
    scale per (row, head))."""
    row = n_heads * (d_head + 4 if kv_dtype == "int8"
                     else d_head * itemsize)
    return 2.0 * batch * read * row * layers * steps


def _paged_decode_attention_bytes(*, batch, pages, page_block, n_heads,
                                  d_head, layers=1, kv_dtype=None,
                                  itemsize=2, steps=1):
    """HBM bytes of ``steps`` paged reads: each sample streams its
    ``pages`` live pages (``page_block`` rows each) once per step."""
    return _decode_attention_bytes(batch=batch, read=pages * page_block,
                                   n_heads=n_heads, d_head=d_head,
                                   layers=layers, kv_dtype=kv_dtype,
                                   itemsize=itemsize, steps=steps)


def _paged_prefill_attention_bytes(*, batch, pages, page_block, n_heads,
                                   d_head, layers=1, kv_dtype=None,
                                   itemsize=2):
    """HBM bytes of one prefix-hit admission: each sample's read view
    gathers its ``pages`` table-named pages once per layer (the paged
    decode read's shape at steps=1)."""
    return _paged_decode_attention_bytes(batch=batch, pages=pages,
                                         page_block=page_block,
                                         n_heads=n_heads, d_head=d_head,
                                         layers=layers, kv_dtype=kv_dtype,
                                         itemsize=itemsize, steps=1)


def _register_cost_models():
    from ..obs import roofline
    roofline.register_kernel_cost("decode_attention",
                                  _decode_attention_bytes)
    roofline.register_kernel_cost("paged_decode_attention",
                                  _paged_decode_attention_bytes)
    roofline.register_kernel_cost("paged_prefill_attention",
                                  _paged_prefill_attention_bytes)


_register_cost_models()
