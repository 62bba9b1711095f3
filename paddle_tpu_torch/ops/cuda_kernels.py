"""Attention kernels of the serving path — the counterpart of
``paddle_tpu/ops/pallas_kernels.py`` for the two TPU kernels this path
runs:

* :func:`flash_attention_fwd` replaces ``_fa_fwd_kernel`` (prefill);
* :func:`paged_decode_attention` replaces ``_paged_attn_kernel`` (decode).

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``, built
by ``ops/_build.py``) for tensors on the card, and takes the plain PyTorch
version beside it for tensors on the CPU — because they lie on the CPU,
not as a fallback: on a CUDA tensor a wrapper launches or raises. A caller
may also ask for the plain version explicitly with ``route="plain"`` (the
counterpart of the JAX entries' ``route=``), which the solo reference
decode uses on the card.

The plain versions follow the op order of ``_dense_attention`` and
``_dense_decode_attention``. ``SHORT_SEQ_DENSE`` and ``_default_blocks``
of the JAX package are TPU routing constants and set nothing here.

``LAUNCHES`` counts kernel launches per wrapper: a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the CUDA kernels are compiled for
KERNEL_HEAD_DIMS = (64,)

#: launches of every kernel of the port, by kernel (the LSTM wrappers of
#: ops/rnn_kernels.py count here too)
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "paged_decode_attention": 0,
                            "lstm_seq": 0, "lstm_seq_train": 0,
                            "lstm_seq_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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

def flash_attention_fwd_plain(q, k, v, *, causal: bool, scale: float,
                              kv_lens: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked dense attention with the row logsumexp: q [B,T,H,D], k/v
    [B,S,H,D] -> (o [B,T,H,D] in q's dtype, lse [B,T,H] f32). Op order of
    ``_dense_attention``: f32 einsum, * scale, kv_lens mask, causal mask,
    softmax, einsum, cast. ``kv_lens`` arrives clamped to [1, S] by
    :func:`flash_attention_fwd`."""
    T, S = q.shape[1], k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if kv_lens is not None:
        lens = kv_lens.to(device=s.device)
        ok =(torch.arange(S, device=s.device)[None, :]
              < lens[:, None])[:, None, None, :]
        s = torch.where(ok, s, _NEG)
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask[None, None], s, _NEG)
    lse = torch.logsumexp(s, dim=-1).transpose(1, 2).contiguous()
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
    return o, lse


def _flash_attention_fwd_kernel(q, k, v, causal, scale, kv_lens):
    B, T, H, D = q.shape
    S = k.shape[1]
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2:] != (H, D):
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         "as [B, S, H, D]")
    if causal and S != T:
        raise ValueError("flash_attention_fwd: causal needs S == T")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head width {D} not taken by "
                         f"the kernel (built for {KERNEL_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_float(name, t, q.dtype)
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} needs an "
                             "innermost stride of 1")
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    if B == 0 or T == 0:
        return o, lse
    lens = None
    if kv_lens is not None:
        if kv_lens.shape != (B,):
            raise ValueError(f"flash_attention_fwd: kv_lens shape "
                             f"{tuple(kv_lens.shape)} != ({B},)")
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        err = lib.paddle_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, S, H, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None,
                        route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with the row logsumexp — the ``_fa_fwd_call`` contract:
    q [B,T,H,D], k/v [B,S,H,D] (f32 or bf16; ``causal`` assumes S == T),
    optional ``kv_lens`` [B] masking each sample's keys at or past its
    length -> (o [B,T,H,D] in q's dtype, lse [B,T,H] f32).

    A length is clamped to [1, S] on both routes: a sample with no key has
    no softmax support, so it attends key 0 (``flash_attention`` then
    zeroes its output, as the JAX entry does)."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    if kv_lens is not None:
        kv_lens = kv_lens.clamp(1, k.shape[1])
    if _route(route, q, k, v) == "plain":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         scale=scale_v, kv_lens=kv_lens)
    return _flash_attention_fwd_kernel(q, k, v, causal, scale_v, kv_lens)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    route: Optional[str] = None) -> torch.Tensor:
    """Fused attention, the counterpart of ``pallas_kernels.flash_attention``
    (forward only): q [B,T,H,D], k/v [B,S,H,D] -> o [B,T,H,D].

    A sample with ``kv_lens == 0`` has no softmax support: it attends key 0
    and its output is then zeroed, as in the JAX entry."""
    valid = None if kv_lens is None else kv_lens > 0
    o, _ =flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               kv_lens=kv_lens, route=route)
    if valid is not None:
        o = o * valid.to(device=o.device, dtype=o.dtype)[:, None, None, None]
    return o


# ---------------------------------------------------------------------------
# paged decode attention (replaces _paged_attn_kernel)
# ---------------------------------------------------------------------------

def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense per-sample view of a page pool: pool [P, bs, ...] gathered by
    tables [B, NB] -> [B, NB*bs, ...]. The plain version reads through
    this; the kernel never materializes it."""
    B, NB = tables.shape
    g = pool[tables.long()]
    return g.reshape((B, NB * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention_plain(q, k_pool, v_pool, tables, pos, *,
                                 scale: float) -> torch.Tensor:
    """``gather_pages`` + the op order of ``_dense_decode_attention``:
    rows j <= pos[b] live, f32 softmax, o [B, H, D] f32."""
    k = gather_pages(k_pool, tables)
    v = gather_pages(v_pool, tables)
    L = k.shape[1]
    s = torch.einsum("bhd,bjhd->bhj", q.float() * scale, k.float())
    valid = (torch.arange(L, device=s.device)[None, :]
             <= pos.to(s.device)[:, None])[:, None, :]
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhj,bjhd->bhd", p / l, v.float())


def _paged_decode_attention_kernel(q, k_pool, v_pool, tables, pos, scale):
    B, H, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[2:] != (H, D):
        raise ValueError(f"paged_decode_attention: pools {tuple(k_pool.shape)}"
                         f"/{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as [P, bs, H, D]")
    P, bs = k_pool.shape[:2]
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"paged_decode_attention: tables "
                         f"{tuple(tables.shape)} is not [{B}, NB]")
    if pos.shape != (B,):
        raise ValueError(f"paged_decode_attention: pos {tuple(pos.shape)} "
                         f"!= ({B},)")
    NB = tables.shape[1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head width {D} not taken "
                         f"by the kernel (built for {KERNEL_HEAD_DIMS})")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _check_float(name, t, q.dtype)
    if q.stride(-1) != 1:
        raise ValueError("paged_decode_attention: q needs an innermost "
                         "stride of 1")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "contiguous and 16-byte aligned")
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        raise TypeError("paged_decode_attention: tables must be contiguous "
                        "int32")
    pos32 = pos.to(dtype=torch.int32).contiguous()
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return o
    lib = _build.load().lib
    with torch.cuda.device(q.device):
        err = lib.paddle_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos32.data_ptr(), o.data_ptr(),
            B, H, D, bs, NB, q.stride(0), q.stride(1), float(scale),
            _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(err, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return o


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           route: Optional[str] = None) -> torch.Tensor:
    """Single-token attention read through a block table — the
    ``pallas_kernels.paged_decode_attention`` contract: q [B, H, D]; pools
    [P, bs, H, D] f32/bf16; tables [B, NB] int32 whose entries past a
    request's live pages name the null page 0; pos [B] int32 with rows
    j <= pos[b] live and pos[b] < NB*bs. Returns o [B, H, D] f32."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    if _route(route, q, k_pool, v_pool, tables, pos) == "plain":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                            scale=scale_v)
    return _paged_decode_attention_kernel(q, k_pool, v_pool, tables, pos,
                                          scale_v)
