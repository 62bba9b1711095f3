"""The split decode reads on the CPU: the dense reads (#4, and #5 over an
int8 cache, ``csrc/decode.cu``) and the paged reads (#6, and #7 over int8
pools, ``csrc/paged_decode.cu``), which launch the same split body over
other row loaders. Their arithmetic, as a plain PyTorch model, is held
against ``decode_attention_plain`` and, for the paged reads, against the
JAX package's ``paged_decode_attention`` (its Pallas kernel in interpret
mode and its dense route); and the split rule ``decode_splits``.

The kernel splits each (sample, head) read into chunks of rows; each
chunk gives a partial (m, l, acc) — the max of its live scores, the sum
of exp(s - m) and the unnormalized sum of exp(s - m) * v — and the last
block to finish merges the partials in chunk order. An int8 row is
dequantized (code times its row's scale) before its dot product, the
plain version's order. ``_split_read`` below is that computation
written out over whole chunks; it lives here, for the tests alone. A
paged read walks the rows of its sample's pages in table order, so its
model is ``_split_read`` over ``gather_pages`` of the pools. The kernels
themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phases 2 and 9).

Tolerances: atol 1e-5, rtol 1e-4 against the port's plain version — f32
on both sides on the same inputs, summation order only (the f32 decode
tolerance of ``tests/test_torch_decode.py``); against JAX, that file's
``READ_ATOL`` (atol 1e-5, rtol 0) for the same reason.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

ATOL, RTOL = 1e-5, 1e-4
READ_ATOL = 1e-5


def _split_read(q, k, v, pos, scale, splits, chunk, k_scale=None,
                v_scale=None):
    """The split kernel's arithmetic: per chunk of ``chunk`` rows the live
    rows' (m, l, acc) in f32 (a chunk with no live row: m = -1e30, l = 0,
    acc = 0), merged in chunk order with weights exp(m_i - M). With scales
    the int8 rows are dequantized first."""
    B, L, H, D = k.shape
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    n_live = torch.clamp(pos.long() + 1, max=L)                 # [B]
    s = torch.einsum("bhd,bjhd->bhj", q.float() * scale, k.float())
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, L)
        rows = torch.arange(lo, hi)
        live = (rows[None, :] < n_live[:, None])[:, None, :]   # [B, 1, n]
        si = torch.where(live, s[..., lo:hi], ck._NEG)
        m = si.amax(dim=-1)                                     # [B, H]
        p = torch.where(live, torch.exp(si - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhj,bjhd->bhd", p, v[:, lo:hi].float())))
    M = torch.full(parts[0][0].shape, ck._NEG)
    for m, _, _ in parts:
        M = torch.maximum(M, m)
    l_sum, acc = torch.zeros_like(M), torch.zeros(B, H, D)
    for m, l_i, acc_i in parts:
        w = torch.exp(m - M)
        l_sum = l_sum + l_i * w
        acc = acc + acc_i * w[..., None]
    return acc / l_sum[..., None]


def _read(seed, B, L, H=3, D=16, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(B, H, D).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy((rs.randn(B, L, H, D) * 2).astype(np.float32))
            .to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("L", [1, 16, 70, 256, 1000])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
def test_split_read_model_matches_plain(L, splits):
    """Reads whose live rows end inside a chunk, on a chunk boundary, at
    pos = 0 (every chunk past the first empty) and past L (a drained slot):
    the merged partials equal the plain read, with no NaN."""
    n_split, chunk = ck.decode_splits(1, L, splits)
    ends = {0, L - 1, L + 5, chunk - 1, min(chunk, L - 1), L // 2}
    pos = torch.tensor(sorted(ends), dtype=torch.int32)
    q, k, v = _read(L * 31 + splits, len(pos), L)
    scale = q.shape[-1] ** -0.5
    want = ck.decode_attention_plain(q, k, v, pos, scale=scale)
    got = _split_read(q, k, v, pos, scale, n_split, chunk)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_read_model_matches_plain_in_each_cache_dtype(dtype):
    """A bf16 cache is read as f32 on both sides, as the kernel reads it."""
    q, k, v = _read(5, 4, 300, dtype=dtype)
    pos = torch.tensor([0, 64, 150, 299], dtype=torch.int32)
    want = ck.decode_attention_plain(q, k, v, pos, scale=0.25)
    got = _split_read(q, k, v, pos, 0.25, *ck.decode_splits(1, 300, 5))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("L", [1, 70, 256, 1000])
@pytest.mark.parametrize("splits", [1, 3, 8, 16])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_split_int8_read_model_matches_plain(L, splits, qdtype):
    """The int8 read (#5) split likewise, under an f32 or bf16 query: codes
    and scales from ``quantize_kv``, reads ending inside and on chunk
    boundaries, at pos 0 and drained past L."""
    n_split, chunk = ck.decode_splits(1, L, splits)
    ends = {0, L - 1, L + 5, chunk - 1, min(chunk, L - 1), L // 2}
    pos = torch.tensor(sorted(ends), dtype=torch.int32)
    q, k, v = _read(L * 7 + splits, len(pos), L)
    q = q.to(qdtype)
    (kq, ks), (vq, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
    scale = q.shape[-1] ** -0.5
    want = ck.decode_attention_plain(q, kq, vq, pos, scale=scale,
                                     k_scale=ks, v_scale=vs)
    got = _split_read(q, kq, vq, pos, scale, n_split, chunk, ks, vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


# B*H of the smoke paths' dense reads (generate_fused and the benchmark's
# reads: 8 x 12; the speculative draft: 2 x 12), a full card, and one pair
SMOKE_BH = (96, 24, 12, 1, ck.DECODE_TARGET_BLOCKS, 8 * 96)


@pytest.mark.parametrize("bh", SMOKE_BH)
def test_decode_splits_tile_every_read_exactly(bh):
    """For every L up to 1024, the chosen chunks (and those of any asked
    count) tile [0, L): splits * chunk covers L, the last chunk is not
    empty, a chunk is a whole number of 16-row steps unless there is one."""
    for L in range(1, 1025):
        for asked in (None, 2, 5, 64):
            n, chunk = ck.decode_splits(bh, L, asked)
            assert n >= 1 and (n - 1) * chunk < L <= n * chunk, (L, asked)
            if n == 1:
                assert chunk == L
            else:
                assert chunk % 16 == 0


def test_decode_splits_rule():
    """One split where the pairs already fill the target or the read is
    shorter than two chunks; else about the target's blocks, in chunks of
    at least the minimum."""
    target, least = ck.DECODE_TARGET_BLOCKS, ck.DECODE_MIN_CHUNK
    assert ck.decode_splits(target, 1024) == (1, 1024)
    assert ck.decode_splits(1, 2 * least - 1) == (1, 2 * least - 1)
    for bh in (1, 12, 24, 96):
        for L in (256, 512, 1024):
            n, chunk = ck.decode_splits(bh, L)
            assert chunk >= least or n == 1
            assert n <= max(1, -(-target // bh))
    with pytest.raises(ValueError):
        ck.decode_splits(0, 16)


def test_cpu_decode_read_takes_the_plain_version():
    """On the CPU the read is the plain version, over a cache of the
    query's dtype or int8: no launch, no tickets."""
    q, k, v = _read(9, 3, 90)
    pos = torch.tensor([0, 40, 89], dtype=torch.int32)
    before, tickets = dict(ck.LAUNCHES), dict(ck._TICKETS)
    want = ck.decode_attention_plain(q, k, v, pos, scale=0.25)
    got = ck.decode_attention(q, k, v, pos, scale=0.25)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    (kq, ks), (vq, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
    want = ck.decode_attention_plain(q, kq, vq, pos, scale=0.25,
                                     k_scale=ks, v_scale=vs)
    got = ck.decode_attention(q, kq, vq, pos, scale=0.25, k_scale=ks,
                              v_scale=vs)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert ck.LAUNCHES == before and ck._TICKETS == tickets


# ---------------------------------------------------------------------------
# the paged reads (#6, and #7 over int8 pools)
# ---------------------------------------------------------------------------

# (D, bs, NB): 48 rows of 16-wide heads in pages of 8 (chunks of 16 and 32
# rows hold whole pages), and 80 rows of 64-wide heads in pages of 12
# (chunks cut pages)
PAGED_SHAPES = ((16, 8, 6), (64, 12, 5))
# (query dtype, pools): #6 reads pools of the query's dtype, #7 int8
# pools under either query dtype
PAGED_KINDS = (("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "int8"), ("bfloat16", "int8"))
# asked split counts: one block a read, two (ragged at both shapes: 32 + 16
# and 48 + 32 rows), three, five, and decode_splits' own choice
PAGED_SPLITS = (1, 2, 3, 5, None)


@functools.lru_cache(maxsize=None)
def _paged_case(kind, shape):
    """(q, k_pool, v_pool, tables, pos, k_scale, v_scale) with B=4, H=2: a
    null page 0, each sample's live pages drawn from the rest and the null
    page past them; pos at 0, on a page's first row, at NB*bs - 1 and past
    NB*bs."""
    qname, pools = kind
    D, bs, NB = shape
    B, H, P = 4, 2, 4 * NB + 1
    rs = np.random.RandomState(D * 100 + bs * 10 + len(qname) + len(pools))
    k, v = ((rs.randn(P, bs, H, D) * 2).astype(np.float32) for _ in range(2))
    q = rs.randn(B, H, D).astype(np.float32)
    pos = np.array([0, bs, NB * bs - 1, NB * bs + 7], np.int32)
    perm = rs.permutation(np.arange(1, P))
    tables = np.zeros((B, NB), np.int32)
    for b in range(B):
        live = min(int(pos[b]) // bs + 1, NB)
        tables[b, :live] = perm[b * NB:b * NB + live]
    dt = getattr(torch, qname)
    tq = torch.from_numpy(q).to(dt)
    if pools == "int8":
        (tk, ks), (tv, vs) = (ck.quantize_kv(torch.from_numpy(a))
                              for a in (k, v))
    else:
        tk, tv = (torch.from_numpy(a).to(dt) for a in (k, v))
        ks = vs = None
    return (tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(pos),
            ks, vs)


def _jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@functools.lru_cache(maxsize=None)
def _paged_jax(kind, shape, route):
    """JAX's paged_decode_attention on the case: its Pallas kernel in
    interpret mode (route "kernel") or its gather + dense route."""
    q, kp, vp, tables, pos, ks, vs = _paged_case(kind, shape)
    kw = {"interpret": True} if route == "kernel" else {}
    return np.asarray(pk.paged_decode_attention(
        _jax(q), _jax(kp), _jax(vp), _jax(tables), _jax(pos),
        k_scale=_jax(ks), v_scale=_jax(vs), route=route, **kw))


def _paged_split_read(case, splits):
    """The paged kernel's arithmetic at ``splits`` (decode_splits' rounding
    of the asked count): the split read of the gathered pages."""
    q, kp, vp, tables, pos, ks, vs = case
    B, H, D = q.shape
    n, chunk = ck.decode_splits(B * H, tables.shape[1] * kp.shape[1], splits)
    gather = lambda t: None if t is None else ck.gather_pages(t, tables)
    return _split_read(q, gather(kp), gather(vp), pos, D ** -0.5, n, chunk,
                       gather(ks), gather(vs))


@pytest.mark.parametrize("splits", PAGED_SPLITS)
@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("kind", PAGED_KINDS, ids="-".join)
def test_paged_split_read_model_matches_jax(kind, shape, splits):
    """The split paged read at every asked count, in f32, bf16 and int8
    pools (q f32 and bf16), over tables with null-page tails and pos at 0,
    on a page boundary, at NB*bs - 1 and past NB*bs: equal to JAX's
    kernel (interpret mode) and dense route within READ_ATOL, and to the
    port's plain version within the f32 decode tolerance."""
    case = _paged_case(kind, shape)
    got = _paged_split_read(case, splits)
    assert got.shape == case[0].shape and torch.isfinite(got).all()
    for route in ("kernel", "dense"):
        np.testing.assert_allclose(got.numpy(), _paged_jax(kind, shape, route),
                                   atol=READ_ATOL, rtol=0, err_msg=route)
    q, kp, vp, tables, pos, ks, vs = case
    want = ck.paged_decode_attention(q, kp, vp, tables, pos, k_scale=ks,
                                     v_scale=vs)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_splits_tile_the_table_rows(shape):
    """Every asked count gives chunks that tile a sample's NB*bs rows, and
    the serving shapes' choice is whole pages of 64 rows (B=8, H=12: 4 x
    64, 8 x 64 and 8 x 128 rows at NB 4, 8 and 16)."""
    _, bs, NB = shape
    for asked in PAGED_SPLITS + (16,):
        n, chunk = ck.decode_splits(8, NB * bs, asked)
        assert (n - 1) * chunk < NB * bs <= n * chunk
    assert [ck.decode_splits(8 * 12, nb * 64) for nb in (4, 8, 16)] == \
        [(4, 64), (8, 64), (8, 128)]


def test_cpu_paged_read_takes_the_plain_version():
    """On the CPU the paged read is the plain version, over pools of the
    query's dtype or int8: no launch, no tickets."""
    before, tickets = dict(ck.LAUNCHES), dict(ck._TICKETS)
    for kind in (("float32", "float32"), ("float32", "int8")):
        q, kp, vp, tables, pos, ks, vs = _paged_case(kind, PAGED_SHAPES[0])
        want = ck.paged_decode_attention_plain(
            q, kp, vp, tables, pos, scale=0.25, k_scale=ks, v_scale=vs)
        got = ck.paged_decode_attention(q, kp, vp, tables, pos, scale=0.25,
                                        k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert ck.LAUNCHES == before and ck._TICKETS == tickets
