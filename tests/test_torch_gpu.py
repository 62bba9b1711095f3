"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serving path through them.

Every test here needs a CUDA card and skips without one. This file
imports torch and the port only (the machine with the card has no JAX),
so there it runs without the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.serving import ServingEngine

def _bf16_ulp(x):
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _bf16_tc_close(got, want):
    """The bf16 tensor-core bodies (#1's o, #2's dq, #3's dk and dv) against
    the plain version. They round P (#1), dS (#2) and P^T, dS^T (#3) to
    bf16 before the second product, where the plain version keeps f32:
    each term of an entry's sum
    is off by at most 2**-9 of itself, and with terms of mixed sign that
    stays under one bf16 ulp of the tensor's largest magnitude (atol), also
    at entries near zero where the sum cancels; the output's own rounding
    adds one ulp of the entry (rtol 2**-7)."""
    w = want.float()
    torch.testing.assert_close(got.float(), w,
                               atol=_bf16_ulp(w.abs().max().item()),
                               rtol=2.0 ** -7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,T,S", [(True, 100, 100), (False, 70, 130)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, causal, T, S):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, T, 3, 64, generator=gen).to(cuda, dtype)
    k = torch.randn(2, S, 3, 64, generator=gen).to(cuda, dtype)
    v = torch.randn(2, S, 3, 64, generator=gen).to(cuda, dtype)
    lens = torch.tensor([S, S // 3], device=cuda)
    before = ck.LAUNCHES["flash_attention_fwd"]
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens)
    po, plse = ck.flash_attention_fwd(q.float(), k.float(), v.float(),
                                      causal=causal, kv_lens=lens,
                                      route="plain")
    assert ck.LAUNCHES["flash_attention_fwd"] == before + 1
    # f32: summation order only; bf16: the tensor-core body's tolerance
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    else:
        _bf16_tc_close(o, po)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_empty_sample_matches_plain_on_card(cuda, causal):
    """A 0 length (and one past S) gives the same o and lse on both routes:
    ``flash_attention_fwd`` clamps lengths to [1, S] before it routes."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(3, 80, 2, 64, generator=gen).to(cuda)
               for _ in range(3))
    lens = torch.tensor([0, 33, 500], device=cuda)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens)
    po, plse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens,
                                      route="plain")
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_on_card(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    B, H, D, bs, NB, P = 5, 3, 64, 16, 6, 40
    k_pool = torch.randn(P, bs, H, D, generator=gen).to(cuda, dtype)
    v_pool = torch.randn(P, bs, H, D, generator=gen).to(cuda, dtype)
    q = torch.randn(B, H, D, generator=gen).to(cuda, dtype)
    tables = (torch.randperm(P - 1, generator=gen)[:B * NB] + 1).reshape(
        B, NB).to(torch.int32)
    pos = torch.tensor([0, 15, 16, 50, NB * bs - 1], dtype=torch.int32)
    for b in range(B):
        tables[b, int(pos[b]) // bs + 1:] = 0
    args = (q, k_pool, v_pool, tables.to(cuda), pos.to(cuda))
    o = ck.paged_decode_attention(*args)
    po = ck.paged_decode_attention(*args, route="plain")
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)


def _decode_cache(cuda, dtype, gen, B=4, Lmax=96, H=3):
    """q as decode_step passes it (``q[:, 0]`` of a fused projection's
    view) and a [B, Lmax, H, 64] cache, int8 with its scales when ``dtype``
    is a (query dtype, "int8") pair."""
    qdt, kv = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    qkv = torch.randn(B, 1, 3 * H * 64, generator=gen).to(cuda, qdt)
    q = qkv.chunk(3, dim=-1)[0].unflatten(-1, (H, 64))[:, 0]
    k, v = (torch.randn(B, Lmax, H, 64, generator=gen).to(cuda)
            for _ in range(2))
    if kv == "int8":
        (k, ks), (v, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
        return q, k, v, ks, vs
    return q, k.to(qdt), v.to(qdt), None, None


_DECODE_DTYPES = [torch.float32, torch.bfloat16,
                  (torch.float32, "int8"), (torch.bfloat16, "int8")]
# (rows read of a 300-row cache, #4's split count: None = decode_splits'):
# a short read (one split at B*H = 12), a long one that the rule splits,
# and a forced count with a ragged last chunk
_DECODE_READS = {"short": (70, None), "split": (260, None),
                 "forced": (260, 7)}
# every read for every dtype: #5 (int8) splits as #4 does
_DECODE_CASES = [(dt, read) for dt in _DECODE_DTYPES
                 for read in sorted(_DECODE_READS)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, read", _DECODE_CASES)
def test_decode_kernels_match_plain_on_card(cuda, dtype, read):
    """#4 (and #5 over int8) through a [:, :L] view of the cache, pos
    with 0 (every later chunk empty), L-1, a drained value past L and live
    rows that end on a chunk's last row, one row into the next chunk and
    inside a chunk: f32 summation order only (atol 1e-5, rtol 1e-4; the
    output is f32 in every dtype)."""
    gen = torch.Generator().manual_seed(3)
    B, H = 6, 2
    q, k, v, ks, vs = _decode_cache(cuda, dtype, gen, B=B, Lmax=300, H=H)
    Lr, asked = _DECODE_READS[read]
    k, v = k[:, :Lr], v[:, :Lr]
    ks, vs = (None, None) if ks is None else (ks[:, :Lr], vs[:, :Lr])
    assert not k.is_contiguous()
    splits, chunk = ck.decode_splits(B * H, Lr, asked)
    assert (splits > 1) == (read != "short")
    pos = torch.tensor([0, Lr - 1, Lr + 20, chunk - 1, chunk, chunk // 2],
                       dtype=torch.int32, device=cuda)
    name = "decode_attention" if ks is None else "decode_attention_q"

    def read_kernel():
        if asked is None:
            return ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
        return ck._decode_attention_kernel(q, k, v, pos, 64 ** -0.5, ks,
                                           vs, asked)

    before = ck.LAUNCHES[name]
    o = read_kernel()
    po = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs,
                             route="plain")
    assert ck.LAUNCHES[name] == before + 1
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    # the tickets are left zero: a second read agrees
    torch.testing.assert_close(read_kernel(), o, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_int8_decode_read_at_every_split_count_on_card(cuda, qdtype):
    """#5 asked for every split count from 1 to 20 over a 300-row int8
    cache (B=3, H=4; decode_splits rounds chunks to 16-row steps, so 1, 2,
    3, 4, 5, 7, 10 and 19 chunks), reads ending at 0, on a chunk's last row
    and drained: each equal to plain (f32 summation order: atol 1e-5, rtol
    1e-4), one launch a read."""
    gen = torch.Generator().manual_seed(21)
    B, H, L = 3, 4, 300
    q, k, v, ks, vs = _decode_cache(cuda, (qdtype, "int8"), gen, B=B,
                                    Lmax=L, H=H)
    seen = set()
    for asked in range(1, 21):
        n, chunk = ck.decode_splits(B * H, L, asked)
        seen.add(n)
        pos = torch.tensor([0, chunk - 1, L + 9][:B], dtype=torch.int32,
                           device=cuda)
        before = ck.LAUNCHES["decode_attention_q"]
        o = ck._decode_attention_kernel(q, k, v, pos, 64 ** -0.5, ks, vs,
                                        asked)
        po = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs,
                                 route="plain")
        assert ck.LAUNCHES["decode_attention_q"] == before + 1
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    assert seen == {1, 2, 3, 4, 5, 7, 10, 19}


@pytest.mark.gpu
def test_dense_and_int8_split_reads_share_the_tickets_on_card(cuda):
    """A split #4 read and a split #5 read of the same (sample, head) count
    back to back on one stream, many times: they share the stream's
    ticket buffer, each leaves it zero for the next, and every read equals
    plain."""
    gen = torch.Generator().manual_seed(22)
    B, H, L = 2, 3, 512
    q, k, v, _, _ = _decode_cache(cuda, torch.bfloat16, gen, B=B, Lmax=L,
                                  H=H)
    q8, k8, v8, ks, vs = _decode_cache(cuda, (torch.float32, "int8"), gen,
                                       B=B, Lmax=L, H=H)
    assert ck.decode_splits(B * H, L)[0] > 1
    pos = torch.tensor([L - 1, 130], dtype=torch.int32, device=cuda)
    want = ck.decode_attention(q, k, v, pos, route="plain")
    want8 = ck.decode_attention(q8, k8, v8, pos, k_scale=ks, v_scale=vs,
                                route="plain")
    outs = []
    for _ in range(16):
        outs.append((ck.decode_attention(q, k, v, pos), want))
        outs.append((ck.decode_attention(q8, k8, v8, pos, k_scale=ks,
                                         v_scale=vs), want8))
    torch.cuda.synchronize(cuda)
    for o, w in outs:
        torch.testing.assert_close(o, w, atol=1e-5, rtol=1e-4)


def _split_read_inputs(cuda, seed):
    """A bf16 read that decode_splits splits (B*H = 4, 512 rows), its
    pos and the plain version's output."""
    gen = torch.Generator().manual_seed(seed)
    B, H, Lr = 2, 2, 512
    q, k, v, _, _ = _decode_cache(cuda, torch.bfloat16, gen, B=B, Lmax=Lr,
                                  H=H)
    assert ck.decode_splits(B * H, Lr)[0] > 1
    pos = torch.tensor([Lr - 1, 200], dtype=torch.int32, device=cuda)
    return (q, k, v, pos), ck.decode_attention(q, k, v, pos, route="plain")


@pytest.mark.gpu
def test_split_decode_reads_on_two_streams_on_card(cuda):
    """Split reads (#4) issued on two streams of one card at once: each
    stream has its own tickets, so every read equals plain, and a read on
    the default stream afterwards still does."""
    args, want = _split_read_inputs(cuda, 5)
    main = torch.cuda.current_stream(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    outs = []
    for s in streams:
        s.wait_stream(main)
    for _ in range(32):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(ck.decode_attention(*args))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize(cuda)
    for o in outs:
        torch.testing.assert_close(o, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(ck.decode_attention(*args), want, atol=1e-5,
                               rtol=1e-4)


@pytest.mark.gpu
def test_split_decode_read_in_a_graph_capture_on_card(cuda):
    """A capture that would be the first to make its stream's tickets
    raises; once an eager read on the capture stream has made them, the
    captured read replays equal to plain, with eager reads on the default
    stream between the replays."""
    args, want = _split_read_inputs(cuda, 6)
    side = torch.cuda.Stream(cuda)
    ck._TICKETS.pop((side.device_index, side.cuda_stream), None)
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            ck.decode_attention(*args)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        ck.decode_attention(*args)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = ck.decode_attention(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(cuda)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(ck.decode_attention(*args), want,
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_paged_int8_kernel_matches_plain_on_card(cuda, qdtype):
    """#7 over int8 pools with null-page table tails."""
    gen = torch.Generator().manual_seed(4)
    B, H, bs, NB, P = 5, 3, 16, 6, 40
    (kp, ksp), (vp, vsp) = (ck.quantize_kv(
        torch.randn(P, bs, H, 64, generator=gen).to(cuda)) for _ in range(2))
    q = torch.randn(B, H, 64, generator=gen).to(cuda, qdtype)
    tables = (torch.randperm(P - 1, generator=gen)[:B * NB] + 1).reshape(
        B, NB).to(torch.int32)
    pos = torch.tensor([0, 15, 16, 50, NB * bs - 1], dtype=torch.int32)
    for b in range(B):
        tables[b, int(pos[b]) // bs + 1:] = 0
    args = (q, kp, vp, tables.to(cuda), pos.to(cuda))
    before = ck.LAUNCHES["paged_decode_attention_q"]
    o = ck.paged_decode_attention(*args, k_scale=ksp, v_scale=vsp)
    po = ck.paged_decode_attention(*args, k_scale=ksp, v_scale=vsp,
                                   route="plain")
    assert ck.LAUNCHES["paged_decode_attention_q"] == before + 1
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the paged reads (#6, #7) on the split body of #4 and #5
# ---------------------------------------------------------------------------

def _paged_read(cuda, dtype, gen, pos, B=3, H=4, bs=20, NB=15):
    """q [B, H, 64], pools over a null page 0 (int8 with scales when
    ``dtype`` is a (query dtype, "int8") pair), tables whose live pages are
    drawn from the rest with the null page past them, and pos: the
    arguments of paged_decode_attention and the scales."""
    qdt, kv = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    P = B * NB + 1
    k, v = (torch.randn(P, bs, H, 64, generator=gen).to(cuda)
            for _ in range(2))
    q = torch.randn(B, H, 64, generator=gen).to(cuda, qdt)
    perm = torch.randperm(P - 1, generator=gen) + 1
    tables = torch.zeros(B, NB, dtype=torch.int32)
    for b in range(B):
        live = min(int(pos[b]) // bs + 1, NB)
        tables[b, :live] = perm[b * NB:b * NB + live]
    if kv == "int8":
        (k, ks), (v, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
    else:
        k, v, ks, vs = k.to(qdt), v.to(qdt), None, None
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    return (q, k, v, tables.to(cuda), pos), (ks, vs)


def _paged_kernel(args, scales, splits=None, carry=True):
    return ck._paged_decode_attention_kernel(*args, 64 ** -0.5, *scales,
                                             splits=splits, carry=carry)


def _paged_name(scales):
    return "paged_decode_attention" + ("" if scales[0] is None else "_q")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DECODE_DTYPES)
def test_paged_reads_at_every_split_count_on_card(cuda, dtype):
    """#6 (and #7 over int8) asked for every split count from 1 to 16 over
    15 pages of 20 rows (chunks of 16-row steps cut pages; 1, 2, 3, 4, 5,
    7 and 10 chunks, the last ragged but for one), reads ending at 0, on a
    chunk's last row and past NB*bs: each equal to plain (f32 summation
    order: atol 1e-5, rtol 1e-4), one launch a read, and the per-row
    table lookup bit-equal to the carried one."""
    gen = torch.Generator().manual_seed(31)
    L, seen = 300, set()
    for asked in range(1, 17):
        n, chunk = ck.decode_splits(3 * 4, L, asked)
        seen.add(n)
        args, scales = _paged_read(cuda, dtype, gen, [0, chunk - 1, L + 9])
        name = _paged_name(scales)
        before = ck.LAUNCHES[name]
        o = _paged_kernel(args, scales, asked)
        assert ck.LAUNCHES[name] == before + 1
        po = ck.paged_decode_attention(*args, k_scale=scales[0],
                                       v_scale=scales[1], route="plain")
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
        assert torch.equal(_paged_kernel(args, scales, asked, carry=False),
                           o)
    assert seen == {1, 2, 3, 4, 5, 7, 10}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DECODE_DTYPES)
@pytest.mark.parametrize("bs,NB", [(6, 40), (20, 13), (64, 4)])
def test_paged_reads_equal_dense_reads_of_their_pages_on_card(cuda, dtype,
                                                              bs, NB):
    """At the same split count the paged read equals the dense read (#4,
    #5) of ``gather_pages`` of the same pools bit for bit, with the table
    carried or looked up a row at a time, and two runs are bit-equal:
    pages smaller than a row group's step (6 rows), cut by it (20) and
    whole (64); pos at 0, on a page boundary, at NB*bs - 1 and past it."""
    gen = torch.Generator().manual_seed(32 + bs)
    L = NB * bs
    args, scales = _paged_read(cuda, dtype, gen, [0, bs, L - 1, L + 3],
                               B=4, H=3, bs=bs, NB=NB)
    q, kp, vp, tables, pos = args
    gather = lambda t: None if t is None else ck.gather_pages(t, tables)
    for asked in (1, 2, 3, 7, None):
        dense = ck._decode_attention_kernel(
            q, gather(kp), gather(vp), pos, 64 ** -0.5, gather(scales[0]),
            gather(scales[1]), asked)
        paged = _paged_kernel(args, scales, asked)
        assert torch.equal(paged, dense), asked
        assert torch.equal(_paged_kernel(args, scales, asked, carry=False),
                           dense), asked
        assert torch.equal(_paged_kernel(args, scales, asked), paged), asked


@pytest.mark.gpu
def test_paged_and_dense_split_reads_share_the_tickets_on_card(cuda):
    """Split reads of all four kinds (#4, #5, #6, #7) on the same (sample,
    head) pairs back to back on one stream, many times: they share the
    stream's ticket buffer, each leaves it zero for the next, and every
    read equals plain."""
    gen = torch.Generator().manual_seed(33)
    B, H, bs, NB = 2, 3, 64, 8
    assert ck.decode_splits(B * H, NB * bs)[0] > 1
    pos = [NB * bs - 1, 130]
    reads = []
    for dtype in (torch.bfloat16, (torch.float32, "int8")):
        args, (ks, vs) = _paged_read(cuda, dtype, gen, pos, B=B, H=H, bs=bs,
                                     NB=NB)
        q, kp, vp, tables, p32 = args
        g = lambda t: None if t is None else ck.gather_pages(t, tables)
        reads.append(functools.partial(ck.paged_decode_attention, *args,
                                       k_scale=ks, v_scale=vs))
        reads.append(functools.partial(ck.decode_attention, q, g(kp), g(vp),
                                       p32, k_scale=g(ks), v_scale=g(vs)))
    want = [read(route="plain") for read in reads]
    outs = []
    for _ in range(16):
        outs += [(read(), w) for read, w in zip(reads, want)]
    torch.cuda.synchronize(cuda)
    for o, w in outs:
        torch.testing.assert_close(o, w, atol=1e-5, rtol=1e-4)


def _paged_split_inputs(cuda, seed):
    """A bf16 paged read that decode_splits splits (B*H = 4, 8 pages of
    64 rows) and the plain version's output."""
    gen = torch.Generator().manual_seed(seed)
    args, _ = _paged_read(cuda, torch.bfloat16, gen, [511, 200], B=2, H=2,
                          bs=64, NB=8)
    assert ck.decode_splits(4, 512)[0] > 1
    return args, ck.paged_decode_attention(*args, route="plain")


@pytest.mark.gpu
def test_split_paged_reads_on_two_streams_on_card(cuda):
    """Split paged reads (#6) issued on two streams of one card at once:
    each stream has its own tickets, so every read equals plain, and a
    read on the default stream afterwards still does."""
    args, want = _paged_split_inputs(cuda, 34)
    main = torch.cuda.current_stream(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(main)
    for _ in range(32):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(ck.paged_decode_attention(*args))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize(cuda)
    for o in outs:
        torch.testing.assert_close(o, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(ck.paged_decode_attention(*args), want,
                               atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_split_paged_read_in_a_graph_capture_on_card(cuda):
    """A capture that would be the first to make its stream's tickets
    raises; after an eager paged read on the capture stream, the captured
    read replays equal to plain, with eager reads between the replays."""
    args, want = _paged_split_inputs(cuda, 35)
    side = torch.cuda.Stream(cuda)
    ck._TICKETS.pop((side.device_index, side.cuda_stream), None)
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            ck.paged_decode_attention(*args)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        ck.paged_decode_attention(*args)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = ck.paged_decode_attention(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(cuda)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(ck.paged_decode_attention(*args), want,
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_decode_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(5)
    q, k, v, _, _ = _decode_cache(cuda, torch.float32, gen)
    pos = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ck.decode_attention(q, k.to(torch.bfloat16), v, pos)
    with pytest.raises(TypeError, match="dtype"):
        ck.decode_attention(q.half(), k.half(), v.half(), pos)
    # widths past 256 (ROADMAP B.1.5)
    wide = torch.randn(4, 96, 3, 264, device=cuda)
    with pytest.raises(ValueError, match="B.1.5"):
        ck.decode_attention(torch.randn(4, 3, 264, device=cuda), wide, wide,
                            pos)
    # a cache 8 bytes off a 16-byte boundary, and one with odd strides
    off = torch.empty(4 * 96 * 3 * 64 + 2, device=cuda)[2:].view(4, 96, 3,
                                                                 64)
    with pytest.raises(ValueError, match="aligned"):
        ck.decode_attention(q, off, off, pos)
    big = torch.empty(4, 96, 3, 65, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="multiples of 8|aligned"):
        ck.decode_attention(q, big, big, pos)
    k8, ks = ck.quantize_kv(k)
    with pytest.raises(TypeError, match="int8"):
        ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="k_scale"):
        ck.decode_attention(q, k8, k8, pos, k_scale=ks[:, :5],
                            v_scale=ks[:, :5])
    pool = torch.empty(10 * 16 * 3 * 64 + 2, device=cuda)[2:].view(
        10, 16, 3, 64)
    tables = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ck.paged_decode_attention(q, pool, pool, tables, pos)
    with pytest.raises(TypeError, match="int32"):
        ck.paged_decode_attention(q, pool.clone(), pool.clone(),
                                  tables.long(), pos)
    with pytest.raises(ValueError, match="empty"):
        ck.paged_decode_attention(q, pool.clone(), pool.clone(),
                                  tables[:, :0], pos)
    # the C entries check the split arguments they are handed (the
    # wrappers' decode_splits always tiles): chunks that leave rows out,
    # an empty last chunk, no count, a chunk of 0 and a split read without
    # its scratch each return cudaErrorInvalidValue (1) and launch nothing
    lib = ck._build.load().lib
    pool, o = torch.zeros(9, 16, 3, 64, device=cuda), torch.empty_like(q)
    pool8, sc = torch.zeros(9, 16, 3, 64, dtype=torch.int8,
                            device=cuda), torch.ones(9, 16, 3, device=cuda)
    tables = torch.ones(4, 4, dtype=torch.int32, device=cuda)
    part = torch.empty(4 * 3 * 8 * 66, device=cuda)
    tk = torch.zeros(4 * 3, dtype=torch.int32, device=cuda)
    st = torch.cuda.current_stream(cuda).cuda_stream
    k64, k8, ks64 = k[:, :64], ck.quantize_kv(k[:, :64])[0], ks[:, :64]
    for splits, chunk, scratch in ((2, 16, True), (5, 16, True),
                                   (0, 64, True), (1, 0, True),
                                   (2, 32, False)):
        p, t = (part.data_ptr(), tk.data_ptr()) if scratch else (None, None)
        split = (p, t, 4, 3, 64)
        common = (q.stride(0), q.stride(1), 0.125, 0, st)
        errs = [
            lib.paddle_paged_decode_attention(
                q.data_ptr(), pool.data_ptr(), pool.data_ptr(),
                tables.data_ptr(), pos.data_ptr(), o.data_ptr(), *split, 16,
                4, splits, chunk, 1, *common),
            lib.paddle_paged_decode_attention_q(
                q.data_ptr(), pool8.data_ptr(), sc.data_ptr(),
                pool8.data_ptr(), sc.data_ptr(), tables.data_ptr(),
                pos.data_ptr(), o.data_ptr(), *split, 16, 4, splits, chunk,
                1, *common),
            lib.paddle_decode_attention(
                q.data_ptr(), k64.data_ptr(), k64.data_ptr(), pos.data_ptr(),
                o.data_ptr(), *split, 64, splits, chunk, q.stride(0),
                q.stride(1), *k64.stride()[:3], 0.125, 0, st),
            lib.paddle_decode_attention_q(
                q.data_ptr(), k8.data_ptr(), ks64.data_ptr(), k8.data_ptr(),
                ks64.data_ptr(), pos.data_ptr(), o.data_ptr(), *split, 64,
                splits, chunk, q.stride(0), q.stride(1), *k8.stride()[:3],
                *ks64.stride(), 0.125, 0, st)]
        assert errs == [1, 1, 1, 1], (splits, chunk, scratch, errs)


@pytest.mark.gpu
def test_dense_decode_paths_on_card_match_plain_decode(cuda):
    """A small model with 64-wide heads on the card: generate_fused (f32
    and int8 KV, bucketed reads crossing 64 -> 128 rows) and the int8
    ContinuousBatcher and ServingEngine give the tokens of the same loop on
    the plain route, each
    decode kernel launched 2 x its decode steps."""
    from paddle_tpu_torch.serving import ContinuousBatcher, Request
    model = TransformerLM(101, d_model=128, n_heads=2, n_layers=2,
                          max_len=256).init(seed=4, device=cuda)
    rs = np.random.RandomState(6)
    ids = torch.as_tensor(rs.randint(0, 101, (3, 50)), device=cuda)
    for kv, name in ((None, "decode_attention"),
                     ("int8", "decode_attention_q")):
        ck.reset_launch_counts()
        got = model.generate_fused(ids, 30, bucket=64, kv_dtype=kv)
        assert ck.LAUNCHES[name] == 2 * 29
        want = model.generate_fused(ids, 30, bucket=64, kv_dtype=kv,
                                    route="plain")
        assert torch.equal(got, want)
    work = [(rs.randint(0, 101, int(n)), int(m))
            for n, m in ((70, 20), (5, 9), (33, 30), (120, 12))]
    solo = [model.generate_fused(
        torch.as_tensor(p[None], device=cuda), n, kv_dtype="int8",
        route="plain")[0, len(p):].cpu().tolist() for p, n in work]
    ck.reset_launch_counts()
    b = ContinuousBatcher(model, slots=3, segment=8, cache_bucket=64,
                          kv_dtype="int8", device=cuda)
    got = b.serve([Request(i, p, n) for i, (p, n) in enumerate(work)])
    assert ck.LAUNCHES["decode_attention_q"] == 2 * 8 * b.segments_total
    assert [got[i].tolist() for i in range(len(work))] == solo
    ck.reset_launch_counts()
    eng = ServingEngine(model, slots=3, segment=8, page_block=16,
                        cache_bucket=64, kv_dtype="int8", device=cuda)
    rids = [eng.submit(p, n) for p, n in work]
    while not all(eng.poll(r)[1] for r in rids):
        eng.step()
    assert ck.LAUNCHES["paged_decode_attention_q"] == \
        2 * eng.pool.segments_total * eng.pool.segment
    assert [eng.poll(r)[0] for r in rids] == solo


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    # widths past 256 (ROADMAP B.1.5)
    for D in (264, 320):
        q = torch.randn(1, 8, 2, D, device=cuda)
        with pytest.raises(ValueError, match="B.1.5"):
            ck.flash_attention_fwd(q, q, q)
    h = torch.randn(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        ck.flash_attention_fwd(h, h, h)


@pytest.mark.gpu
def test_engine_on_card_matches_solo_plain_decode(cuda):
    """A small model with 64-wide heads through ServingEngine.step() on the
    card: every greedy continuation equals the solo full re-forward with
    plain attention, and both kernels launched 2 x dispatches times."""
    model = TransformerLM(101, d_model=128, n_heads=2, n_layers=2,
                          max_len=256).init(seed=3, device=cuda)
    rs = np.random.RandomState(4)
    work = [(rs.randint(0, 101, int(n)), int(m))
            for n, m in ((70, 20), (5, 9), (33, 30), (120, 12), (17, 25))]
    ck.reset_launch_counts()
    eng = ServingEngine(model, slots=3, segment=8, page_block=16,
                        cache_bucket=64, device=cuda)
    rids = [eng.submit(p, n) for p, n in work]
    while not all(eng.poll(r)[1] for r in rids):
        eng.step()
    pool = eng.pool
    assert ck.LAUNCHES["flash_attention_fwd"] == 2 * pool.admissions_total
    assert ck.LAUNCHES["paged_decode_attention"] == \
        2 * pool.segments_total * pool.segment
    for r, (p, n) in zip(rids, work):
        ids = torch.as_tensor(p[None].astype(np.int64), device=cuda)
        want = model.generate_greedy(ids, n, route="plain")[0, len(p):]
        assert eng.poll(r)[0] == want.cpu().tolist()
    assert pool.pages_used == 0


@pytest.mark.gpu
def test_engines_on_two_threads_capture_at_once_on_card(cuda):
    """Two ServingEngines of one process started together (a routed
    fleet's decode workers, each on its scheduler thread) capture their
    graphs at the same time: the captures run one at a time
    (core/graphs.py ``_CAPTURE_LOCK``), both engines serve every request
    the solo plain decode's tokens, and the launches counted are both
    engines' own, none dropped by the other's capture."""
    import time
    model = TransformerLM(101, d_model=256, n_heads=2, n_layers=2,
                          max_len=256).init(seed=5, device=cuda)
    rs = np.random.RandomState(6)
    work = [(rs.randint(0, 101, int(n)), 24) for n in (40, 7, 90, 23)]
    ck.reset_launch_counts()
    engines = [ServingEngine(model, slots=2, segment=8, page_block=16,
                             cache_bucket=64, device=cuda)
               for _ in range(2)]
    rids = [[e.submit(p, n) for p, n in work] for e in engines]
    for e in engines:
        e.start()
    deadline = time.monotonic() + 120.0
    try:
        while not all(e.poll(r)[1] for e, rs_ in zip(engines, rids)
                      for r in rs_):
            assert time.monotonic() < deadline, "engines did not finish"
            assert all(e.failed is None for e in engines), \
                [e.failed for e in engines]
            time.sleep(0.01)
    finally:
        for e in engines:
            e.stop()
    for e, rs_ in zip(engines, rids):
        for r, (p, n) in zip(rs_, work):
            ids = torch.as_tensor(p[None].astype(np.int64), device=cuda)
            want = model.generate_greedy(ids, n, route="plain")[0, len(p):]
            assert e.poll(r)[0] == want.cpu().tolist()
    segments = sum(e.pool.segments_total for e in engines)
    admissions = sum(e.pool.admissions_total for e in engines)
    assert ck.LAUNCHES["flash_attention_fwd"] == 2 * admissions
    assert ck.LAUNCHES["paged_decode_attention"] == 2 * segments * 8


# ---------------------------------------------------------------------------
# the LSTM sequence kernels (ops/rnn_kernels.py) and a training step
# ---------------------------------------------------------------------------

def _lstm_close(got, want, dtype, du=False):
    """f32: summation order only (atol 1e-5, rtol 1e-4); bf16: one
    rounding of the same f32 value (one bf16 ulp, rtol 2**-7); du: an f32
    sum of B*T products (rtol 1e-4, atol 1e-5 of its largest magnitude)."""
    if du:
        atol, rtol = 1e-5 * want.abs().max().item(), 1e-4
    elif dtype == torch.float32:
        atol, rtol = 1e-5, 1e-4
    else:
        atol, rtol = 1e-6, 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,lens", [
    (5, 7, 256, [0, 1, 7, 3, 5]),          # the edge shape: one tile
    (40, 9, 64, None),                     # two batch tiles, H != 256
    (3, 1, 8, [1, 0, 1]),                  # a single step, two units
])
def test_lstm_kernels_match_plain_on_card(cuda, dtype, B, T, H, lens):
    from paddle_tpu_torch.ops import rnn_kernels as rk
    gen = torch.Generator().manual_seed(5)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    if lens is None:
        lens = torch.randint(0, T + 1, (B,), generator=gen).tolist()
    fwd = (rnd(B, T, 4 * H, scale=0.5),
           torch.tensor(lens, dtype=torch.int32, device=cuda),
           rnd(H, 4 * H, scale=0.05), rnd(4 * H, scale=0.1),
           rnd(B, H, scale=0.5), rnd(B, H, scale=0.5))
    before = dict(ck.LAUNCHES)
    for save in (False, True):
        got = rk.lstm_sequence_fused(*fwd, forget_bias=1.0, save_cell=save)
        want = rk.lstm_sequence_fused(*fwd, forget_bias=1.0, save_cell=save,
                                      route="plain")
        for g, w in zip(got, want):
            _lstm_close(g, w, dtype)
    out, c_seq = want[0], want[3]
    cot = (rnd(B, T, H, scale=0.1), rnd(B, H, scale=0.1),
           rnd(B, H, scale=0.1))
    got = rk.lstm_sequence_fused_bwd(*fwd, out, c_seq, *cot, forget_bias=1.0)
    want = rk.lstm_sequence_fused_bwd(*fwd, out, c_seq, *cot,
                                      forget_bias=1.0, route="plain")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype
        _lstm_close(g, w, dtype, du=i == 3)
    for name in ("lstm_seq", "lstm_seq_train", "lstm_seq_bwd"):
        assert ck.LAUNCHES[name] == before[name] + 1


@pytest.mark.gpu
def test_lstm_kernels_refuse_what_they_do_not_take(cuda):
    from paddle_tpu_torch.ops import rnn_kernels as rk
    xw = torch.randn(2, 3, 4 * 10, device=cuda)
    u = torch.randn(10, 40, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        rk.lstm_sequence_fused(xw, torch.tensor([3, 1]), u)
    with pytest.raises(TypeError, match="dtype"):
        rk.lstm_sequence_fused(torch.randn(2, 3, 32, device=cuda),
                               torch.tensor([3, 1]),
                               torch.randn(8, 32, device=cuda,
                                           dtype=torch.bfloat16))
    # 64 x 64 blocks cannot all be resident for the grid barrier: the
    # wrapper routes such a batch to row tiles, and handed straight to the
    # kernel with a plan for the whole batch the launch raises
    big = torch.randn(2048, 1, 1024, device=cuda)
    ones = torch.ones(2048, dtype=torch.int32, device=cuda)
    u = torch.randn(256, 1024, device=cuda)
    z = torch.zeros(2048, 256, device=cuda)
    plan = rk.forward_plans("lstm", 64, 256)[0]
    with pytest.raises(ValueError, match="split the batch"):
        rk._lstm_sequence_fused_kernel(big, ones, u, torch.zeros(
            1024, device=cuda), z, z, 0.0, False, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_flagship_shape_is_bit_equal_across_runs(cuda, dtype):
    """#10 at the flagship text classifier's shape (B=64: two batch tiles,
    T=100, H=256, lengths 30..100): within the LSTM tolerance of the plain
    version, and bit-equal across two runs (its dh partials and dU tiles
    are summed in a fixed order, no atomics)."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    B, T, H = 64, 100, 256
    gen = torch.Generator().manual_seed(19)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    lens = torch.randint(30, T + 1, (B,), generator=gen).to(cuda,
                                                            torch.int32)
    fwd = (rnd(B, T, 4 * H, scale=0.5), lens,
           ((torch.rand((H, 4 * H), generator=gen) - 0.5) * 0.16).to(
               cuda, dtype), rnd(4 * H, scale=0.1),
           torch.zeros(B, H, device=cuda, dtype=dtype),
           torch.zeros(B, H, device=cuda, dtype=dtype))
    out, _, _, c_seq = rk.lstm_sequence_fused(*fwd, forget_bias=1.0,
                                              save_cell=True, route="plain")
    cot = (rnd(B, T, H, scale=0.01), rnd(B, H, scale=0.01),
           rnd(B, H, scale=0.01))
    args = fwd + (out, c_seq) + cot
    got = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0)
    again = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0)
    want = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0, route="plain")
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a)
        _lstm_close(g, w, dtype, du=i == 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(128, 6, 256), (20, 5, 512), (5, 4, 12)])
def test_lstm_bwd_at_the_grid_limits_on_card(cuda, dtype, B, T, H):
    """#10 where its grid needs two blocks an SM (B=128, H=256: 256
    blocks, a smaller shared-memory plan), at H=512 (one block an SM, one
    step a stage) and at H=12 (bf16 rows of 24 bytes: 8-byte copies;
    zero-padded hidden columns), against the plain version."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    gen = torch.Generator().manual_seed(23)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    lens = torch.randint(0, T + 1, (B,), generator=gen).to(cuda,
                                                           torch.int32)
    fwd = (rnd(B, T, 4 * H, scale=0.5), lens, rnd(H, 4 * H, scale=0.05),
           rnd(4 * H, scale=0.1), rnd(B, H, scale=0.5), rnd(B, H, scale=0.5))
    out, _, _, c_seq = rk.lstm_sequence_fused(*fwd, forget_bias=1.0,
                                              save_cell=True, route="plain")
    args = fwd + (out, c_seq, rnd(B, T, H, scale=0.1), rnd(B, H, scale=0.1),
                  rnd(B, H, scale=0.1))
    got = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0)
    want = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0, route="plain")
    for i, (g, w) in enumerate(zip(got, want)):
        _lstm_close(g, w, dtype, du=i == 3)


@pytest.mark.gpu
def test_textcls_training_step_matches_plain_on_card(cuda):
    """One f32 Adam step of the LSTM text classifier through the kernels
    equals the same step with the plain versions (grads read as Adam's
    first moment; the params to atol 1e-5), one launch of each training
    kernel per step."""
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = LSTMTextCls(500, 32, 64, pool="last").init(seed=1, device=cuda)
    gen = torch.Generator().manual_seed(6)
    batch = (torch.randint(0, 500, (37, 20), generator=gen),
             torch.randint(1, 21, (37,), generator=gen),
             torch.randint(0, 2, (37,), generator=gen))
    res = {}
    for route in (None, "plain"):
        loss = (lambda r: lambda p, d, ln, y: model.call(
            p, SeqBatch(d, ln), y, route=r))(route)
        tr = Trainer(loss, Adam(2e-3), device=cuda)
        before = dict(ck.LAUNCHES)
        res[route] = tr.step(model.tree(), tr.opt.init(model.tree()), *batch)
        launched = {k: ck.LAUNCHES[k] - before[k]
                    for k in ("lstm_seq_train", "lstm_seq_bwd")}
        assert launched == ({"lstm_seq_train": 1, "lstm_seq_bwd": 1}
                            if route is None else
                            {"lstm_seq_train": 0, "lstm_seq_bwd": 0})
    (pk, sk, lk), (pp, sp, lp) = res[None], res["plain"]
    assert abs(lk.item() - lp.item()) < 1e-5
    for (path, a), (_, b) in zip(tree_items(sk["slots"]),
                                 tree_items(sp["slots"])):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item(),
                                   msg="/".join(path))
    for (path, a), (_, b) in zip(tree_items(pk), tree_items(pp)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5,
                                   msg="/".join(path))


# ---------------------------------------------------------------------------
# the flash-attention backward kernels (#2 dq, #3 dk/dv) and transformer
# training steps
# ---------------------------------------------------------------------------

def _bwd_close(got, want, dtype):
    """f32: summation order only (rtol 1e-4, atol 2e-5 of the largest
    magnitude: dk sums up to T products); bf16: the same f32 values
    rounded once, so one bf16 ulp (rtol 2**-7) on top."""
    atol = 2e-5 * want.float().abs().max().item()
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# chip_smoke.py's phase-6 shapes: (B, T, S, H, causal, lengths, q/k/v as
# views of one fused projection); "ring" has more k tiles (#1) and q
# tiles (#3) than the bf16 bodies' two ring stages at every block, ragged
# at both ends
_BWD_SHAPES = {
    "lm": (8, 1023, 1023, 12, True, None, False),
    "nmt": (64, 64, 64, 8, False, "32..64 and a 0", False),
    "cross": (16, 100, 77, 8, False, "1..S", False),
    "fused": (4, 300, 300, 12, True, "1..S", True),
    "ring": (3, 330, 330, 2, False, "1..S", False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(_BWD_SHAPES))
def test_flash_bwd_kernels_match_plain_on_card(cuda, dtype, shape):
    B, T, S, H, causal, lens, fused = _BWD_SHAPES[shape]
    gen = torch.Generator().manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda, dtype)
    if fused:
        qkv = rnd(B, T, 3 * H * 64)
        q, k, v = (t.unflatten(-1, (H, 64)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = rnd(B, T, H, 64), rnd(B, S, H, 64), rnd(B, S, H, 64)
    kv_lens = None
    if lens is not None:
        lo = 32 if shape == "nmt" else 1
        kv_lens = torch.randint(lo, S + 1, (B,), generator=gen)
        kv_lens[1] = 0 if shape == "nmt" else S
        kv_lens = kv_lens.to(cuda)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens,
                                    route="plain")
    # the forward (#1) at the same shape; in bf16 its tensor-core body
    ko, klse = ck.flash_attention_fwd(q, k, v, causal=causal,
                                      kv_lens=kv_lens)
    if dtype == torch.float32:
        torch.testing.assert_close(ko, o, atol=1e-5, rtol=1e-4)
    else:
        _bf16_tc_close(ko, o)
    torch.testing.assert_close(klse, lse, atol=1e-5, rtol=1e-4)
    do = rnd(B, T, H, 64)
    before = dict(ck.LAUNCHES)
    got = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 kv_lens=kv_lens)
    want = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  kv_lens=kv_lens, route="plain")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert ck.LAUNCHES[name] == before[name] + 1
    # in bf16, dq, dk and dv come from the tensor-core bodies of #2, #3
    close = (_bf16_tc_close if dtype == torch.bfloat16
             else lambda g, w: _bwd_close(g, w, dtype))
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        close(g, w)
    if kv_lens is not None:            # masked keys: exactly zero dk, dv
        for b, n in enumerate(kv_lens.clamp(1, S).tolist()):
            assert not got[1][b, n:].any() and not got[2][b, n:].any()
    # with delta given, the dq kernel reads it instead of computing it
    delta = torch.sum(do.float() * o.float(), dim=-1)
    given = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   kv_lens=kv_lens, delta=delta)
    for g, w in zip(given, want):
        close(g, w)


@pytest.mark.gpu
def test_flash_bf16_refuses_views_that_break_the_tma_rule(cuda):
    """The bf16 bodies load q, k and v by TMA, and the f32 bodies (the
    forward and the backward) by 16-byte cp.async copies, both under the
    16-byte rule: a view whose base is not 16-byte aligned, or whose
    stride is not a multiple of 16 bytes, is copied into a contiguous
    buffer by the wrapper (the ``copy16`` route, counted in ROUTES) and
    gives the plain version's result; f32 views that keep the rule are
    read in place (no route counted)."""
    good = torch.randn(2, 40, 3, 64, device=cuda, dtype=torch.bfloat16)
    wide = torch.randn(2, 40, 3, 68, device=cuda)
    flat = torch.randn(2 * 40 * 3 * 64 + 1, device=cuda)
    bad = [wide.to(torch.bfloat16)[..., :64],              # 136-byte heads
           flat.to(torch.bfloat16)[1:].view(2, 40, 3, 64)]  # base 2 bytes off
    good32 = good.float()
    bad32 = [torch.randn(2, 40, 3, 66, device=cuda)[..., :64],  # 264-byte heads
             flat[1:].view(2, 40, 3, 64)]                     # base 4 bytes off
    for g, xs in ((good, bad), (good32, bad32)):
        o, lse = ck.flash_attention_fwd(g, g, g, route="plain")
        for x in xs:
            with pytest.raises(ValueError, match="TMA"):
                ck._check_tma("flash_attention_fwd", q=x)
            for args in ((x, g, g), (g, g, x)):
                ck.reset_launch_counts()
                got = ck.flash_attention_fwd(*args)
                want = ck.flash_attention_fwd(*args, route="plain")
                assert ck.ROUTES == {("flash_attention_fwd", "copy16"): 1}
                close = (_bf16_tc_close if g.dtype == torch.bfloat16
                         else functools.partial(torch.testing.assert_close,
                                                atol=1e-5, rtol=1e-4))
                close(got[0], want[0])
            ck.reset_launch_counts()
            got = ck.flash_attention_bwd(g, x, g, o, lse, o)
            want = ck.flash_attention_bwd(g, x, g, o, lse, o, route="plain")
            assert ck.ROUTES == {("flash_attention_bwd_dq", "copy16"): 1,
                                 ("flash_attention_bwd_dkv", "copy16"): 1}
            for a, b in zip(got, want):
                if g.dtype == torch.bfloat16:
                    _bf16_tc_close(a, b)
                else:
                    _bwd_close(a, b, g.dtype)
    x = wide[..., :64]                                   # 272-byte heads
    ck.reset_launch_counts()
    o32, lse32 = ck.flash_attention_fwd(x, x, x)
    assert ck.ROUTES == {}
    po, plse = ck.flash_attention_fwd(x, x, x, route="plain")
    torch.testing.assert_close(o32, po, atol=1e-5, rtol=1e-4)


# head widths the kernels take: 64 and 128 natively for every kernel, the
# rest by #1-#3's pad route and natively for #4-#7 (80 is Phi-2's)
_WIDTHS = (8, 32, 48, 64, 80, 96, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", _WIDTHS)
def test_flash_kernels_at_every_head_width_on_card(cuda, dtype, D):
    """#1, #2 and #3 at head width D against the plain version at the
    scale of the real width, with kv_lens, causal and not: natively at
    D = 64 and 128 (no route counted), else by the counted pad route."""
    gen = torch.Generator().manual_seed(D)
    B, T, H = 2, 150, 3
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda, dtype)
    q, k, v, do = rnd(B, T, H, D), rnd(B, T, H, D), rnd(B, T, H, D), \
        rnd(B, T, H, D)
    lens = torch.tensor([T, 77], device=cuda)
    route = None if D in ck.KERNEL_HEAD_DIMS else f"pad{64 if D <= 64 else 128}"
    for causal in (False, True):
        ck.reset_launch_counts()
        o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens)
        po, plse = ck.flash_attention_fwd(q, k, v, causal=causal,
                                          kv_lens=lens, route="plain")
        assert o.shape == (B, T, H, D) and o.is_contiguous()
        if dtype == torch.float32:
            torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
        else:
            _bf16_tc_close(o, po)
        torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-4)
        got = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=causal,
                                     kv_lens=lens)
        want = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=causal,
                                      kv_lens=lens, route="plain")
        for g, w in zip(got, want):
            assert g.shape == w.shape
            if dtype == torch.bfloat16:
                _bf16_tc_close(g, w)
            else:
                _bwd_close(g, w, dtype)
        assert ck.LAUNCHES["flash_attention_fwd"] == 1
        assert ck.LAUNCHES["flash_attention_bwd_dq"] == 1
        assert ck.LAUNCHES["flash_attention_bwd_dkv"] == 1
        want_routes = {} if route is None else {
            ("flash_attention_fwd", route): 1,
            ("flash_attention_bwd_dq", route): 1,
            ("flash_attention_bwd_dkv", route): 1}
        assert ck.ROUTES == want_routes


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 80])
@pytest.mark.parametrize("T,S", [(200, 136), (136, 200), (64, 300)])
def test_flash_kernels_causal_with_s_not_t_on_card(cuda, dtype, D, T, S):
    """Causal at S < T and S > T: #1, #2 and #3 hold to the plain
    version's top-left-aligned tril(ones(T, S)) mask, with kv_lens (keys
    past T get exactly zero dk and dv under the mask)."""
    gen = torch.Generator().manual_seed(T + S)
    B, H = 2, 2
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda, dtype)
    q, k, v, do = rnd(B, T, H, D), rnd(B, S, H, D), rnd(B, S, H, D), \
        rnd(B, T, H, D)
    lens = torch.tensor([S, S // 2 + 3], device=cuda)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=True, kv_lens=lens)
    po, plse = ck.flash_attention_fwd(q, k, v, causal=True, kv_lens=lens,
                                      route="plain")
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    else:
        _bf16_tc_close(o, po)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-4)
    got = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=True,
                                 kv_lens=lens)
    want = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=True,
                                  kv_lens=lens, route="plain")
    for g, w in zip(got, want):
        if dtype == torch.bfloat16:
            _bf16_tc_close(g, w)
        else:
            _bwd_close(g, w, dtype)
    if S > T:
        assert not got[1][:, T:].any() and not got[2][:, T:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DECODE_DTYPES)
@pytest.mark.parametrize("D", _WIDTHS)
def test_decode_reads_at_every_head_width_on_card(cuda, dtype, D):
    """#4-#7 read every width natively: a [:, :L] view of a dense cache
    and pools at the model's real width (nothing padded, no route
    counted), split and not, against the plain version; a paged read
    equals the dense read of its gathered pages bit for bit."""
    gen = torch.Generator().manual_seed(100 + D)
    qdt, kv = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    B, H, Lmax, L = 3, 4, 320, 290
    q = torch.randn(B, H, D, generator=gen).to(cuda, qdt)
    k, v = (torch.randn(B, Lmax, H, D, generator=gen).to(cuda)
            for _ in range(2))
    ks = vs = None
    if kv == "int8":
        (k, ks), (v, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    pos = torch.tensor([0, 150, L + 5], dtype=torch.int32, device=cuda)
    kr, vr = k[:, :L], v[:, :L]
    ksr, vsr = (None, None) if ks is None else (ks[:, :L], vs[:, :L])
    ck.reset_launch_counts()
    for splits in (None, 1, 5):
        o = ck._decode_attention_kernel(q, kr, vr, pos, D ** -0.5, ksr, vsr,
                                        splits)
        po = ck.decode_attention(q, kr, vr, pos, k_scale=ksr, v_scale=vsr,
                                 route="plain")
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    bs, NB = 16, 19
    P = B * NB + 1
    perm = torch.randperm(P - 1, generator=gen)[:B * NB] + 1
    tables = perm.reshape(B, NB).to(torch.int32).to(cuda)
    pool = lambda t: torch.zeros((P, bs) + tuple(t.shape[2:]), dtype=t.dtype,
                                 device=cuda)
    kp, vp = pool(k), pool(v)
    ksp = vsp = None
    if ks is not None:
        ksp, vsp = pool(ks), pool(vs)
    for b in range(B):
        for j in range(NB):
            rows = slice(j * bs, (j + 1) * bs)
            p = int(tables[b, j])
            kp[p], vp[p] = k[b, rows], v[b, rows]
            if ks is not None:
                ksp[p], vsp[p] = ks[b, rows], vs[b, rows]
    for splits in (None, 4):
        o = ck._paged_decode_attention_kernel(q, kp, vp, tables, pos,
                                              D ** -0.5, ksp, vsp, splits)
        po = ck.paged_decode_attention(q, kp, vp, tables, pos, k_scale=ksp,
                                       v_scale=vsp, route="plain")
        torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
        dense = ck._decode_attention_kernel(
            q, ck.gather_pages(kp, tables), ck.gather_pages(vp, tables), pos,
            D ** -0.5,
            None if ksp is None else ck.gather_pages(ksp, tables),
            None if vsp is None else ck.gather_pages(vsp, tables),
            ck.decode_splits(B * H, NB * bs, splits)[0])
        torch.testing.assert_close(o, dense, atol=0, rtol=0)
    assert ck.ROUTES == {}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_f32_is_not_one_pass_tf32(cuda, causal):
    """The f32 bodies of #2 and #3 run three TF32 products a product (big
    and small parts of each operand, csrc/tf32x3.cuh), so they keep the f32
    tolerance where one TF32 pass cannot. Here q = 1 + 2**-14 * randn
    carries all of its variation below TF32's 10-bit mantissa: the plain
    backward with TF32 matmuls allowed fails ``_bwd_close`` on these
    inputs, the kernels pass it (both against the plain f32 backward)."""
    B, T, H = 2, 256, 2
    gen = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)
    q = 1.0 + 2.0 ** -14 * rnd(B, T, H, 64)
    k, v, do = rnd(B, T, H, 64), rnd(B, T, H, 64), rnd(B, T, H, 64)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, route="plain")
    want = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  route="plain")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = ck.flash_attention_bwd(q, k, v, o, lse, do,
                                          causal=causal, route="plain")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    def within(got):
        try:
            for g, w in zip(got, want):
                _bwd_close(g, w, torch.float32)
        except AssertionError:
            return False
        return True

    assert not within(one_pass)
    got = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        _bwd_close(g, w, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["lm", "nmt", "cross", "fused"])
def test_flash_fwd_f32_matches_plain_at_the_model_shapes(cuda, shape):
    """#1's f32 body (three TF32 products a product on the tensor cores)
    against the plain version at chip_smoke.py's phase-6 shapes, with the
    unchanged f32 tolerance (summation order only: atol 1e-5, rtol 1e-4),
    and bit-equal across two runs."""
    B, T, S, H, causal, lens, fused = _BWD_SHAPES[shape]
    gen = torch.Generator().manual_seed(13)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)
    if fused:
        qkv = rnd(B, T, 3 * H * 64)
        q, k, v = (t.unflatten(-1, (H, 64)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = rnd(B, T, H, 64), rnd(B, S, H, 64), rnd(B, S, H, 64)
    kv_lens = None
    if lens is not None:
        lo = 32 if shape == "nmt" else 1
        kv_lens = torch.randint(lo, S + 1, (B,), generator=gen)
        kv_lens[1] = 0 if shape == "nmt" else S
        kv_lens = kv_lens.to(cuda)
    before = ck.LAUNCHES["flash_attention_fwd"]
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens)
    assert ck.LAUNCHES["flash_attention_fwd"] == before + 1
    po, plse = ck.flash_attention_fwd(q, k, v, causal=causal,
                                      kv_lens=kv_lens, route="plain")
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-4)
    again = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_f32_is_not_one_pass_tf32(cuda, causal):
    """The forward's twin of test_flash_bwd_f32_is_not_one_pass_tf32: #1's
    f32 body runs three TF32 products a product, so it keeps the f32
    tolerance where one TF32 pass cannot. q = 1 + 2**-14 * randn carries
    its variation below TF32's 10-bit mantissa: the plain forward with
    TF32 matmuls allowed fails the f32 tolerance on o, the kernel passes
    it (both against the plain f32 forward)."""
    B, T, H = 2, 256, 2
    gen = torch.Generator().manual_seed(17)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)
    q = 1.0 + 2.0 ** -14 * rnd(B, T, H, 64)
    k, v = 4.0 * rnd(B, T, H, 64), rnd(B, T, H, 64)
    want = ck.flash_attention_fwd(q, k, v, causal=causal, route="plain")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = ck.flash_attention_fwd(q, k, v, causal=causal,
                                          route="plain")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.allclose(one_pass[0], want[0], atol=1e-5, rtol=1e-4)
    got = ck.flash_attention_fwd(q, k, v, causal=causal)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_flash_bwd_refuses_what_the_kernels_do_not_take(cuda):
    # widths past 256 (ROADMAP B.1.5)
    for D in (264, 320):
        q = torch.randn(1, 8, 2, D, device=cuda)
        o, lse = ck.flash_attention_fwd(q, q, q, route="plain")
        with pytest.raises(ValueError, match="B.1.5"):
            ck.flash_attention_bwd(q, q, q, o, lse, o)
    q = torch.randn(1, 8, 2, 64, device=cuda)
    o, lse = ck.flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        ck.flash_attention_bwd(q, q.to(torch.bfloat16), q, o, lse, o)
    with pytest.raises(TypeError, match="dtype"):
        ck.flash_attention_bwd(q, q, q, o, lse, o.to(torch.bfloat16))
    with pytest.raises(ValueError, match="several devices"):
        ck.flash_attention_bwd(q, q, q, o, lse, o.cpu())
    with pytest.raises(ValueError, match="lse"):
        ck.flash_attention_bwd(q, q, q, o, lse.to(torch.bfloat16), o)


def _step_matches_plain(cuda, model, loss_for_route, batch, lr, per_step,
                        names=("flash_attention_fwd", "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"), floor=0.0):
    """One f32 Adam step through the kernels against the same step with the
    plain versions, on the card. The loss to rtol 1e-6. Each gradient
    (read as Adam's first moment m = 0.1 g) to 1e-4 of its L2 norm: an
    entry is a sum of many terms whose size, not the entry's, sets its
    rounding, and the two routes sum in other orders. The parameters to
    1e-5 plus what the first Adam step lr*g/(|g|+eps) makes of a gradient
    difference of 1e-4 of the entry and of the tensor's rms: where g is
    rounding noise (the key bias's gradient is zero analytically), the
    step divides it by eps and moves by up to lr*dg/eps. Each attention
    kernel launches ``per_step`` times on the kernel route and never on
    the plain one (``names``: the attention kernels by default). ``floor``
    > 0 adds that share of the step's largest gradient norm to each
    gradient's allowance, for gradients at the step's rounding floor."""
    from paddle_tpu_torch.core.pytree import tree_get, tree_items
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    res = {}
    for route in (None, "plain"):
        opt = Adam(lr)
        tr = Trainer(loss_for_route(route), opt, device=cuda)
        before = dict(ck.LAUNCHES)
        res[route] = tr.step(model.tree(), opt.init(model.tree()), *batch)
        torch.cuda.synchronize()
        launched = {n: ck.LAUNCHES[n] - before[n] for n in names}
        assert launched == {n: per_step if route is None else 0
                            for n in names}
    (pk, sk, lk), (pp, sp, lp) = res[None], res["plain"]
    assert abs(lk.item() - lp.item()) <= 1e-6 * abs(lp.item())
    eps = 1e-8
    g_max = max(torch.linalg.vector_norm(tree_get(sp["slots"], p)["m"]).item()
                for p, _ in tree_items(pp))
    for path, b in tree_items(pp):
        mk = tree_get(sk["slots"], path)["m"]
        mp = tree_get(sp["slots"], path)["m"]
        err = torch.linalg.vector_norm(mk - mp).item()
        assert err <= (1e-4 * torch.linalg.vector_norm(mp).item()
                       + floor * g_max), path
        g = mp.abs() / 0.1
        dg = 1e-4 * (g + g.square().mean().sqrt())
        allowed = 1e-5 + lr * dg * eps / (g + eps) ** 2
        diff = (tree_get(pk, path) - b).abs()
        assert bool((diff <= allowed).all()), (path, diff.max().item())


@pytest.mark.gpu
def test_lm_training_step_matches_plain_on_card(cuda):
    from paddle_tpu_torch.models import TransformerLM
    model = TransformerLM(300, d_model=128, n_heads=2, n_layers=2,
                          max_len=160).init(seed=2, device=cuda)
    gen = torch.Generator().manual_seed(8)
    ids = torch.randint(0, 300, (3, 131), generator=gen)
    loss = lambda r: lambda p, x: model.call(p, x, method="loss", route=r)
    _step_matches_plain(cuda, model, loss, (ids,), 3e-4, per_step=2)


@pytest.mark.gpu
def test_nmt_training_step_matches_plain_on_card(cuda):
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.models import TransformerSeq2Seq
    model = TransformerSeq2Seq(200, 210, d_model=128, n_heads=2, n_enc=2,
                               n_dec=2, max_len=80).init(seed=3, device=cuda)
    gen = torch.Generator().manual_seed(9)
    B, S, T = 5, 70, 50
    slen = torch.randint(1, S + 1, (B,), generator=gen)
    slen[:3] = torch.tensor([1, S, 0])       # 0: attention zeroed
    batch = (torch.randint(3, 200, (B, S), generator=gen), slen,
             torch.randint(3, 210, (B, T), generator=gen),
             torch.randint(3, 210, (B, T), generator=gen),
             torch.randint(1, T + 1, (B,), generator=gen))

    def loss(route):
        def fn(p, src, sl, tin, tout, tl):
            return model.call(p, SeqBatch(src, sl), SeqBatch(tin, tl),
                              SeqBatch(tout, tl), method="loss", route=route)
        return fn
    # per step: 2 encoder, 2 decoder self- and 2 cross-attentions
    _step_matches_plain(cuda, model, loss, batch, 1e-3, per_step=6)


# ---------------------------------------------------------------------------
# the GRU sequence kernels (#11, #12) and the attention seq2seq
# ---------------------------------------------------------------------------

def _gru_case(cuda, dtype, gen, B, T, H, lens):
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    if lens is None:
        lens = torch.randint(0, T + 1, (B,), generator=gen).tolist()
    fwd = (rnd(B, T, 3 * H, scale=0.5),
           torch.tensor(lens, dtype=torch.int32, device=cuda),
           rnd(H, 3 * H, scale=0.05), None, rnd(B, H, scale=0.5))
    cot = (rnd(B, T, H, scale=0.1), rnd(B, H, scale=0.1))
    return fwd, cot


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,lens", [
    (5, 7, 256, [0, 1, 7, 3, 5]),          # the edge shape: one tile
    (40, 9, 64, None),                     # two batch tiles, H != 256
    (3, 1, 8, [1, 0, 1]),                  # a single step, two units
    (64, 12, 512, None),                   # the bench width, 256 blocks
])
def test_gru_kernels_match_plain_on_card(cuda, dtype, B, T, H, lens):
    """#11 and #12 against their plain versions; tolerances as for the
    LSTM kernels (_lstm_close: summation order in f32, one bf16 ulp, du an
    f32 sum of B*T products)."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    fwd, (g_out, g_ht) = _gru_case(cuda, dtype, torch.Generator().manual_seed(
        7), B, T, H, lens)
    before = dict(ck.LAUNCHES)
    got = rk.gru_sequence_fused(*fwd)
    want = rk.gru_sequence_fused(*fwd, route="plain")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        _lstm_close(g, w, dtype)
    xw, lengths, u, _, h0 = fwd
    bwd = (xw, lengths, u, h0, want[0], g_out, g_ht)
    got = rk.gru_sequence_fused_bwd(*bwd)
    want = rk.gru_sequence_fused_bwd(*bwd, route="plain")
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype
        _lstm_close(g, w, dtype, du=i == 2)
    for name in ("gru_seq", "gru_seq_bwd"):
        assert ck.LAUNCHES[name] == before[name] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(64, 32, 512), (37, 9, 512)])
def test_gru_bwd_is_bit_equal_across_runs_on_card(cuda, dtype, B, T, H):
    """#12 at the seq2seq bench shape (B=64, T=32, H=512, lengths 16..32
    with a 0) and the edge shape (B=37: a partial batch tile, lengths 0, 1
    and T): within the LSTM tolerance of the plain version, and bit-equal
    across two launches (every sum in a fixed order, no atomics)."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    gen = torch.Generator().manual_seed(23)
    lens = torch.randint(16 if T == 32 else 0, T + 1, (B,), generator=gen)
    lens[:3] = torch.tensor([0, 1, T])
    fwd, (g_out, g_ht) = _gru_case(cuda, dtype, gen, B, T, H, lens.tolist())
    xw, lengths, u, _, h0 = fwd
    out, _ = rk.gru_sequence_fused(*fwd, route="plain")
    bwd = (xw, lengths, u, h0, out, g_out, g_ht)
    got = rk.gru_sequence_fused_bwd(*bwd)
    again = rk.gru_sequence_fused_bwd(*bwd)
    want = rk.gru_sequence_fused_bwd(*bwd, route="plain")
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), i
        _lstm_close(g, w, dtype, du=i == 2)


@pytest.mark.gpu
def test_gru_kernels_refuse_what_they_do_not_take(cuda):
    from paddle_tpu_torch.ops import rnn_kernels as rk
    with pytest.raises(ValueError, match="multiple of 4"):
        rk.gru_sequence_fused(torch.randn(2, 3, 30, device=cuda),
                              torch.tensor([3, 1]),
                              torch.randn(10, 30, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        rk.gru_sequence_fused(torch.randn(2, 3, 24, device=cuda),
                              torch.tensor([3, 1]),
                              torch.randn(8, 24, device=cuda,
                                          dtype=torch.bfloat16))
    # 256 x 64 blocks cannot all be resident for the grid barriers: the
    # wrappers route such a batch to row tiles, and handed straight to the
    # kernels for the whole batch the launches raise
    big = torch.randn(2048, 1, 3072, device=cuda)
    lens = torch.ones(2048, dtype=torch.int32, device=cuda)
    u = torch.randn(1024, 3072, device=cuda)
    h = torch.zeros(2048, 1024, device=cuda)
    plan = rk.forward_plans("gru", 32, 1024)[0]
    with pytest.raises(ValueError, match="split the batch"):
        rk._gru_sequence_fused_kernel(big, lens, u, h, plan)
    with pytest.raises(ValueError, match="split the batch"):
        rk._gru_sequence_fused_bwd_kernel(big, lens, u, h, h[:, None],
                                          h[:, None], h)


# ---------------------------------------------------------------------------
# the recurrent forwards (#8, #9, #11) at every plan
# ---------------------------------------------------------------------------

def _lens(kind, B, T, gen):
    """Lengths of a forward case: the benches' (30..100 for the LSTM
    flagship, 16..32 with a 0 for the seq2seq), 0, 1 and T at the edge, or
    all 0."""
    if kind == "zero":
        return [0] * B
    lo = {"flagship": 30, "bench": 16}.get(kind, 0)
    lens = torch.randint(lo, T + 1, (B,), generator=gen)
    if kind == "bench":
        lens[0] = 0
    if kind == "edge":
        lens[:3] = torch.tensor([0, 1, T])
    return lens.tolist()


def _lstm_fwd_case(cuda, dtype, B, T, H, kind, seed):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    return (rnd(B, T, 4 * H, scale=0.5),
            torch.tensor(_lens(kind, B, T, gen), dtype=torch.int32,
                         device=cuda),
            ((torch.rand((H, 4 * H), generator=gen) - 0.5) * 0.16).to(
                cuda, dtype), rnd(4 * H, scale=0.1), rnd(B, H, scale=0.5),
            rnd(B, H, scale=0.5))


def _gru_fwd_case(cuda, dtype, B, T, H, kind, seed):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    return (rnd(B, T, 3 * H, scale=0.5),
            torch.tensor(_lens(kind, B, T, gen), dtype=torch.int32,
                         device=cuda),
            ((torch.rand((H, 3 * H), generator=gen) - 0.5) * 0.16).to(
                cuda, dtype), rnd(B, H, scale=0.5))


def _card_plans(kind, B, H):
    from paddle_tpu_torch.ops import rnn_kernels as rk
    plans = rk.forward_plans(kind, B, H, *rk.card_limits(
        torch.cuda.current_device()))
    assert plans
    return plans


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,kind", [
    (64, 100, 256, "flagship"),          # the text classifier's shape
    (37, 9, 12, "edge"),                 # a partial row tile, tail units
    (5, 6, 36, "zero"),                  # every length 0, tail units
    (128, 6, 256, "edge"),               # SUITE_ROWS (128, 256)
])
def test_lstm_forwards_match_plain_at_every_plan_on_card(cuda, dtype, B, T,
                                                         H, kind):
    """#8 and #9 at each plan forward_plans lists for the shape (8 and 16
    units, 8/16/32 rows; H = 12 and 36 leave tail units), and at the plan
    the wrapper chooses, against the plain version under the LSTM
    tolerance (_lstm_close)."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    fwd = _lstm_fwd_case(cuda, dtype, B, T, H, kind, 31)
    for save in (False, True):
        want = rk.lstm_sequence_fused(*fwd, forget_bias=1.0, save_cell=save,
                                      route="plain")
        name = "lstm_seq_train" if save else "lstm_seq"
        before = ck.LAUNCHES[name]
        got = rk.lstm_sequence_fused(*fwd, forget_bias=1.0, save_cell=save)
        assert ck.LAUNCHES[name] == before + 1
        for g, w in zip(got, want):
            _lstm_close(g, w, dtype)
        for plan in _card_plans("lstm", B, H):
            got = rk._lstm_sequence_fused_kernel(*fwd, 1.0, save, plan=plan)
            for g, w in zip(got, want):
                _lstm_close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,kind", [
    (64, 32, 512, "bench"),              # the seq2seq encoder's shape
    (128, 8, 512, "edge"),               # H = 512 at B = 128
    (37, 9, 12, "edge"),                 # a partial row tile, tail units
    (5, 4, 36, "zero"),                  # every length 0, tail units
])
def test_gru_forward_matches_plain_at_every_plan_on_card(cuda, dtype, B, T,
                                                         H, kind):
    """#11 at each plan forward_plans lists for the shape, and at the
    wrapper's, against the plain version under the LSTM tolerance."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    xw, lens, u, h0 = _gru_fwd_case(cuda, dtype, B, T, H, kind, 37)
    want = rk.gru_sequence_fused(xw, lens, u, None, h0, route="plain")
    before = ck.LAUNCHES["gru_seq"]
    got = rk.gru_sequence_fused(xw, lens, u, None, h0)
    assert ck.LAUNCHES["gru_seq"] == before + 1
    for g, w in zip(got, want):
        _lstm_close(g, w, dtype)
    for plan in _card_plans("gru", B, H):
        got = rk._gru_sequence_fused_kernel(xw, lens, u, h0, plan=plan)
        for g, w in zip(got, want):
            _lstm_close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["lstm_seq", "lstm_seq_train", "gru_seq"])
def test_forwards_are_bit_equal_across_runs_on_card(cuda, dtype, which):
    """#8 and #9 at the flagship shape (B=64, T=100, H=256) and #11 at the
    seq2seq's (B=64, T=32, H=512): two launches give the same bits (one
    owner a sum, a fixed order, no atomics)."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    if which == "gru_seq":
        args = _gru_fwd_case(cuda, dtype, 64, 32, 512, "bench", 41)
        run = lambda: rk.gru_sequence_fused(args[0], args[1], args[2], None,
                                            args[3])
    else:
        args = _lstm_fwd_case(cuda, dtype, 64, 100, 256, "flagship", 43)
        run = lambda: rk.lstm_sequence_fused(
            *args, forget_bias=1.0, save_cell=which == "lstm_seq_train")
    first, again = run(), run()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _s2s(cuda):
    from paddle_tpu_torch.models import AttentionSeq2Seq
    model = AttentionSeq2Seq(300, 310, embed_dim=32, hidden=64).init(
        seed=4, device=cuda)
    gen = torch.Generator().manual_seed(10)
    B, S, T = 37, 20, 12
    slen = torch.randint(1, S + 1, (B,), generator=gen)
    slen[:3] = torch.tensor([1, S, 0])
    batch = (torch.randint(3, 300, (B, S), generator=gen), slen,
             torch.randint(3, 310, (B, T), generator=gen),
             torch.randint(3, 310, (B, T), generator=gen),
             torch.randint(1, T + 1, (B,), generator=gen))
    return model, batch


@pytest.mark.gpu
def test_seq2seq_training_step_matches_plain_on_card(cuda):
    """One f32 Adam step of the attention seq2seq through the GRU kernels
    equals the same step on the plain route; two launches of each GRU
    kernel a step (the encoder's two directions). att_dec/w's gradient
    sits at the rounding floor at initialization (small encoder states:
    the decoder state shifts every attention score alike, which softmax
    cancels; ~1e-14 against ~1e-1), so gradients are held to 1e-4 of
    their norm plus 1e-7 of the step's largest gradient norm."""
    from paddle_tpu_torch.core import SeqBatch
    model, batch = _s2s(cuda)

    def loss(route):
        def fn(p, src, sl, tin, tout, tl):
            return model.call(p, SeqBatch(src, sl), SeqBatch(tin, tl),
                              SeqBatch(tout, tl), method="loss", route=route)
        return fn
    _step_matches_plain(cuda, model, loss, batch, 1e-3, per_step=2,
                        names=("gru_seq", "gru_seq_bwd"), floor=1e-7)


@pytest.mark.gpu
def test_seq2seq_generation_matches_plain_on_card(cuda):
    """``generate`` (beam 4) and ``greedy_generate``: the tokens of the
    plain route, scores to 1e-5, two forward launches a call and no
    backward."""
    from paddle_tpu_torch.core import SeqBatch
    model, batch = _s2s(cuda)
    src = SeqBatch(batch[0].to(cuda), batch[1].to(cuda))
    for call in (lambda r: model.generate(src, beam_size=4, max_len=10,
                                          route=r),
                 lambda r: model.greedy_generate(src, max_len=10, route=r)):
        before = dict(ck.LAUNCHES)
        toks, scores = call(None)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["gru_seq"] == before["gru_seq"] + 2
        assert ck.LAUNCHES["gru_seq_bwd"] == before["gru_seq_bwd"]
        want_t, want_s = call("plain")
        assert torch.equal(toks, want_t)
        torch.testing.assert_close(scores, want_s, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the CUDA graphs of the ported paths (core/graphs.py) against their eager
# bodies (graphs.disabled())
# ---------------------------------------------------------------------------

def _counted(fn):
    """fn() with the launch and dispatch counts set to 0 just before:
    (out, launches, dispatches)."""
    from paddle_tpu_torch.core import graphs
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    graphs.reset_dispatch_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: n for k, n in ck.LAUNCHES.items() if n},
            {o: {k: dict(n) for k, n in keys.items()}
             for o, keys in graphs.DISPATCHES.items()})


def _replays(dispatches, kind):
    """(captures, replays) of the keys whose label starts with ``kind``."""
    c = r = 0
    for keys in dispatches.values():
        for label, n in keys.items():
            if label.startswith(kind + "("):
                c, r = c + n["captures"], r + n["replays"]
    return c, r


def _eager_and_graphed(fn):
    """fn() on the eager route, then through the graphs once to capture and
    once counted: (eager out, eager launches, graphed out, graphed
    launches, graphed dispatches)."""
    from paddle_tpu_torch.core import graphs
    with graphs.disabled():
        e, le, de = _counted(fn)
    assert de == {}
    fn()
    g, lg, dg = _counted(fn)
    assert lg == le and lg
    return e, g, dg


def _graph_lm(cuda):
    return TransformerLM(101, d_model=128, n_heads=2, n_layers=2,
                         max_len=256).init(seed=3, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("sample", ["greedy", "topk"])
def test_generate_fused_graphs_equal_the_eager_loop_on_card(cuda, kv,
                                                            sample):
    """One graph a decode token after the prefill (two cache buckets), the
    eager loop's tokens (top-k: under the same generator seed) and its
    kernel launches."""
    model = _graph_lm(cuda)
    ids = torch.as_tensor(np.random.RandomState(5).randint(0, 101, (3, 40)),
                          device=cuda)
    gen = torch.Generator(device=cuda)
    kw = dict(sample="topk", top_k=7, temperature=0.9) \
        if sample == "topk" else {}
    fn = lambda: model.generate_fused(ids, 40, bucket=64, kv_dtype=kv,
                                      generator=gen.manual_seed(1), **kw)
    e, g, d = _eager_and_graphed(fn)
    assert torch.equal(e, g)
    assert _replays(d, "decode") == (0, 39)
    assert _replays(d, "prefill") == (0, 1)


@pytest.mark.gpu
def test_generate_fused_memory_stays_flat_on_card(cuda):
    """A fresh generator and a new prompt length each call add graphs
    (of a few small outputs), never a KV cell: the model keeps one cell
    per (B, kv_dtype). The draws of a fresh generator are the eager
    loop's under the same seed."""
    from paddle_tpu_torch.core import graphs
    model = _graph_lm(cuda)
    cell = sum(t.numel() * t.element_size()
               for t in model.empty_cell(3).values())

    def call(T0, seed):
        ids = torch.as_tensor(np.random.RandomState(T0).randint(
            0, 101, (3, T0)), device=cuda)
        return model.generate_fused(
            ids, 20, bucket=64, sample="topk", top_k=7,
            generator=torch.Generator(device=cuda).manual_seed(seed))
    call(40, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    _, _, d = _counted(lambda: [call(T0, i) for i, T0 in enumerate(
        (10, 17, 25, 33, 48, 61, 70, 90))])
    grown = torch.cuda.memory_allocated() - base
    assert grown < cell / 8, (grown, cell)
    assert _replays(d, "prefill") == (8, 0)
    assert _replays(d, "decode")[0] == 1          # the 128-row bucket
    with graphs.disabled():
        want = call(33, 5)
    assert torch.equal(call(33, 5), want)


@pytest.mark.gpu
def test_serving_graphs_equal_the_eager_bodies_on_card(cuda):
    """The paged pool (ServingEngine), the dense pool (ContinuousBatcher)
    and the speculative round: the eager route's tokens, one graph replay
    a segment or round."""
    from paddle_tpu_torch.serving import (ContinuousBatcher, Request,
                                          SpeculativeDecoder)
    model = _graph_lm(cuda)
    rs = np.random.RandomState(4)
    work = [(rs.randint(0, 101, int(n)), int(m))
            for n, m in ((70, 20), (5, 9), (33, 30), (120, 12), (17, 25))]

    def engine():
        eng = ServingEngine(model, slots=3, segment=8, page_block=16,
                            cache_bucket=64, kv_dtype="int8", device=cuda)
        out = []
        for _ in range(2):     # the second burst replays the first's graphs
            rids = [eng.submit(p, n) for p, n in work]
            while not all(eng.poll(r)[1] for r in rids):
                eng.step()
            out.append([eng.poll(r)[0] for r in rids])
        return out, eng.pool.segments_total
    from paddle_tpu_torch.core import graphs
    with graphs.disabled():
        want, _ = engine()
    (got, segs), _, d = _counted(engine)
    assert got == want
    captures, replays = _replays(d, "segment")
    assert captures + replays == segs and replays > captures

    b = ContinuousBatcher(model, slots=3, segment=8, cache_bucket=64,
                          device=cuda)
    def batcher():
        seg0 = b.segments_total
        out = b.serve([Request(i, p, n) for i, (p, n) in enumerate(work)])
        return out, b.segments_total - seg0
    e, g, d = _eager_and_graphed(batcher)
    assert all(np.array_equal(e[0][k], g[0][k]) for k in e[0])
    assert e[1] == g[1] and _replays(d, "segment") == (0, g[1])

    draft = TransformerLM(101, d_model=128, n_heads=2, n_layers=2,
                          max_len=256).init(seed=9, device=cuda)
    sd = SpeculativeDecoder(model, draft, k=3)
    prompt = rs.randint(0, 101, (2, 30))
    e, g, d = _eager_and_graphed(lambda: sd.generate(prompt, 24))
    assert np.array_equal(e[0], g[0]) and e[1] == g[1]
    assert e[1]["accepted"] < e[1]["proposed"]
    assert _replays(d, "round") == (0, g[1]["rounds"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lm", "textcls", "seq2seq"])
def test_trainer_step_graph_equals_the_eager_step_on_card(cuda, kind):
    """One f32 Adam step replayed through the trainer's graph against the
    eager step from the same params: the loss and every parameter equal
    (a GEMM that picks other bits under capture is held to 1e-5), the
    same launches, one replay."""
    from paddle_tpu_torch.core import SeqBatch, graphs
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    gen = torch.Generator().manual_seed(8)
    if kind == "lm":
        model = TransformerLM(300, d_model=128, n_heads=2, n_layers=2,
                              max_len=160).init(seed=2, device=cuda)
        batch = (torch.randint(0, 300, (3, 131), generator=gen),)
        loss = lambda p, x: model.call(p, x, method="loss")
    elif kind == "textcls":
        from paddle_tpu_torch.models import LSTMTextCls
        model = LSTMTextCls(500, 32, 64, pool="last").init(seed=1,
                                                           device=cuda)
        batch = (torch.randint(0, 500, (37, 20), generator=gen),
                 torch.randint(1, 21, (37,), generator=gen),
                 torch.randint(0, 2, (37,), generator=gen))
        loss = lambda p, d, ln, y: model.call(p, SeqBatch(d, ln), y)
    else:
        model, batch = _s2s(cuda)
        loss = lambda p, s, sl, ti, to, tl: model.call(
            p, SeqBatch(s, sl), SeqBatch(ti, tl), SeqBatch(to, tl),
            method="loss")
    res = {}
    for route in ("eager", "graphed"):
        tr = Trainer(loss, Adam(1e-3), device=cuda)
        fresh = lambda: tree_map(torch.clone, model.tree())
        if route == "eager":
            with graphs.disabled():
                p = fresh()
                out, launches, d = _counted(
                    lambda: tr.step(p, tr.opt.init(p), *batch))
        else:
            p = fresh()
            tr.step(p, tr.opt.init(p), *batch)             # the capture
            p = fresh()
            out, launches, d = _counted(
                lambda: tr.step(p, tr.opt.init(p), *batch))
            assert _replays(d, "step") == (0, 1)
        res[route] = (tree_map(torch.clone, out[0]), out[2].item(),
                      launches)
    (pe, le, ne), (pg, lg, ng) = res["eager"], res["graphed"]
    assert ne == ng and ne
    assert abs(le - lg) <= 1e-6 * abs(le)
    for (path, a), (_, b) in zip(tree_items(pe), tree_items(pg)):
        assert (a - b).abs().max().item() <= 1e-5, path


@pytest.mark.gpu
def test_trainer_train_and_test_dispatch_once_a_step_on_card(cuda):
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = LSTMTextCls(500, 32, 64, pool="last").init(seed=1, device=cuda)
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.randint(0, 500, (16, T), generator=gen).to(cuda),
                torch.randint(1, T + 1, (16,), generator=gen).to(cuda),
                torch.randint(0, 2, (16,), generator=gen).to(cuda))
               for T in (20, 20, 30)]
    tr = Trainer(lambda p, d, ln, y: model.call(p, SeqBatch(d, ln), y),
                 Adam(1e-3), device=cuda)
    (params, state), launches, d = _counted(
        lambda: tr.train(lambda: batches, model.tree(), num_passes=2))
    # two batch signatures: a capture each, a replay every other step
    assert _replays(d, "step") == (2, 4)
    assert launches == {"lstm_seq_train": 6, "lstm_seq_bwd": 6}
    cost, launches, d = _counted(lambda: tr.test(lambda: batches, params))
    assert _replays(d, "loss") == (2, 1)
    assert launches == {"lstm_seq": 3}
    assert int(state["step"]) == 6


@pytest.mark.gpu
def test_seq2seq_search_graphs_equal_the_eager_search_on_card(cuda):
    from paddle_tpu_torch.core import SeqBatch
    model, batch = _s2s(cuda)
    src = SeqBatch(batch[0].to(cuda), batch[1].to(cuda))
    for kind, call in (
            ("beam", lambda: model.generate(src, beam_size=4, max_len=10,
                                            length_penalty=0.6)),
            ("greedy", lambda: model.greedy_generate(src, max_len=10))):
        e, g, d = _eager_and_graphed(call)
        assert torch.equal(e[0], g[0]) and torch.equal(e[1], g[1])
        assert _replays(d, kind) == (0, 1)


@pytest.mark.gpu
def test_graphs_are_dropped_when_the_weights_move_on_card(cuda):
    """A capture reads the weights where they were: ``model.to(bf16)``
    reallocates them, and the next call captures anew on the new ones."""
    from paddle_tpu_torch.core import graphs
    model = _graph_lm(cuda)
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 101, (2, 20)),
                          device=cuda)
    fn = lambda: model.generate_fused(ids, 12)
    fn()
    model.to(torch.bfloat16)
    with graphs.disabled():
        want = fn()
    got, _, d = _counted(fn)
    assert torch.equal(got, want)
    assert _replays(d, "decode")[0] == 1


@pytest.mark.gpu
def test_a_capture_that_cannot_run_raises_on_card(cuda):
    """A body that reads the card from the host cannot be captured: the
    call raises, with no eager fallback (in a child process: a failed
    capture leaves its stream unusable)."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import torch\n"
            "from paddle_tpu_torch.core.graphs import GraphCache\n"
            "c = GraphCache('bad', 'cuda')\n"
            "x = torch.ones(4, device='cuda')\n"
            "c.run('f', lambda x: x * float(x.sum()), {'x': x})\n"
            "print('carried on')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode != 0 and "carried on" not in r.stdout
    assert "capture" in r.stderr.lower()


# -- the image stack (no kernel of the port's: cuDNN) -------------------------

@pytest.fixture
def cuda_f32():
    """The card with TF32 off for convolutions too (cuDNN's default is
    on), restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = before


def _image_ops():
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import norm as N
    from paddle_tpu_torch.ops import pool as P
    bn = ((2, 14, 14, 32), (32,), (32,), (32,), (32,))
    return {
        "stem_direct": (lambda x, w: C.conv2d(x, w, stride=2, padding=3),
                        ((2, 32, 32, 3), (7, 7, 3, 16)), True),
        "stem_s2d": (C.conv7s2_space_to_depth,
                     ((2, 32, 32, 3), (7, 7, 3, 16)), True),
        "conv3x3": (lambda x, w: C.conv2d(x, w, padding=1),
                    ((2, 14, 14, 32), (3, 3, 32, 32)), True),
        "proj1x1s2": (lambda x, w: C.conv2d(x, w, stride=2),
                      ((2, 14, 14, 32), (1, 1, 32, 64)), True),
        "same_s2": (lambda x, w: C.conv2d(x, w, stride=2, padding="SAME"),
                    ((2, 13, 11, 16), (3, 3, 16, 16)), True),
        "depthwise": (lambda x, w: C.depthwise_conv2d(x, w, padding=1),
                      ((2, 14, 14, 32), (3, 3, 1, 32)), True),
        "transpose": (lambda x, w: C.conv2d_transpose(x, w, stride=2,
                                                      padding=1),
                      ((2, 7, 7, 32), (3, 3, 32, 16)), True),
        "max_pool": (lambda x: P.max_pool2d(x, 3, 2, 1),
                     ((2, 15, 15, 16),), False),
        "avg_pool_pad": (lambda x: P.avg_pool2d(x, 3, 2, 1),
                         ((2, 15, 15, 16),), False),
        "avg_pool_cells": (lambda x: P.avg_pool2d(
            x, 3, 2, 1, count_include_pad=False), ((2, 15, 15, 16),), False),
        "global_pools": (lambda x: (P.global_avg_pool2d(x),
                                    P.global_max_pool2d(x)),
                         ((2, 7, 7, 64),), False),
        "bn_train_fused": (lambda x, g, b, m, v: N._train_fused(
            x, g, b, 1e-5), bn, False),
        "bn_train_shifted": (lambda x, g, b, m, v: N._train_shifted(
            x, g, b, m, 1e-5), bn, False),
        "bn_train": (lambda *a: N.batch_norm(*a, train=True), bn, False),
        "bn_eval": (lambda *a: N.batch_norm(*a, train=False), bn, False),
        "lrn": (N.lrn, ((2, 9, 9, 24),), False),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(_image_ops()))
def test_image_op_matches_the_cpu_on_card(cuda_f32, name, dtype):
    """Each image op on the card against the port on the CPU. f32 (TF32
    off): convs to 1e-4 of the largest magnitude (cuDNN may pick a
    Winograd or FFT algorithm), the rest 1e-5, rtol 1e-4; bf16: one bf16
    ulp of the largest magnitude, rtol 2**-7 (each side rounds one f32
    result)."""
    fn, shapes, is_conv = _image_ops()[name]
    gen = torch.Generator().manual_seed(5)
    args = [torch.randn(s, generator=gen) for s in shapes]
    if name.startswith("bn"):
        args[0] = args[0] * 2 + 1
        args[4] = args[4].abs() + 0.5
    args = [a.to(dtype) for a in args]
    want = fn(*args)
    got = fn(*[a.to(cuda_f32) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        g, w = g.float().cpu(), w.float()
        scale = max(w.abs().max().item(), 1e-30)
        if dtype == torch.float32:
            atol = (1e-4 if is_conv else 1e-5) * max(scale, 1.0)
            torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)
        else:
            torch.testing.assert_close(g, w, atol=_bf16_ulp(scale),
                                       rtol=2.0 ** -7)


def _resnet_loss(model, dtype):
    def loss(params, x, y):
        from paddle_tpu_torch.core.pytree import tree_map
        mut = {}
        p = tree_map(lambda a: a.to(dtype), params)
        logits = model.call(p, x.to(dtype), train=True,
                            mutable=mut).float()
        return -torch.log_softmax(logits, -1).gather(
            1, y.long()[:, None]).mean(), mut
    return loss


@pytest.mark.gpu
def test_resnet18_graphed_step_equals_the_eager_step_on_card(cuda_f32):
    """One f32 Momentum step of a small ResNet-18 (train-mode BN, the stat
    updates merged) replayed through the trainer's graph against the eager
    step, under cudnn.deterministic: the loss and every leaf, the merged
    stats too, bit-equal; one replay, no launch of the port's kernels."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.models import ResNet
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.trainer import Trainer
    model = ResNet(18, classes=10, width_mult=0.25).init(seed=4,
                                                         device=cuda_f32)
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(8, 32, 32, 3, generator=gen).to(cuda_f32)
    y = torch.randint(0, 10, (8,), generator=gen).to(cuda_f32)
    fresh = lambda: tree_map(torch.clone, model.tree())
    torch.backends.cudnn.deterministic = True
    try:
        res = {}
        for route in ("eager", "graphed"):
            tr = Trainer(_resnet_loss(model, torch.float32),
                         Momentum(0.1, 0.9), device=cuda_f32)
            if route == "eager":
                with graphs.disabled():
                    p = fresh()
                    out, launches, d = _counted(
                        lambda: tr.step(p, tr.opt.init(p), x, y))
            else:
                p = fresh()
                tr.step(p, tr.opt.init(p), x, y)             # the capture
                p = fresh()
                out, launches, d = _counted(
                    lambda: tr.step(p, tr.opt.init(p), x, y))
                assert _replays(d, "step") == (0, 1)
            assert launches == {}
            res[route] = (tree_map(torch.clone, out[0]), out[2].item())
    finally:
        torch.backends.cudnn.deterministic = False
    (pe, le), (pg, lg) = res["eager"], res["graphed"]
    assert le == lg
    moved = pe["stem"]["bn"]["stats"]["moving_var"]
    assert not torch.equal(moved, model.tree()["stem"]["bn"]["stats"]
                           ["moving_var"])
    for (path, a), (_, b) in zip(tree_items(pe), tree_items(pg),
                                 strict=True):
        assert torch.equal(a, b), path


@pytest.mark.gpu
def test_dropout_generator_replays_through_the_graph_on_card(cuda_f32):
    """A card generator in the batch: the graphed step draws what the
    eager step draws from the same seed (the loss equal, to 1e-6 where a
    GEMM picks other bits under capture), and advances the caller's
    generator alike."""
    import contextlib
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.core.pytree import tree_map
    from paddle_tpu_torch.models import AlexNet
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.trainer import Trainer
    model = AlexNet(classes=10).init(seed=1, device=cuda_f32)
    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, 224, 224, 3, generator=g).to(cuda_f32)
    y = torch.tensor([1, 7], device=cuda_f32)
    loss = lambda p, x, y, gen: model.call(p, x, y, train=True,
                                           generator=gen, method="loss")
    fresh = lambda: tree_map(torch.clone, model.tree())
    res = {}
    for route in ("eager", "graphed"):
        tr = Trainer(loss, Momentum(0.01, 0.9), device=cuda_f32)
        gen = torch.Generator(device=cuda_f32).manual_seed(11)
        if route == "graphed":
            p = fresh()
            tr.step(p, tr.opt.init(p), x, y, gen)           # the capture
            gen.manual_seed(11)
        with (graphs.disabled() if route == "eager" else
              contextlib.nullcontext()):
            p = fresh()
            _, _, cost = tr.step(p, tr.opt.init(p), x, y, gen)
        res[route] = (cost.item(), gen.get_state())
    (le, se), (lg, sg) = res["eager"], res["graphed"]
    assert abs(le - lg) <= 1e-6 * abs(le)
    assert torch.equal(se, sg)


# -- the training loop (trainer, optimizers, data, checkpoints) ---------------

def _loop_model(cuda, seed=1):
    from paddle_tpu_torch.models import LSTMTextCls
    return LSTMTextCls(500, 32, 64, pool="last").init(seed=seed,
                                                      device=cuda)


def _loop_fns(model):
    """The loss (each row's cross-entropy times its scale) and the
    evaluators' outputs, sharing one forward."""
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    from paddle_tpu_torch.trainer import shared_forward

    @shared_forward
    def logits(p, sb):
        return model.call(p, sb)

    def loss(p, sb, y, sc):
        return torch.mean(softmax_with_cross_entropy(logits(p, sb), y)
                          * sc[:, 0])

    def outputs(p, sb, y, sc):
        lg = logits(p, sb)
        return {"logits": lg, "probs": torch.softmax(lg, -1)[:, 1],
                "labels": y}
    return loss, outputs


def _loop_rows(seed, n_batches, B=16, poison=None, hi=(20, 60, 100)):
    """A reader of row batches [(ids, label, [scale])] whose longest
    sequence cycles through ``hi``, so that the feeder's bucket (32, 64,
    128) changes from batch to batch; batch ``poison``'s scale is inf."""
    def reader():
        rs = np.random.RandomState(seed)
        for b in range(n_batches):
            top = hi[b % len(hi)]
            rows = []
            for _ in range(B):
                ids = rs.randint(0, 500, rs.randint(top // 2, top + 1))
                rows.append((ids.tolist(), int(ids[-1] % 2),
                             [np.inf if b == poison else 1.0]))
            yield rows
    return reader


def _loop_feeder(cuda):
    from paddle_tpu_torch.data import DataFeeder, DenseSlot, IndexSlot, \
        SeqSlot
    return DataFeeder([SeqSlot(), IndexSlot(), DenseSlot(1)], device=cuda)


def _tree_diff(a, b):
    from paddle_tpu_torch.core.pytree import tree_items
    return max((x.float() - y.float()).abs().max().item()
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b),
                                         strict=True))


@pytest.mark.gpu
def test_guarded_step_graph_equals_the_eager_step_on_card(cuda):
    """``on_nonfinite="skip"`` through the graphs against the eager route,
    over a pass with a poisoned batch: the same costs and launches, the
    parameters within the graph check's 1e-5, the step counter not
    advanced by the poisoned batch; and the graphed skip run bit-equal to
    the graphed run without that batch."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = _loop_model(cuda)
    loss, outs = _loop_fns(model)
    runs = {}
    for route in ("eager", "graphed", "clean"):
        tr = Trainer(loss, Adam(1e-3), device=cuda, on_nonfinite="skip")
        costs = []
        on = lambda e: costs.append(getattr(e, "cost", None))
        reader = _loop_rows(4, 5, poison=None if route == "clean" else 2)
        if route == "clean":
            whole = reader
            reader = lambda: (b for i, b in enumerate(whole()) if i != 2)
        ctx = graphs.disabled() if route == "eager" else \
            __import__("contextlib").nullcontext()
        with ctx:
            (p, s), launches, d = _counted(lambda: tr.train(
                reader, model.tree(), feeder=_loop_feeder(cuda),
                event_handler=on, handle_signals=False))
        runs[route] = (p, s, [c for c in costs if c is not None], launches)
        if route == "graphed":
            assert tr.train_stats["skipped_batches"] == 1
    (pe, se, ce, le), (pg, sg, cg, lg), (pc, sc, cc, _) = (
        runs["eager"], runs["graphed"], runs["clean"])
    assert le == lg and le["lstm_seq_train"] == 5
    assert np.isinf(ce[2]) and np.isinf(cg[2])
    np.testing.assert_allclose(cg, ce, rtol=1e-6)
    assert _tree_diff(pg, pe) <= 1e-5 and _tree_diff(sg["slots"],
                                                     se["slots"]) <= 1e-5
    assert int(sg["step"]) == int(se["step"]) == 4
    assert cg[:2] + cg[3:] == cc
    assert _tree_diff(pg, pc) == 0.0 and _tree_diff(sg, sc) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["exponential", "piecewise"])
def test_schedule_follows_the_step_through_the_graph_on_card(cuda, sched):
    """A schedule of the step tensor inside the step's graph: 7 replays
    past its boundaries equal the eager route (1e-5), and differ from the
    rate frozen at its first value."""
    from paddle_tpu_torch.core import SeqBatch, graphs
    from paddle_tpu_torch.optimizer import (SGD, exponential_decay,
                                            piecewise_decay)
    from paddle_tpu_torch.trainer import Trainer
    model = _loop_model(cuda, 2)
    gen = torch.Generator().manual_seed(5)
    batch = (torch.randint(0, 500, (16, 24), generator=gen).to(cuda),
             torch.randint(1, 25, (16,), generator=gen).to(cuda),
             torch.randint(0, 2, (16,), generator=gen).to(cuda))
    loss = lambda p, d, ln, y: model.call(p, SeqBatch(d, ln), y)
    lr = {"exponential": exponential_decay(0.5, 2, 0.3),
          "piecewise": piecewise_decay([2, 4], [0.5, 0.05, 0.005])}[sched]
    out = {}
    for route, rate in (("eager", lr), ("graphed", lr),
                        ("frozen", float(lr(torch.tensor(1.0))))):
        tr = Trainer(loss, SGD(rate), device=cuda)
        ctx = graphs.disabled() if route == "eager" else \
            __import__("contextlib").nullcontext()
        with ctx:
            p, s = tr.train(lambda: [batch] * 8, model.tree())
        out[route] = p
        assert int(s["step"]) == 8
    assert _tree_diff(out["graphed"], out["eager"]) <= 1e-5
    assert _tree_diff(out["graphed"], out["frozen"]) > 1e-3


@pytest.mark.gpu
def test_feeder_captures_in_the_middle_of_a_pass_on_card(cuda):
    """The feeder on the prefetch thread copies to the card while the main
    thread captures a new bucket's graph (buckets 32, 64, 128 in turn):
    the captures survive (one per bucket, replays after), and the costs,
    evaluator results and parameters equal the eager route's."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import (AucEvaluator,
                                          ClassificationErrorEvaluator,
                                          Trainer)
    model = _loop_model(cuda, 3)
    loss, outs = _loop_fns(model)
    res = {}
    for route in ("eager", "graphed"):
        tr = Trainer(loss, Adam(1e-3), device=cuda, outputs_fn=outs,
                     evaluators=[ClassificationErrorEvaluator(),
                                 AucEvaluator(20)], prefetch_timeout=60)
        evs = []
        on = lambda e: evs.append((e.cost, e.evaluator_result)) \
            if type(e).__name__ == "EndIteration" else None
        ctx = graphs.disabled() if route == "eager" else \
            __import__("contextlib").nullcontext()
        with ctx:
            (p, s), launches, d = _counted(lambda: tr.train(
                _loop_rows(6, 9), model.tree(), num_passes=2,
                feeder=_loop_feeder(cuda), event_handler=on,
                handle_signals=False))
        res[route] = (p, evs, launches, d)
    (pe, ee, le, de), (pg, eg, lg, dg) = res["eager"], res["graphed"]
    assert _replays(dg, "step") == (3, 15) and de == {}
    assert le == lg == {"lstm_seq_train": 18, "lstm_seq_bwd": 18}
    np.testing.assert_allclose([c for c, _ in eg], [c for c, _ in ee],
                               rtol=1e-5)
    for (_, rg), (_, re) in zip(eg, ee):
        assert rg.keys() == re.keys()
    assert _tree_diff(pg, pe) <= 1e-4


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A tree on the card (f32, bf16, int32) saved and loaded back onto the
    card and onto the CPU bit for bit, in the saved order; the CPU's
    re-save is the same bytes, params and state."""
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.trainer.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    gen = torch.Generator().manual_seed(9)
    params = {"w": torch.randn(33, 7, generator=gen).to(cuda),
              "h": torch.randn(5, generator=gen).to(cuda, torch.bfloat16),
              "t": torch.randn(4, 6, generator=gen).to(cuda).t()}
    state = {"step": torch.tensor(3, dtype=torch.int32, device=cuda),
             "slots": {"w": {}, "h": {"m": torch.zeros(5, device=cuda)}}}
    save_checkpoint(str(tmp_path / "a"), 0, params, state)
    for dev in (cuda, torch.device("cpu")):
        p, s, st = load_checkpoint(str(tmp_path / "a"), device=dev)
        assert st["pass_id"] == 0 and s["slots"]["w"] == {}
        for (path, a), (_, b) in zip(tree_items(p), tree_items(params)):
            assert a.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu()), path
        assert int(s["step"]) == 3
    p, s, _ = load_checkpoint(str(tmp_path / "a"), device="cpu")
    save_checkpoint(str(tmp_path / "b"), 0, p, s)
    for name in ("params.tar", "opt_state.tar"):
        assert (tmp_path / "a" / "pass-00000" / name).read_bytes() == \
            (tmp_path / "b" / "pass-00000" / name).read_bytes(), name


# -- the data plane from files (chunks, faults, nested batches) ----------------

def _nested_rows(seed, n=12):
    rs = np.random.RandomState(seed)
    return [([rs.randint(0, 500, int(rs.randint(0, 30))).tolist()
              for _ in range(int(rs.randint(1, 7)))], int(rs.randint(2)),
             rs.randn(int(rs.randint(1, 5)), 3).tolist())
            for _ in range(n)]


@pytest.mark.gpu
def test_nested_feeder_on_card_equals_the_cpu(cuda):
    """``SeqSlot(nested=True)`` (ids and vector elements) beside an index
    slot: the card's tensors bit-equal to the CPU feeder's."""
    from paddle_tpu_torch.core import NestedSeqBatch
    from paddle_tpu_torch.data import DataFeeder, IndexSlot, SeqSlot
    slots = [SeqSlot(nested=True), IndexSlot(), SeqSlot(elem_dim=3)]
    rows = _nested_rows(1)
    got = DataFeeder(slots, device=cuda)(rows)
    want = DataFeeder(slots, device="cpu")(rows)
    assert isinstance(got[0], NestedSeqBatch)
    pairs = [(getattr(got[0], f), getattr(want[0], f))
             for f in ("data", "sub_lengths", "seq_lengths")]
    pairs += [(got[1], want[1]), (got[2].data, want[2].data),
              (got[2].lengths, want[2].lengths)]
    for a, b in pairs:
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


def _nested_head(emb, w, nb):
    inner = nb.inner_flat()
    m = inner.mask()
    mean = (emb[inner.data.long()] * m[..., None]).sum(1) \
        / m.sum(-1, keepdim=True).clamp(min=1.0)
    outer = nb.outer(mean)
    return (outer.data * outer.mask()[..., None]).sum(1) @ w


@pytest.mark.gpu
def test_graphed_body_over_a_nested_batch_equals_eager_on_card(cuda):
    """A body over a ``NestedSeqBatch`` through the graph cache: one
    capture, then replays (another sub-sequence bucket is another key),
    each within 1e-6 of the eager body (its GEMM may differ under
    capture), and the eager body within 1e-5 of the CPU's."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.data import DataFeeder, SeqSlot
    gen = torch.Generator().manual_seed(3)
    emb = torch.randn(500, 16, generator=gen)
    w = torch.randn(16, 4, generator=gen)
    feed = DataFeeder([SeqSlot(nested=True)], device=cuda)
    cache = graphs.GraphCache("test_nested", cuda)
    graphs.reset_dispatch_counts()
    for seed in (1, 2, 1):
        rows = [(r[0],) for r in _nested_rows(seed)]
        (nb,) = feed(rows)
        for _ in range(2):
            got = cache.run("head", _nested_head,
                            {"emb": emb.to(cuda), "w": w.to(cuda),
                             "nb": nb})
            want = _nested_head(emb.to(cuda), w.to(cuda), nb)
            assert (got - want).abs().max().item() <= \
                1e-6 * want.abs().max().item()
        (cpu_nb,) = DataFeeder([SeqSlot(nested=True)], device="cpu")(rows)
        torch.testing.assert_close(want.cpu(), _nested_head(emb, w, cpu_nb),
                                   rtol=1e-5, atol=1e-5)
    keys = graphs.DISPATCHES["test_nested"]
    assert sum(n["captures"] for n in keys.values()) == len(keys) <= 2
    assert sum(n["replays"] for n in keys.values()) == 6 - len(keys)


def _chunk_pass(cuda, tmp_path, reader_kind, **kw):
    """One warmed trainer over a pass of 4 batches of 16 rows (bucket 64)
    from the rows in memory or from chunk files of 32 rows."""
    from paddle_tpu_torch.data import batch
    from paddle_tpu_torch.data.chunks import chunk_reader, dump_to_chunks
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = _loop_model(cuda, 4)
    loss, _ = _loop_fns(model)
    mem = _loop_rows(7, 4, hi=(60,))
    paths = dump_to_chunks(lambda: (r for b in mem() for r in b),
                           str(tmp_path / "chunks"), samples_per_chunk=32)
    reader = {"memory": mem,
              "chunks": batch(chunk_reader(paths), 16)}[reader_kind]
    tr = Trainer(loss, Adam(1e-3), device=cuda, **kw)
    tr.train(_loop_rows(8, 1, hi=(60,)), model.tree(),
             feeder=_loop_feeder(cuda), handle_signals=False)
    return tr, model, reader


@pytest.mark.gpu
def test_a_chunk_pass_equals_the_in_memory_pass_on_card(cuda, tmp_path):
    """The same rows from chunk files and from memory through the feeder
    into the graphed trainer: the same costs and parameters bit for bit,
    one replay and one #9 and #10 a step."""
    res = {}
    for kind in ("memory", "chunks"):
        tr, model, reader = _chunk_pass(cuda, tmp_path / kind, kind)
        costs = []
        (p, s), launches, d = _counted(lambda: tr.train(
            reader, model.tree(), feeder=_loop_feeder(cuda),
            event_handler=lambda e: costs.append(e.cost)
            if type(e).__name__ == "EndIteration" else None,
            handle_signals=False))
        res[kind] = (p, costs, launches, d)
    (pm, cm, lm, _), (pc, cc, lc, dc) = res["memory"], res["chunks"]
    assert cc == cm and len(cc) == 4
    assert _tree_diff(pc, pm) == 0.0
    assert lc == lm == {"lstm_seq_train": 4, "lstm_seq_bwd": 4}
    assert _replays(dc, "step") == (0, 4)


@pytest.mark.gpu
def test_a_truncated_checkpoint_falls_back_and_resumes_on_card(cuda,
                                                               tmp_path):
    """``ckpt.write`` truncating the last pass's params.tar: verification
    refuses that pass, the load falls back to the pass before, and
    ``resume=True`` retrains the last pass bit-equal to the run with no
    fault, replaying the step's graph."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.trainer.checkpoint import (latest_pass,
                                                     load_checkpoint,
                                                     pass_dir,
                                                     verify_checkpoint)
    tr, model, reader = _chunk_pass(cuda, tmp_path, "chunks")
    want_p, want_s = tr.train(reader, model.tree(), num_passes=3,
                              feeder=_loop_feeder(cuda),
                              handle_signals=False)
    out = str(tmp_path / "ckpt")
    tr.output_dir = out
    plan = faults.FaultPlan()
    plan.add("ckpt.write", "truncate", nth=7, truncate_to=100)
    with plan.installed():
        tr.train(reader, model.tree(), num_passes=3,
                 feeder=_loop_feeder(cuda), handle_signals=False)
    assert plan.fired == [("ckpt.write", 7, "truncate")]
    assert latest_pass(out) == 2 and not verify_checkpoint(pass_dir(out, 2))
    assert latest_pass(out, verify=True) == 1
    assert load_checkpoint(out, device=cuda)[2]["pass_id"] == 1
    (p, s), _, d = _counted(lambda: tr.train(
        reader, model.tree(), num_passes=1, feeder=_loop_feeder(cuda),
        resume=True, handle_signals=False))
    assert _replays(d, "step") == (0, 4)
    assert _tree_diff(p, want_p) == 0.0 and _tree_diff(s, want_s) == 0.0
    assert verify_checkpoint(pass_dir(out, 2))


# -- the model zoo and its ops (CRF, CTC, detection, NCE, sequence) -----------

def _zoo_ops(gen):
    """name -> (fn(*tensors) -> tensor or tuple, inputs on the CPU, the
    indices of the inputs to differentiate). Each is run on the card and
    on the CPU."""
    from paddle_tpu_torch.ops import crf, ctc, detection as D, nce
    from paddle_tpu_torch.ops import sequence as S
    r = lambda *s, k=1.0: torch.randn(s, generator=gen) * k
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=gen)
    B, T, N = 6, 20, 9
    lens = torch.tensor([20, 1, 0, 7, 13, 20])
    em, st, en, tr = r(B, T, N), r(N, k=0.1), r(N, k=0.1), r(N, N, k=0.1)
    tags = ri(N, B, T)
    lp = torch.log_softmax(r(B, 30, 12), -1)
    labels = ri(11, B, 8) + 1
    il = torch.tensor([30, 25, 10, 30, 5, 18])
    ll = torch.tensor([8, 3, 0, 5, 4, 1])
    pri, var = D.prior_box((8, 8), (300, 300), 60.0, 111.0, (2.0, 3.0),
                           device="cpu")
    P = pri.shape[0]
    xy = torch.rand((4, 5, 2), generator=gen) * 0.6
    gt = torch.cat([xy, xy + 0.1 + 0.2 * torch.rand((4, 5, 2),
                                                    generator=gen)], -1)
    gmask = (torch.arange(5)[None] < torch.tensor([5, 2, 1, 3])[:, None]
             ).float()
    glab = ri(20, 4, 5) + 1
    det = lambda loc, conf: torch.func.vmap(lambda a, b: D.detection_output(
        a, b, pri.to(a.device), var.to(a.device), num_classes=21,
        keep_top_k=30))(loc, conf)
    mbox = lambda loc, conf, g, gl, m: torch.func.vmap(
        lambda a, b, c, d, e: D.multibox_loss(
            a, b, pri.to(a.device), var.to(a.device), c, d, e))(
                loc, conf, g, gl, m)
    paths, codes = nce.build_huffman_codes(50, device="cpu")
    x = r(B, T, 8)
    return {
        "crf_loss": (lambda e, s, n, t, tg, ln: crf.crf_loss(e, tg, ln, s, n,
                                                            t),
                     [em, st, en, tr, tags, lens], (0, 1, 2, 3)),
        "crf_decode": (lambda e, s, n, t, ln: crf.crf_decode(e, ln, s, n, t),
                       [em, st, en, tr, lens], ()),
        "ctc_loss": (lambda a, b, c, d: ctc.ctc_loss(a, b, c, d),
                     [lp, il, labels, ll], (0,)),
        "ctc_greedy_decode": (lambda a, b: ctc.ctc_greedy_decode(a, b),
                              [lp, il], ()),
        "multibox_loss": (mbox, [r(4, P, 4, k=0.3), r(4, P, 21), gt, glab,
                                 gmask], (0, 1)),
        "detection_output": (det, [r(4, P, 4, k=0.3), r(4, P, 21, k=3.0)],
                             ()),
        "nce": (lambda h, w, b, y, ng: nce._nce_from_negatives(h, y, w, b,
                                                               ng),
                [r(B, 8), r(50, 8, k=0.3), r(50, k=0.1), ri(50, B),
                 ri(50, 10)], (0, 1, 2)),
        "hsigmoid": (lambda h, w, b, y, p, c: nce.hsigmoid_loss(h, y, w, b,
                                                                p, c),
                     [r(B, 8), r(100, 8, k=0.3), r(100, k=0.1), ri(50, B),
                      paths, codes], (0, 1, 2)),
        "context_projection": (lambda a, ln, w: S.context_projection(
            a, ln, -2, 5, w), [x, lens, r(4, 8)], (0, 2)),
        "sequence_conv": (lambda a, ln, f: S.sequence_conv(a, ln, f, -1, 3),
                          [x, lens, r(24, 16)], (0, 2)),
        "sequence_pools": (lambda a, ln: torch.stack([
            S.sequence_pool(a, ln, p) for p in
            ("average", "sum", "sqrt", "max", "min", "last")]),
            [x, lens], (0,)),
        "kmax_seq_score": (lambda a, ln: S.kmax_seq_score(
            torch.round(a * 2), ln, 5), [x[..., 0], lens], ()),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["crf_loss", "crf_decode", "ctc_loss",
                                  "ctc_greedy_decode", "multibox_loss",
                                  "detection_output", "nce", "hsigmoid",
                                  "context_projection", "sequence_conv",
                                  "sequence_pools", "kmax_seq_score"])
def test_zoo_op_on_card_equals_the_cpu(cuda_f32, name):
    """The op and its gradients on the card against the same code on the
    CPU (f32, TF32 off): values and gradients within rtol 1e-4 and 1e-5 of
    the largest magnitude (summation order); integer results (tags,
    tokens, indices, NMS keeps) equal."""
    fn, args, diff = _zoo_ops(torch.Generator().manual_seed(3))[name]
    res = {}
    for dev in ("cpu", cuda_f32):
        a = [t.to(dev) for t in args]
        for i in diff:
            a[i] = a[i].clone().requires_grad_(True)
        out = fn(*a)
        outs = list(out) if isinstance(out, tuple) else [out]
        grads = []
        if diff:
            cot = torch.ones_like(outs[0])
            grads = torch.autograd.grad(outs[0], [a[i] for i in diff], cot)
        res[str(dev)] = [o.detach().cpu() for o in outs + list(grads)]
    for got, want in zip(res[str(cuda_f32)], res["cpu"]):
        if want.dtype.is_floating_point:
            torch.testing.assert_close(
                got, want, rtol=1e-4,
                atol=1e-5 * max(want.abs().max().item(), 1.0))
        else:
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_tagger_runs_the_lstm_kernels_on_card(cuda):
    """A BiLSTM-CRF training step launches #9 and #10 twice (the two
    directions) through one replay, and its decode #8 twice; the decoded
    tags equal the plain route's."""
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.models import BiLSTMCRFTagger
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    gen = torch.Generator().manual_seed(4)
    model = BiLSTMCRFTagger(200, 9, embed_dim=16, hidden=32).init(
        seed=1, device=cuda)
    data = torch.randint(0, 200, (8, 12), generator=gen).to(cuda)
    lens = torch.tensor([12, 1, 5, 12, 3, 9, 7, 2], device=cuda)
    tags = torch.randint(0, 9, (8, 12), generator=gen).to(cuda)
    tr = Trainer(lambda p, d, ln, t: model.call(p, SeqBatch(d, ln), t,
                                                method="loss"),
                 Adam(1e-3), device=cuda)
    p, s = model.tree(), Adam(1e-3).init(model.tree())
    p, s, _ = tr.step(p, s, data, lens, tags)              # the capture
    (p, s, cost), launches, d = _counted(lambda: tr.step(p, s, data, lens,
                                                         tags))
    assert torch.isfinite(cost)
    assert launches == {"lstm_seq_train": 2, "lstm_seq_bwd": 2}
    assert _replays(d, "step") == (0, 1)
    sb = SeqBatch(data, lens)
    model.decode(sb)                                       # the capture
    (dec, score), launches, d = _counted(lambda: model.decode(sb))
    assert launches == {"lstm_seq": 2} and _replays(d, "decode") == (0, 1)
    plain, plain_score = model.decode(sb, route="plain")
    assert torch.equal(dec, plain)
    torch.testing.assert_close(score, plain_score, rtol=1e-4, atol=1e-4)
    assert not dec[1, 1:].any()


@pytest.mark.gpu
def test_lm_remat_step_is_bit_equal_on_card(cuda):
    """remat=True recomputes each block in the backward: the attention
    forward (#1) twice a block, #2 and #3 once, and the loss and every
    gradient bit-equal to remat=False; so is an Adam step through the
    trainer's graph, whose capture holds the recompute."""
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    ids = torch.randint(0, 300, (2, 96),
                        generator=torch.Generator().manual_seed(5)).to(cuda)
    res, stepped = {}, {}
    for remat in (False, True):
        model = TransformerLM(300, d_model=128, n_heads=2, n_layers=2,
                              max_len=128, remat=remat).init(seed=2,
                                                             device=cuda)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                          model.tree())

        def run():
            loss = model.call(leaves, ids, method="loss")
            return loss, torch.autograd.grad(
                loss, [v for _, v in tree_items(leaves)])

        res[remat] = _counted(run)
        tr = Trainer(lambda p, x, m=model: m.call(p, x, method="loss"),
                     Adam(1e-3), device=cuda)
        tr.step(model.tree(), tr.opt.init(model.tree()), ids)  # capture
        (p, _, cost), launches, d = _counted(
            lambda: tr.step(model.tree(), tr.opt.init(model.tree()), ids))
        assert _replays(d, "step") == (0, 1)
        assert launches == res[remat][1]
        stepped[remat] = (cost, tree_map(torch.clone, p))
    (l0, g0), n0, _ = res[False]
    (l1, g1), n1, _ = res[True]
    assert torch.equal(stepped[False][0], stepped[True][0])
    for (_, a), (_, b) in zip(tree_items(stepped[False][1]),
                              tree_items(stepped[True][1])):
        assert torch.equal(a, b)
    assert n0 == {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                  "flash_attention_bwd_dkv": 2}
    assert n1 == dict(n0, flash_attention_fwd=4)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# the recurrences' routes (ops/rnn_kernels.py plan_route)
# ---------------------------------------------------------------------------

def _lstm_fwd_args(B, T, H, dtype, gen, device):
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        device, dtype)
    lens = torch.randint(0, T + 1, (B,), generator=gen).to(device,
                                                           torch.int32)
    return (rnd(B, T, 4 * H, scale=0.5), lens, rnd(H, 4 * H, scale=0.05),
            rnd(4 * H, scale=0.1), rnd(B, H, scale=0.5), rnd(B, H, scale=0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_lstm_matches_whole_launches_on_card(cuda, dtype):
    """A batch both routes take (B=96, H=256): the tiles of 32 forced by
    small limits against one launch, forward and backward, the tiled
    backward bit-equal across two runs."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    B, T, H = 96, 20, 256
    gen = torch.Generator().manual_seed(31)
    fwd = _lstm_fwd_args(B, T, H, dtype, gen, cuda)
    sms, smem = rk.card_limits(0)
    whole = rk.lstm_sequence_fused(*fwd, forget_bias=1.0, save_cell=True)
    limits = (16, smem)           # #9 at H = 256 fits 32 rows on 16 SMs
    tiled_rt = rk.plan_route("lstm_seq_train", B, H, dtype, *limits)
    assert tiled_rt.kind == "tiles"
    before = ck.LAUNCHES["lstm_seq_train"]
    with rk.forced_limits(*limits):
        tiled = rk.lstm_sequence_fused(*fwd, forget_bias=1.0,
                                       save_cell=True)
    assert ck.LAUNCHES["lstm_seq_train"] - before == len(tiled_rt.tiles)
    for g, w in zip(tiled, whole):
        _lstm_close(g, w, dtype)
    args = fwd + (whole[0], whole[3]) + tuple(
        (torch.randn(s, generator=gen) * 0.1).to(cuda, dtype)
        for s in ((B, T, H), (B, H), (B, H)))
    want = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0)
    bwd_rt = rk.plan_route("lstm_seq_bwd", B, H, dtype, 32, smem)
    assert bwd_rt.kind == "tiles"
    with rk.forced_limits(32, smem):
        got = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0)
        again = rk.lstm_sequence_fused_bwd(*args, forget_bias=1.0)
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), i
        _lstm_close(g, w, dtype, du=i == 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_gru_backward_is_bit_equal_past_its_limit_on_card(cuda, dtype):
    """#12 at B=128, H=512 (past its one-launch limit): the card's own
    route tiles it, bit-equal across two runs and within the LSTM
    tolerances of the plain version."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    B, T, H = 128, 12, 512
    rt = rk.plan_route("gru_seq_bwd", B, H, dtype, *rk.card_limits(0))
    assert rt.kind == "tiles"
    gen = torch.Generator().manual_seed(37)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda, dtype)
    lens = torch.randint(0, T + 1, (B,), generator=gen).to(cuda,
                                                           torch.int32)
    xw, u, h0 = rnd(B, T, 3 * H, scale=0.5), rnd(H, 3 * H, scale=0.05), \
        rnd(B, H, scale=0.5)
    out, _ = rk.gru_sequence_fused(xw, lens, u, None, h0)
    args = (xw, lens, u, h0, out, rnd(B, T, H, scale=0.1),
            rnd(B, H, scale=0.1))
    before = ck.LAUNCHES["gru_seq_bwd"]
    got = rk.gru_sequence_fused_bwd(*args)
    again = rk.gru_sequence_fused_bwd(*args)
    assert ck.LAUNCHES["gru_seq_bwd"] - before == 2 * len(rt.tiles)
    want = rk.gru_sequence_fused_bwd(*args, route="plain")
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), i
        _lstm_close(g, w, dtype, du=i == 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,H", [("lstm_seq_bwd", 256),
                                    ("lstm_seq_bwd", 512),
                                    ("lstm_seq_bwd", 1280),
                                    ("gru_seq_bwd", 256),
                                    ("gru_seq_bwd", 512)])
def test_bwd_planner_meets_the_kernels_limit_on_card(cuda, name, H, dtype):
    """The planner's copy of #10's and #12's layouts and launch bounds
    against the kernels' own residency check: at the largest B the
    planner launches whole, the raw kernel launches; one row more, the
    planner tiles and the raw kernel raises "split the batch" (where no
    B is whole, B = 1 raises)."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    limits = rk.card_limits(0)
    whole = lambda n: rk.plan_route(name, n, H, dtype, *limits).kind \
        == "whole"
    lo, hi = 0, 1
    while whole(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if whole(mid) else (lo, mid)
    T = 2
    gen = torch.Generator().manual_seed(53)

    def launch(B):
        rnd = lambda *s: (torch.randn(s, generator=gen) * 0.1).to(cuda,
                                                                  dtype)
        lens = torch.full((B,), T, dtype=torch.int32, device=cuda)
        if name == "lstm_seq_bwd":
            return rk._lstm_sequence_fused_bwd_kernel(
                rnd(B, T, 4 * H), lens, rnd(H, 4 * H), rnd(4 * H),
                rnd(B, H), rnd(B, H), rnd(B, T, H), rnd(B, T, H),
                rnd(B, T, H), rnd(B, H), rnd(B, H), 1.0)
        return rk._gru_sequence_fused_bwd_kernel(
            rnd(B, T, 3 * H), lens, rnd(H, 3 * H), rnd(B, H), rnd(B, T, H),
            rnd(B, T, H), rnd(B, H))

    if lo:
        assert all(torch.isfinite(t).all() for t in launch(lo))
        torch.cuda.synchronize()
    assert not whole(lo + 1)
    with pytest.raises(ValueError, match="split the batch"):
        launch(lo + 1)


@pytest.mark.gpu
def test_h1280_training_step_takes_the_scan_on_card(cuda):
    """At H = 1280 no tile of #9 or #10 fits: ``lstm`` runs the step loop
    (no launch) and its gradients equal the plain versions' (f32)."""
    from paddle_tpu_torch.ops import rnn as R
    B, T, D, H = 64, 16, 32, 1280
    gen = torch.Generator().manual_seed(41)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda).requires_grad_()
    x, w, u, b = (rnd(B, T, D), rnd(D, 4 * H, scale=0.05),
                  rnd(H, 4 * H, scale=0.02), rnd(4 * H, scale=0.1))
    lens = torch.randint(1, T + 1, (B,), generator=gen).to(cuda)
    ck.reset_launch_counts()
    out, st = R.lstm(x, lens, w, u, b, forget_bias=1.0)
    got = torch.autograd.grad((out * out).sum() + st.c.sum(), (x, w, u, b))
    assert ck.ROUTES == {("lstm_seq_train", "scan"): 1,
                         ("lstm_seq_bwd", "scan"): 1}
    assert ck.LAUNCHES["lstm_seq_train"] == ck.LAUNCHES["lstm_seq_bwd"] == 0
    out2, st2 = R.lstm(x, lens, w, u, b, forget_bias=1.0, route="plain")
    want = torch.autograd.grad((out2 * out2).sum() + st2.c.sum(),
                               (x, w, u, b))
    torch.testing.assert_close(out, out2, atol=1e-5, rtol=1e-4)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, atol=1e-5 * wg.abs().max().item(),
                                   rtol=1e-4)


@pytest.mark.gpu
def test_backward_replays_the_scan_where_no_tile_fits_on_card(cuda):
    """Limits under which #9 fits and #10 does not: the forward launches
    the kernel and the backward replays the step loop under autograd (as
    JAX's ``_lstm_fused_bwd`` does)."""
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops import rnn_kernels as rk
    B, T, D, H = 32, 10, 16, 256
    sms, smem = rk.card_limits(0)
    limits = (16, smem)           # #9: 32 rows fit, #10: 64 blocks do not
    assert rk.plan_route("lstm_seq_train", B, H, torch.float32,
                         *limits).kind == "whole"
    assert rk.plan_route("lstm_seq_bwd", B, H, torch.float32,
                         *limits).kind == "scan"
    gen = torch.Generator().manual_seed(43)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        cuda).requires_grad_()
    x, w, u, b = (rnd(B, T, D), rnd(D, 4 * H, scale=0.1),
                  rnd(H, 4 * H, scale=0.05), rnd(4 * H, scale=0.1))
    lens = torch.randint(1, T + 1, (B,), generator=gen).to(cuda)
    ck.reset_launch_counts()
    with rk.forced_limits(*limits):
        out, _ = R.lstm(x, lens, w, u, b)
    got = torch.autograd.grad(out.square().sum(), (x, w, u, b))
    assert ck.ROUTES == {("lstm_seq_train", "whole"): 1,
                         ("lstm_seq_bwd", "scan"): 1}
    assert ck.LAUNCHES["lstm_seq_train"] == 1
    assert ck.LAUNCHES["lstm_seq_bwd"] == 0
    out2, _ = R.lstm(x, lens, w, u, b, route="plain")
    want = torch.autograd.grad(out2.square().sum(), (x, w, u, b))
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, atol=1e-5 * wg.abs().max().item(),
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the prefix cache, the ops A.4 left and the host-offloaded table
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefix_cache_engine_on_card_matches_the_cache_off_engine(
        cuda, kv_dtype):
    """Requests sharing a declared 50-token prefix (3 pages of 16 and 2
    tokens of a fourth) through ServingEngine.step() with the prefix
    cache on the card: the hits admit through the hit graph (the copy on
    write of the partial page, then prefill_paged), and every
    continuation equals the cache-off engine's (and, in f32, the solo
    plain decode)."""
    from paddle_tpu_torch.core import graphs
    model = TransformerLM(101, d_model=128, n_heads=2, n_layers=2,
                          max_len=256).init(seed=5, device=cuda)
    rs = np.random.RandomState(6)
    prefix = rs.randint(0, 101, 50)
    work = [(np.concatenate([prefix, rs.randint(0, 101, int(n))]), int(m))
            for n, m in ((9, 20), (3, 9), (30, 14), (17, 25))]
    outs = {}
    for cache in (False, True):
        graphs.reset_dispatch_counts()
        eng = ServingEngine(model, slots=3, segment=8, page_block=16,
                            cache_bucket=64, kv_dtype=kv_dtype,
                            prefix_cache=cache, device=cuda)
        got = []
        for wave in (work[:1], work[1:]):
            rids = [eng.submit(p, n, prefix_len=prefix.size)
                    for p, n in wave]
            while not all(eng.poll(r)[1] for r in rids):
                eng.step()
            got += [eng.poll(r)[0] for r in rids]
        outs[cache] = got
        if cache:
            assert eng.stats()["prefix_hits"] == 3
            assert eng.stats()["cow_copies"] == 3
            hit = [n for keys in graphs.DISPATCHES.values()
                   for label, n in keys.items() if label.startswith("hit(")]
            assert hit and sum(n["captures"] + n["replays"]
                               for n in hit) >= 1
    assert outs[True] == outs[False]
    if kv_dtype is None:
        for (p, n), toks in zip(work, outs[True]):
            ids = torch.as_tensor(p[None].astype(np.int64), device=cuda)
            want = model.generate_greedy(ids, n, route="plain")[0, len(p):]
            assert toks == want.cpu().tolist()


@pytest.mark.gpu
def test_a4b_ops_on_card_match_the_cpu(cuda):
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import norm as N
    from paddle_tpu_torch.ops import pool as P
    from paddle_tpu_torch.ops import sparse as S
    gen = torch.Generator().manual_seed(47)
    rnd = lambda *s: torch.randn(s, generator=gen)
    feat = rnd(14, 14, 64)
    rois = torch.tensor([[0, 0, 223, 223], [10, 20, 90, 60], [5, 5, 5, 5],
                         [100, 30, 200, 130]], dtype=torch.float32)
    want = P.roi_pool(feat, rois, (7, 7), spatial_scale=1 / 16)
    got = P.roi_pool(feat.to(cuda), rois.to(cuda), (7, 7),
                     spatial_scale=1 / 16)
    assert torch.equal(got.cpu(), want)
    x, w = rnd(2, 8, 16, 16, 3), rnd(3, 3, 3, 3, 8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # cuDNN's f32, not TF32
    try:
        got = C.conv3d(x.to(cuda), w.to(cuda), padding=1).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(got, C.conv3d(x, w, padding=1), atol=1e-4,
                               rtol=1e-4)
    x, g, b = rnd(2, 7, 7, 64), rnd(64), rnd(64)
    torch.testing.assert_close(
        N.group_norm(x.to(cuda), g.to(cuda), b.to(cuda), 32).cpu(),
        N.group_norm(x, g, b, 32), atol=1e-5, rtol=1e-5)
    v, i = P.max_pool2d_with_index(x.to(cuda), 3, 2, 1)
    vc, ic = P.max_pool2d_with_index(x, 3, 2, 1)
    assert torch.equal(v.cpu(), vc) and torch.equal(i.cpu(), ic)
    table = rnd(1000, 16)
    ids = torch.from_numpy(np.random.RandomState(3).zipf(1.3, 500) % 1000)
    grads = rnd(500, 16)
    sr = S.SelectedRows(ids.to(cuda), grads.to(cuda), 1000)
    assert torch.equal(S.sgd_sparse_update(table.to(cuda), sr, 0.1).cpu(),
                       S.sgd_sparse_update(table, S.SelectedRows(
                           ids, grads, 1000), 0.1))


@pytest.mark.gpu
def test_host_embedding_on_card_is_bit_equal_to_a_card_table(cuda):
    import torch.nn.functional as F
    from paddle_tpu_torch.runtime import (HostEmbeddingTable,
                                          HostEmbedPrefetcher)
    V, Dm, lr = 5000, 16, 0.1
    gen = torch.Generator().manual_seed(53)
    init = torch.randn((V, Dm), generator=gen) * 0.1
    w = torch.randn(Dm, generator=gen).to(cuda)
    rs = np.random.RandomState(8)
    batches = [rs.zipf(1.3, (32, 8)) % V for _ in range(4)]
    table = HostEmbeddingTable(V, Dm, lr=lr, capacity=256,
                               init=init.numpy(), device=cuda)
    pf = HostEmbedPrefetcher(table, iter(batches))
    while (b := pf.next()) is not None:
        rows = b.rows.detach().requires_grad_()
        (g,) = torch.autograd.grad(
            torch.tanh(F.embedding(b.inverse, rows) @ w).sum(), rows)
        pf.commit(b, g)
    dense = init.to(cuda)
    for ids in batches:
        tb = dense.detach().requires_grad_()
        idx = torch.as_tensor(ids, device=cuda)
        (g,) = torch.autograd.grad(torch.tanh(F.embedding(idx, tb) @ w)
                                   .sum(), tb)
        touched = torch.unique(idx)
        dense[touched] -= (lr * g[touched].double()).float()
    assert torch.equal(torch.from_numpy(table.rows_host(np.arange(V))),
                       dense.cpu())


# ---------------------------------------------------------------------------
# head widths up to 256 (ROADMAP B.1.4): #1-#3's D = 256 bodies
# (csrc/flash_wide.cu) and the pad routes, #4-#7 at four chunks a lane
# ---------------------------------------------------------------------------

_WIDE = (12, 136, 200, 256)


def _wide_route(D):
    return None if D in ck.KERNEL_HEAD_DIMS else \
        f"pad{next(w for w in ck.KERNEL_HEAD_DIMS if w >= D)}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", _WIDE)
def test_flash_kernels_at_wide_head_widths_on_card(cuda, dtype, D):
    """#1, #2 and #3 at D in {12, 136, 200, 256} against the plain version
    (causal and not, with kv_lens, a caller's scale off the multiples of
    8): natively at 256, else by the counted pad route."""
    gen = torch.Generator().manual_seed(D + 1)
    B, T, H = 2, 150, 3
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda, dtype)
    q, k, v, do = (rnd(B, T, H, D) for _ in range(4))
    lens = torch.tensor([T, 77], device=cuda)
    scale = None if D % 8 == 0 else 0.7 * D ** -0.5
    route = _wide_route(D)
    for causal in (False, True):
        ck.reset_launch_counts()
        o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens,
                                        scale=scale)
        po, plse = ck.flash_attention_fwd(q, k, v, causal=causal,
                                          kv_lens=lens, scale=scale,
                                          route="plain")
        assert o.shape == (B, T, H, D)
        if dtype == torch.float32:
            torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
        else:
            _bf16_tc_close(o, po)
        torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-4)
        got = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=causal,
                                     kv_lens=lens, scale=scale)
        want = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=causal,
                                      kv_lens=lens, scale=scale,
                                      route="plain")
        for g, w in zip(got, want):
            assert g.shape == w.shape
            if dtype == torch.bfloat16:
                _bf16_tc_close(g, w)
            else:
                _bwd_close(g, w, dtype)
        assert {n: ck.LAUNCHES[n] for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")} == dict.fromkeys(
            ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"), 1)
        assert ck.ROUTES == ({} if route is None else {
            ("flash_attention_fwd", route): 1,
            ("flash_attention_bwd_dq", route): 1,
            ("flash_attention_bwd_dkv", route): 1})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 200])
@pytest.mark.parametrize("T,S", [(200, 136), (136, 200)])
def test_wide_flash_causal_s_not_t_and_views_on_card(cuda, dtype, D, T, S):
    """Causal at S != T with kv_lens, and q/k/v as views 2 elements past a
    16-byte boundary (the copy16 route at 256, pad256 at 200), against
    the plain version."""
    gen = torch.Generator().manual_seed(T + S + D)
    B, H = 2, 2
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda, dtype)
    q, k, v, do = rnd(B, T, H, D), rnd(B, S, H, D), rnd(B, S, H, D), \
        rnd(B, T, H, D)
    lens = torch.tensor([S, S // 2 + 3], device=cuda)
    n = B * T * H * D
    flat = torch.randn(n + 2, generator=gen).to(cuda, dtype)
    qv = flat[2:].view(B, T, H, D)
    qv.copy_(q)
    for qq in (q, qv):
        o, lse = ck.flash_attention_fwd(qq, k, v, causal=True, kv_lens=lens)
        po, plse = ck.flash_attention_fwd(q, k, v, causal=True,
                                          kv_lens=lens, route="plain")
        if dtype == torch.float32:
            torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
        else:
            _bf16_tc_close(o, po)
        got = ck.flash_attention_bwd(qq, k, v, po, plse, do, causal=True,
                                     kv_lens=lens)
        want = ck.flash_attention_bwd(q, k, v, po, plse, do, causal=True,
                                      kv_lens=lens, route="plain")
        for g, w in zip(got, want):
            if dtype == torch.bfloat16:
                _bf16_tc_close(g, w)
            else:
                _bwd_close(g, w, dtype)
    ck.reset_launch_counts()
    ck.flash_attention_fwd(qv, k, v, causal=True)
    assert ck.ROUTES == {("flash_attention_fwd",
                          _wide_route(D) or "copy16"): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_backward_is_bit_equal_run_to_run_on_card(cuda, dtype):
    """#2 and #3 at D = 256 (one owner a sum, a fixed order, no atomics):
    two runs on the same inputs give the same bits."""
    gen = torch.Generator().manual_seed(256)
    q, k, v, do = (torch.randn(2, 300, 3, 256, generator=gen).to(cuda, dtype)
                   for _ in range(4))
    lens = torch.tensor([300, 123], device=cuda)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=True, kv_lens=lens)
    a = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                               kv_lens=lens)
    b = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                               kv_lens=lens)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DECODE_DTYPES)
@pytest.mark.parametrize("D", _WIDE)
def test_decode_kernels_at_wide_head_widths_on_card(cuda, dtype, D):
    """#4-#7 at D in {12, 136, 200, 256}, every query and cache dtype,
    against their plain versions: natively at the multiples of 8 (four
    chunks a lane past 128), by the counted pad8 route at 12; the paged
    read of a split count equal to the dense read of its gathered pages."""
    gen = torch.Generator().manual_seed(D + 7)
    qdt, kv = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    B, L, H, P, bs, NB = 4, 300, 3, 40, 16, 12
    q = torch.randn(B, H, D, generator=gen).to(cuda, qdt)
    pos = torch.tensor([299, 150, 0, 17], device=cuda, dtype=torch.int32)
    k, v, kp, vp = (torch.randn(shape, generator=gen).to(cuda) for shape in
                    ((B, L, H, D), (B, L, H, D), (P, bs, H, D),
                     (P, bs, H, D)))
    if kv == "int8":
        (k, ks), (v, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
        (kp, kps), (vp, vps) = ck.quantize_kv(kp), ck.quantize_kv(vp)
    else:
        k, v, kp, vp = (t.to(qdt) for t in (k, v, kp, vp))
        ks = vs = kps = vps = None
    tables = torch.randint(1, P, (B, NB), generator=gen).to(cuda,
                                                             torch.int32)
    ck.reset_launch_counts()
    o = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    po = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs,
                             route="plain")
    pg = ck.paged_decode_attention(q, kp, vp, tables, pos, k_scale=kps,
                                   v_scale=vps)
    ppg = ck.paged_decode_attention(q, kp, vp, tables, pos, k_scale=kps,
                                    v_scale=vps, route="plain")
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(pg, ppg, atol=1e-5, rtol=1e-4)
    q8 = "_q" if kv == "int8" else ""
    assert ck.ROUTES == ({} if D % 8 == 0 else {
        ("decode_attention" + q8, "pad8"): 1,
        ("paged_decode_attention" + q8, "pad8"): 1})
    if D % 8 == 0:
        n = ck.decode_splits(B * H, NB * bs)[0]
        dense = ck._decode_attention_kernel(
            q, ck.gather_pages(kp, tables), ck.gather_pages(vp, tables), pos,
            D ** -0.5, None if kps is None else ck.gather_pages(kps, tables),
            None if vps is None else ck.gather_pages(vps, tables), n)
        assert torch.equal(pg, dense)


# ---------------------------------------------------------------------------
# the fluid executor on the card: one CUDA graph a key, LRU eviction
# ---------------------------------------------------------------------------

def _fluid_lstm_program(fluid, vocab=500, embed=32, hidden=64):
    layers = fluid.layers
    fluid.reset_default_programs()
    words = layers.data("words", shape=(-1,), dtype="int32")
    lens = layers.data("lens", shape=(), dtype="int32")
    label = layers.data("label", shape=(), dtype="int32")
    emb = layers.embedding(words, (vocab, embed))
    last = layers.sequence_last_step(layers.dynamic_lstm(emb, lens, hidden),
                                     lens)
    loss = layers.mean(layers.softmax_with_cross_entropy(
        layers.fc(last, 2), label))
    fluid.AdamOptimizer(1e-3).minimize(loss)
    return loss


@pytest.mark.gpu
def test_fluid_executor_graph_equals_the_eager_run_on_card(cuda):
    """A fluid LSTM program trained 4 runs on the card: the graphed runs
    (one capture, then replays, #9 and #10 once a run) give the eager
    route's losses and parameters bit for bit, and the scope keeps its
    tensors (written in place)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core import graphs
    loss = _fluid_lstm_program(fluid)
    main = fluid.default_main_program()
    rs = np.random.RandomState(0)
    feed = {"words": rs.randint(0, 500, (16, 20)).astype(np.int32),
            "lens": rs.randint(5, 21, 16).astype(np.int32),
            "label": rs.randint(0, 2, 16).astype(np.int32)}
    runs = {}
    for route in ("graphed", "eager"):
        exe = fluid.Executor(device=cuda, scope=fluid.Scope())
        exe.run(fluid.default_startup_program())
        ck.reset_launch_counts()
        graphs.reset_dispatch_counts()
        if route == "eager":
            with graphs.disabled():
                losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                          for _ in range(4)]
        else:
            losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]]
            held = dict(exe.scope.vars)        # the cache's buffers now
            losses += [exe.run(main, feed=feed, fetch_list=[loss])[0]
                       for _ in range(3)]
            counts = graphs.DISPATCHES["fluid.Executor"]
            assert [n for n in counts.values()] == [
                {"captures": 1, "replays": 3}]
            assert all(exe.scope.get(n) is v for n, v in held.items())
        assert ck.LAUNCHES["lstm_seq_train"] == 4
        assert ck.LAUNCHES["lstm_seq_bwd"] == 4
        runs[route] = (losses, {n: v.clone() for n, v in
                                exe.scope.vars.items()})
    np.testing.assert_array_equal(runs["graphed"][0], runs["eager"][0])
    for n, v in runs["eager"][1].items():
        assert torch.equal(runs["graphed"][1][n], v), n


@pytest.mark.gpu
def test_fluid_executor_lru_drops_evicted_graphs_on_card(cuda):
    """An LRU of one key over two batch shapes: each eviction drops its
    graph (one live graph), an evicted shape recaptures, and the results
    equal an executor that keeps both keys."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core import graphs
    fluid.reset_default_programs()
    x = fluid.layers.data("x", shape=(8,))
    out = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 4)
    main = fluid.default_main_program()
    exes = [fluid.Executor(device=cuda, scope=fluid.Scope(),
                           cache_capacity=c) for c in (1, 4)]
    for exe in exes:
        exe.run(fluid.default_startup_program())
    graphs.reset_dispatch_counts()
    rs = np.random.RandomState(1)
    for bs in (4, 7, 4, 7):
        xs = rs.randn(bs, 8).astype(np.float32)
        a, b = (exe.run(main, feed={"x": xs}, fetch_list=[out])[0]
                for exe in exes)
        np.testing.assert_array_equal(a, b)
    # the startup program's key, then each shape evicts the one before
    assert exes[0].stats["cache_evictions"] == 4
    assert len(exes[0].graphs._graphs) == 1
    assert len(exes[1].graphs._graphs) == 2


@pytest.mark.gpu
def test_v2_flagship_first_step_equals_the_plain_route_on_card(cuda):
    """The v2 LSTM text classifier (data -> embedding -> simple_lstm ->
    last_seq -> fc -> classification_cost, Adam) trained one SGD.train
    step on the card through #9/#10, against the same step with the
    recurrence routed plain from the same scope: the cost within 1e-5,
    every parameter within 1e-5, Adam's first moments within rtol 1e-4
    plus 1e-5 of each tensor's largest (chip_smoke's fluid_step_check)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import v2 as paddle
    from paddle_tpu_torch.fluid.registry import routed
    fluid.reset_default_programs()
    words = paddle.layer.data("words",
                              paddle.data_type.integer_value_sequence(500))
    label = paddle.layer.data("label", paddle.data_type.integer_value(2))
    lstm = paddle.networks.simple_lstm(paddle.layer.embedding(words, 32), 64)
    cost = paddle.layer.classification_cost(
        paddle.layer.fc(paddle.layer.last_seq(lstm), 2), label)
    trainer = paddle.SGD(cost, paddle.optimizer.Adam(2e-3), device=cuda)
    start = {n: v.detach().clone() for n, v in trainer.exe.scope.vars.items()}
    rs = np.random.RandomState(0)
    data = rs.randint(0, 500, (16, 20)).astype(np.int32)
    lens = rs.randint(5, 21, 16).astype(np.int32)
    feed = {"words": data, "words__len__": lens,
            "label": (data[np.arange(16), lens - 1] % 2).astype(np.int32)}
    costs = []
    ck.reset_launch_counts()
    trainer.train(lambda: iter([feed]), event_handler=lambda e: costs.append(
        e.cost) if type(e).__name__ == "EndIteration" else None)
    assert ck.LAUNCHES["lstm_seq_train"] == 1
    assert ck.LAUNCHES["lstm_seq_bwd"] == 1
    exe = fluid.Executor(device=cuda, scope=fluid.Scope())
    for n, v in start.items():
        exe.scope.set(n, v.clone())
    with routed("plain"):
        plain, = exe.run(fluid.default_main_program(), feed=feed,
                         fetch_list=[cost.var])
    assert abs(costs[0] - float(plain)) <= 1e-5
    for n in start:
        a, b = trainer.exe.scope.get(n), exe.scope.get(n)
        if n.endswith("@moment1"):
            assert torch.allclose(a, b, rtol=1e-4,
                                  atol=1e-5 * b.abs().max().item()), n
        elif "@" not in n and a.is_floating_point():
            assert (a - b).abs().max().item() <= 1e-5, n


# ---------------------------------------------------------------------------
# the parallel plane: gloo ranks on cuda:0
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_ring_attention_on_two_gloo_ranks_matches_flash_on_card(cuda,
                                                                 tmp_path):
    """The zigzag ring over seq = 2 gloo ranks that both sit on cuda:0,
    forward and backward, equals one flash_attention call on the whole
    sequence within the f32 bound (o at 1e-5 / 1e-4; gradients at 2e-5
    of the largest magnitude, rtol 1e-4: summation order only), each
    rank launching #1-#3 twice (two ring steps)."""
    import torch_spmd
    ranks = torch_spmd.run_world(tmp_path, [("ring", "torch_spmd:gpu_ring",
                                             {})], world=2, timeout=300)
    for r in range(2):
        got = torch_spmd.result(ranks, "ring", r)
        for i, (a, b) in enumerate(zip(got["ring"], got["flash"])):
            atol = 1e-5 if i == 0 else 2e-5 * float(np.abs(b).max())
            np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4)
        assert got["ring_launches"]["flash_attention_fwd"] == 2
        assert got["ring_launches"]["flash_attention_bwd_dq"] == 2
        assert got["ring_launches"]["flash_attention_bwd_dkv"] == 2


@pytest.mark.gpu
def test_staged_exactly_where_gloo_refuses_cuda_tensors_on_card(cuda,
                                                                 tmp_path):
    """collectives.STAGED counts a transport exactly when gloo refuses it
    for CUDA tensors, tried raw in a world of its own (a refusal may abort
    the ranks), and collectives.GLOO_CUDA_OPS lists the others."""
    import torch_spmd

    from paddle_tpu_torch.parallel import collectives as cc
    taken = []
    for op in ("broadcast", "all_gather", "all_to_all", "send_recv"):
        try:
            ranks = torch_spmd.run_world(
                tmp_path / op, [(op, "torch_spmd:gpu_raw_op", {"op": op})],
                world=2, timeout=120)
            ok = all(r[op][0] == "ok" for r in ranks)
        except AssertionError:          # a rank aborted
            ok = False
        if ok:
            taken.append(op)
    ranks = torch_spmd.run_world(tmp_path / "port",
                                 [("staged", "torch_spmd:gpu_staged", {})],
                                 world=2, timeout=120)
    for r in range(2):
        staged = torch_spmd.result(ranks, "staged", r)
        assert staged == sorted({"broadcast", "all_gather", "all_to_all",
                                 "send_recv"} - set(taken)), (staged, taken)
    assert sorted(taken) == sorted(cc.GLOO_CUDA_OPS)


@pytest.mark.gpu
def test_h100_peak_row_resolves_on_card(cuda, monkeypatch):
    """On the H100 the roofline's peaks resolve to its data-sheet row
    (989 TFLOP/s dense bf16, 3350 GB/s), not None."""
    from paddle_tpu_torch.obs import roofline
    monkeypatch.delenv("PADDLE_TPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PEAK_HBM_GBPS", raising=False)
    name = torch.cuda.get_device_name(0)
    if name not in roofline.PEAK_TFLOPS:
        pytest.skip(f"{name} has no peak row (the table holds the H100)")
    assert roofline.peak_flops_per_sec() == 989e12
    assert roofline.peak_hbm_bytes_per_sec() == 3350e9


@pytest.mark.gpu
def test_graph_replays_reemit_session_counts_on_card(cuda):
    """A graphed body's counts fire at capture only: the capture records
    them and every replay adds them again, so the session's counter
    follows the calls, as LAUNCHES does."""
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.core.graphs import GraphCache
    cache = GraphCache("test.replay", cuda)

    def body(x):
        obs.count("decode.dispatches_total", route="step")
        return x @ x

    r = obs.MetricsRegistry()
    x = torch.ones(64, 64, device=cuda)
    with obs.ObsSession(registry=r).installed():
        for _ in range(5):
            cache.run("b", body, {"x": x}, cost="test.body")
        torch.cuda.synchronize()
    assert r.counter("decode.dispatches_total").get(route="step") == 5
    assert r.counter("graphs.captures_total").get() == 1
    assert r.counter("fluid.device_flops_total").get() == 5 * 2 * 64 ** 3


@pytest.mark.gpu
def test_profiler_reader_sees_a_port_kernel_on_card(cuda):
    """torch.profiler over #4's launches: the reader's device plane holds
    the kernel by name. The profiler may drop the record of its window's
    first kernel, so the window opens with a warm-up launch and the
    reader must keep at least the three launches after it."""
    from paddle_tpu_torch.obs import xplane
    q = torch.randn(2, 4, 64, device=cuda)
    k = torch.randn(2, 128, 4, 64, device=cuda)
    pos = torch.full((2,), 100, dtype=torch.int32, device=cuda)
    ck.decode_attention(q, k, k, pos)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            ck.decode_attention(q, k, k, pos)
        torch.cuda.synchronize()
    space = xplane.read_torch_trace(prof)
    assert space["planes"][0]["name"] == "/device:GPU:0"
    rows = xplane.op_totals(space)
    assert any("decode" in r["op"] and 3 <= r["count"] <= 4
               for r in rows), rows


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, "int8"])
def test_decode_kernel_bytes_noted_at_launch_and_reemitted_on_card(cuda,
                                                                   kv):
    """generate_fused under a session: the cache read's modeled bytes are
    noted where #4/#5 launch, once a layer, and each replay re-emits
    them, so kernels.bytes_total is the registered model summed over the
    decode steps' reads (bucket 64, then 128 rows), and the roofline's
    device bytes hold them."""
    from paddle_tpu_torch import obs
    model = _graph_lm(cuda)
    ids = torch.as_tensor(np.random.RandomState(5).randint(0, 101, (3, 40)),
                          device=cuda)
    r = obs.MetricsRegistry()
    with obs.ObsSession(registry=r).installed():
        model.generate_fused(ids, 40, bucket=64, kv_dtype=kv)
        torch.cuda.synchronize()
    want = sum(obs.roofline.kernel_cost(
        "decode_attention", batch=3, read=min(-(-(40 + j) // 64) * 64, 256),
        n_heads=2, d_head=64, layers=2, kv_dtype=kv, itemsize=4)
        for j in range(1, 40))
    got = r.counter("kernels.bytes_total").get(kernel="decode_attention")
    assert got == pytest.approx(want)
    assert r.counter("fluid.device_bytes_total").get() >= want


# ---------------------------------------------------------------------------
# the elastic plane, the tune plane and the C inference API on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_elastic_fit_equals_sequential_on_card(cuda):
    """ElasticMaster and two ElasticWorker threads on one card train a
    small LSTM text classifier (tests/torch_elastic_net.py) 3 steps: the
    parameters bit-equal to the sequential reference on the card (the
    same graphed shard gradients, the shard-ordered reduce, the graphed
    Adam update), #9 and #10 launched in each worker's graph."""
    import threading
    from torch_elastic_net import flagship, sequential_reference
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.trainer.elastic import ElasticMaster, ElasticWorker
    cfg = dict(vocab=500, embed=32, hidden=64, batch=16, seq_len=20,
               min_len=5)
    loss_fn, make_params, make_opt, batches = flagship(steps=3, **cfg)
    ref, ref_loss = sequential_reference(loss_fn, make_params(cuda),
                                         make_opt, batches, device=cuda)
    em = ElasticMaster(loss_fn, make_opt(), shards_per_step=4,
                       min_workers=2, device=cuda).start()
    stop = threading.Event()
    workers = [ElasticWorker(flagship(steps=0, **cfg)[0], em.address,
                             worker=f"gw{i}", device=cuda) for i in range(2)]
    threads = [threading.Thread(target=w.run, kwargs={"stop": stop},
                                daemon=True) for w in workers]
    for t in threads:
        t.start()
    try:
        params, _, loss = em.fit(batches, make_params(cuda),
                                 progress_timeout=120.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        em.stop()
    assert loss == ref_loss
    for (pa, a), (pb, b) in zip(tree_items(params), tree_items(ref)):
        assert pa == pb and torch.equal(a, b), pa
    for w in workers:
        held = {}
        for g in w.graphs._graphs.values():
            for k, n in g.launches.items():
                held[k] = held.get(k, 0) + n
        assert w.shards_contributed > 0
        assert held.get("lstm_seq_train", 0) > 0
        assert held.get("lstm_seq_bwd", 0) > 0


@pytest.mark.gpu
def test_tuned_engine_tokens_equal_untuned_on_card(cuda):
    """A ServingEngine left to the autotune consults (page_block,
    cache_bucket and prompt buckets from a cache, and a split count for
    its paged reads) serves the untuned engine's greedy tokens."""
    from paddle_tpu_torch import tune
    model = TransformerLM(97, d_model=64, n_heads=4, n_layers=2,
                          max_len=256).init(seed=0, device=cuda)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 97, n).astype(np.int32) for n in (5, 40, 77)]
    kind = torch.cuda.get_device_name(0)
    cache = tune.AutotuneCache()
    cache.put("page_block", "paged_decode_attention", kind, "default",
              {"page_block": 16}, tune.space_hash("page_block"))
    cache.put("bucket_grid", "prefill_dispatch", kind, "prompt",
              {"buckets": [64, 128]}, tune.space_hash("bucket_grid"))
    cache.put("bucket_grid", "prefill_dispatch", kind, "cache",
              {"buckets": [64, 128]}, tune.space_hash("bucket_grid"))
    cache.put("decode_route", "decode_attention", kind, "default",
              {"kernel_min_len": 1,
               "splits": {f"{4 * 4}x{n}": 2 for n in (64, 128, 256)}},
              tune.space_hash("decode_route"))

    def serve(eng):
        rids = [eng.submit(p, 12) for p in prompts]
        eng.start()
        try:
            while not all(eng.poll(r)[1] for r in rids):
                pass
        finally:
            eng.stop()
        return [eng.poll(r)[0] for r in rids]

    want = serve(ServingEngine(model, slots=4, page_block=64,
                               cache_bucket=256,
                               prompt_buckets=(32, 64, 128, 256),
                               device=cuda))
    tune.set_cache(cache)
    try:
        eng = ServingEngine(model, slots=4, device=cuda)
        assert (eng.pool.bs, eng.pool.cache_bucket,
                tuple(eng.pool.prompt_buckets)) == (16, 128, (64, 128))
        assert ck.decode_splits(16, 128) == (2, 64)
        before = ck.LAUNCHES["paged_decode_attention"]
        got = serve(eng)
        assert ck.LAUNCHES["paged_decode_attention"] > before
    finally:
        tune.reset()
    assert got == want


@pytest.mark.gpu
def test_capi_forward_on_card(cuda, tmp_path, monkeypatch):
    """The C inference API (the port's library, built here) on a fluid LSTM
    bundle exported on the card: pti_forward equals InferenceHost.run of
    the same bundle bit for bit, and #8 launches."""
    import ctypes
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.runtime.capi_host import DEVICE_ENV, InferenceHost
    from paddle_tpu_torch.runtime.lib import load_capi
    monkeypatch.delenv(DEVICE_ENV, raising=False)       # the card
    layers = fluid.layers
    fluid.reset_default_programs()
    words = layers.data("words", shape=(-1,), dtype="int32")
    lens = layers.data("lens", shape=(), dtype="int32")
    emb = layers.embedding(words, (500, 32))
    last = layers.sequence_last_step(layers.dynamic_lstm(emb, lens, 64),
                                     lens)
    logits = layers.fc(last, 2)
    exe = fluid.Executor(device=cuda, scope=fluid.Scope())
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "bundle")
    fluid.io.export_inference_model(d, ["words", "lens"], [logits], exe)
    rs = np.random.RandomState(0)
    w = rs.randint(0, 500, (16, 20)).astype(np.int32)
    n = rs.randint(5, 21, 16).astype(np.int32)
    want = InferenceHost(d, device=cuda).run([w, n])
    lib = load_capi().lib
    before = ck.LAUNCHES["lstm_seq"]
    h = lib.pti_create(d.encode())
    assert h, lib.pti_last_error().decode()
    try:
        inputs = (ctypes.c_void_p * 2)(w.ctypes.data, n.ctypes.data)
        shapes = (ctypes.c_longlong * 3)(16, 20, 16)
        ndims = (ctypes.c_int * 2)(2, 1)
        dtypes = (ctypes.c_int * 2)(1, 1)
        out = np.zeros(64, np.float32)
        oshape = (ctypes.c_longlong * 8)()
        ondim = ctypes.c_int(0)
        rc = lib.pti_forward(
            h, inputs, shapes, ndims, dtypes, 2, 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
            oshape, ctypes.byref(ondim))
        assert rc == 32, lib.pti_last_error().decode()
    finally:
        lib.pti_destroy(h)
    assert ck.LAUNCHES["lstm_seq"] > before
    assert out[:rc].reshape(16, 2).tobytes() == want.tobytes()
