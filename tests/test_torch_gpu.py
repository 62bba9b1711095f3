"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serving path through them.

Every test here needs a CUDA card and skips without one. This file
imports torch and the port only (the machine with the card has no JAX),
so there it runs without the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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


@pytest.mark.gpu
def test_decode_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(5)
    q, k, v, _, _ = _decode_cache(cuda, torch.float32, gen)
    pos = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ck.decode_attention(q, k.to(torch.bfloat16), v, pos)
    with pytest.raises(TypeError, match="dtype"):
        ck.decode_attention(q.half(), k.half(), v.half(), pos)
    with pytest.raises(ValueError, match="head width"):
        ck.decode_attention(q[..., :32], k[..., :32], v[..., :32], pos)
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
    q = torch.randn(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head width"):
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
    # 64 x 64 blocks cannot all be resident for the grid barrier
    big = torch.randn(2048, 1, 1024, device=cuda)
    with pytest.raises(ValueError, match="split the batch"):
        rk.lstm_sequence_fused(big, torch.ones(2048, dtype=torch.int32),
                               torch.randn(256, 1024, device=cuda))


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
    forward and the backward) by 16-byte cp.async copies: a base that is
    not 16-byte aligned, or a stride that is not a multiple of 16 bytes,
    raises (no copy, no other route); f32 views that keep the rule are
    read in place."""
    good = torch.randn(2, 40, 3, 64, device=cuda, dtype=torch.bfloat16)
    wide = torch.randn(2, 40, 3, 68, device=cuda)
    flat = torch.randn(2 * 40 * 3 * 64 + 1, device=cuda)
    bad = [wide.to(torch.bfloat16)[..., :64],              # 136-byte heads
           flat.to(torch.bfloat16)[1:].view(2, 40, 3, 64)]  # base 2 bytes off
    o, lse = ck.flash_attention_fwd(good, good, good)
    for x in bad:
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_fwd(x, good, good)
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_fwd(good, good, x)
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_bwd(good, x, good, o, lse, o)
    good32 = good.float()
    o32, lse32 = ck.flash_attention_fwd(good32, good32, good32)
    bad32 = [torch.randn(2, 40, 3, 66, device=cuda)[..., :64],  # 264-byte heads
             flat[1:].view(2, 40, 3, 64)]                     # base 4 bytes off
    for x in bad32:
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_bwd(x, good32, good32, o32, lse32, o32)
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_bwd(good32, good32, x, o32, lse32, o32)
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_fwd(x, good32, good32)
        with pytest.raises(ValueError, match="TMA"):
            ck.flash_attention_fwd(good32, good32, x)
    x = wide[..., :64]                                   # 272-byte heads
    o32, lse32 = ck.flash_attention_fwd(x, x, x)
    po, plse = ck.flash_attention_fwd(x, x, x, route="plain")
    torch.testing.assert_close(o32, po, atol=1e-5, rtol=1e-4)


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
    q = torch.randn(1, 8, 2, 32, device=cuda)
    o, lse = ck.flash_attention_fwd(q, q, q, route="plain")
    with pytest.raises(ValueError, match="head width"):
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
    # 256 x 64 blocks cannot all be resident for the grid barriers
    big = torch.randn(2048, 1, 3072, device=cuda)
    lens = torch.ones(2048, dtype=torch.int32)
    u = torch.randn(1024, 3072, device=cuda)
    with pytest.raises(ValueError, match="split the batch"):
        rk.gru_sequence_fused(big, lens, u)
    h = torch.zeros(2048, 1024, device=cuda)
    with pytest.raises(ValueError, match="split the batch"):
        rk.gru_sequence_fused_bwd(big, lens, u, h, h[:, None], h[:, None], h)


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
