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
    # f32: summation order only; bf16: one rounding of the output
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), po, atol=atol, rtol=1e-4)
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
