#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases:

1. build  — compile the CUDA kernels (``paddle_tpu_torch/csrc``) with nvcc
   for sm_90a and print ptxas' register / shared-memory lines;
2. kernels — hold each kernel against its plain PyTorch version at the
   serving shapes (f32 and bf16) and time kernel, plain version, the
   PyTorch library call where one exists, and the roofline bound;
3. serving — a GPT-2-small TransformerLM (random weights from a seed)
   behind ``ServingEngine``: 8 requests through start/submit/poll, every
   greedy continuation equal to the solo full re-forward with plain
   attention, launch counts equal to 12 x dispatches; then the same
   traffic with bf16 weights for tokens/s, TTFT and peak memory;
4. lstm kernels — the three LSTM sequence kernels (inference forward,
   training forward, backward) against their plain versions in f32 and
   bf16 at the flagship text-classifier shape (B=64, T=100, H=256) and at
   an edge shape (B=5, lengths 0/1/T, nonzero h0/c0), with times, plain
   times and bounds at the flagship shape;
5. lstm training — the flagship LSTM text classifier (vocab 30000, embed
   128, hidden 256, batch 64, lengths 30..100, last-step pooling; random
   weights from a seed) trained by ``Trainer.train`` for 24 Adam steps
   over 8 batches in bf16 over f32 master weights, then
   ``Trainer.test`` over 2 held batches: one launch of the training
   forward and of the backward kernel per step, the inference kernel in
   the test pass, a falling loss, one f32 step equal to the plain
   versions' step, and ms per step.

Prints ``{"kernels": [...]}``, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, with no
card, or without the ``paddle_tpu_torch`` package beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# GPT-2 small, as `paddle_tpu serve` builds it by default
GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024)
ENGINE = dict(slots=8, segment=32, page_block=64, cache_bucket=256)
N_REQUESTS, NEW_TOKENS = 8, 48

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# tolerances, with the reason: the kernels sum in another order than the
# plain versions (tiles, online softmax), nothing else differs
F32_ATOL, F32_RTOL = 1e-5, 1e-4
# bf16 flash output is rounded to bf16 once (|o| <= ~1: half an ulp is
# ~4e-3), compared with the plain version run in f32 on the same inputs
BF16_FLASH_ATOL = 2e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(calls, rounds: int = 4, reps: int = 5) -> float:
    """Mean device time of one call, without the host's launch cost.

    ``calls`` are closures of one function over distinct input sets, whose
    total is larger than the 50 MB L2 cache, so that each call finds its
    inputs cold as a layer of the model does. ``rounds`` passes over them
    are captured in one CUDA graph; CUDA events time ``reps`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the graph
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for c in calls:
                c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds * len(calls))


def input_sets(make, nbytes_one: int, floor: int = 4):
    """Enough input sets from ``make(i)`` to exceed the L2 cache twice."""
    n = max(floor, -(-2 * 50 * 2 ** 20 // nbytes_one))
    return [make(i) for i in range(n)]


def bound(flops: float, nbytes: float, dtype_name: str):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _qkv_views(B, T, H, D, dtype, gen, device):
    """q, k, v as the model makes them: [B, T, H, D] views of one fused
    [B, T, 3*H*D] projection (strided, no copy)."""
    import torch
    qkv = torch.randn((B, T, 3 * H * D), generator=gen).to(device, dtype)
    return [t.unflatten(-1, (H, D)) for t in qkv.chunk(3, dim=-1)]


def flash_checks(say, device="cuda"):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    B, T, H, D = 8, 256, 12, 64
    gen = torch.Generator().manual_seed(1)
    q, k, v = _qkv_views(B, T, H, D, torch.float32, gen, device)
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:69",
             "replaces_kernel": "_fa_fwd_kernel",
             "shape": f"B={B} T=S={T} H={H} D={D} causal"}
    pairs = T * (T + 1) // 2                    # causal (i, j) pairs j <= i
    flops = 4.0 * B * H * D * pairs
    for dt, tag in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        o, lse = ck.flash_attention_fwd(qd, kd, vd, causal=True)
        po, plse = ck.flash_attention_fwd(qd.float(), kd.float(), vd.float(),
                                          causal=True, route="plain")
        torch.cuda.synchronize()
        err = (o.float() - po).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        if dt == torch.float32:
            check(torch.allclose(o, po, atol=F32_ATOL, rtol=F32_RTOL),
                  f"flash f32 output differs from plain: max {err}")
        else:
            check(err <= BF16_FLASH_ATOL,
                  f"flash bf16 output differs from plain f32: max {err}")
        check(torch.allclose(lse, plse, atol=F32_ATOL, rtol=F32_RTOL),
              f"flash {tag} lse differs from plain: max {lse_err}")
        sets = input_sets(lambda i: _qkv_views(B, T, H, D, dt, gen, device),
                          3 * B * T * H * D * qd.element_size())
        ms = time_ms([lambda s=s: ck.flash_attention_fwd(*s, causal=True)
                      for s in sets])
        plain_ms = time_ms([lambda s=s: ck.flash_attention_fwd(
            *s, causal=True, route="plain") for s in sets], rounds=1)
        lib_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in s), is_causal=True) for s in sets])
        del sets
        nbytes = 4 * B * T * H * D * qd.element_size() + B * T * H * 4
        b_ms, b_by = bound(flops, nbytes, tag)
        res = {"max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        say(f"flash_attention_fwd {tag}: {json.dumps(res)}")
        if dt == torch.float32:
            entry.update(res)
            entry["dtype"] = tag
        else:
            entry["bf16"] = res
    # kv_lens masks, a sample with no keys included (non-causal)
    lens = torch.tensor([256, 0, 17, 100, 255, 1, 64, 200], device=device)
    o = ck.flash_attention(q, k, v, kv_lens=lens)
    po = ck.flash_attention(q, k, v, kv_lens=lens, route="plain")
    torch.cuda.synchronize()
    err = (o - po).abs().max().item()
    check(torch.allclose(o, po, atol=F32_ATOL, rtol=F32_RTOL),
          f"flash kv_lens output differs from plain: max {err}")
    check(o[1].abs().max().item() == 0.0, "kv_lens == 0 sample not zeroed")
    entry["kv_lens_max_abs_err"] = err
    say(f"flash_attention kv_lens (with a 0): max_abs_err {err}")
    return entry


def _paged_inputs(B, H, D, bs, NB, dtype, gen, device, full: bool):
    """Pools over a null page 0, tables and pos; q as decode_step_paged
    hands it over: ``q[:, 0]`` of the [B, 1, H, D] view of one fused
    [B, 1, 3*H*D] projection (strides 3*H*D per sample, D per head)."""
    import torch
    P = B * NB + 1                                   # + the null page 0
    k_pool = torch.randn((P, bs, H, D), generator=gen).to(device, dtype)
    v_pool = torch.randn((P, bs, H, D), generator=gen).to(device, dtype)
    qkv = torch.randn((B, 1, 3 * H * D), generator=gen).to(device, dtype)
    q = qkv.chunk(3, dim=-1)[0].unflatten(-1, (H, D))[:, 0]
    L = NB * bs
    if full:
        pos = torch.full((B,), L - 1, dtype=torch.int32)
    else:                                            # spread over [0, L)
        pos = torch.linspace(0, L - 1, B).round().to(torch.int32)
    perm = torch.randperm(P - 1, generator=gen) + 1
    tables = torch.zeros((B, NB), dtype=torch.int32)
    for b in range(B):
        live = int(pos[b]) // bs + 1
        tables[b, :live] = perm[b * NB:b * NB + live]
    return (q, k_pool, v_pool, tables.to(device), pos.to(device))


def paged_checks(say, device="cuda"):
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    B, H, D, bs = 8, 12, 64, 64
    gen = torch.Generator().manual_seed(2)
    entry = {"name": "paged_decode_attention", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/paged_decode.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:711",
             "replaces_kernel": "_paged_attn_kernel",
             "library_ms": None}
    # NB 4 and 8: the 256- and 512-row reads of the serving phase; 16: the
    # 1024-row read a max_len request reaches
    for NB in (4, 8, 16):
        for dt, tag in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
            args = _paged_inputs(B, H, D, bs, NB, dt, gen, device, full=False)
            check(args[0].stride()[:2] == (3 * H * D, D),
                  "paged q is not the strided view the model passes")
            o = ck.paged_decode_attention(*args)
            po = ck.paged_decode_attention(*args, route="plain")
            torch.cuda.synchronize()
            err = (o - po).abs().max().item()
            check(torch.allclose(o, po, atol=F32_ATOL, rtol=F32_RTOL),
                  f"paged NB={NB} {tag} differs from plain: max {err}")
            # timed with every row live (pos = NB*bs - 1): a full read
            rows = B * NB * bs
            esize = args[1].element_size()
            sets = input_sets(lambda i: _paged_inputs(
                B, H, D, bs, NB, dt, gen, device, full=True),
                2 * (B * NB + 1) * bs * H * D * esize)
            ms = time_ms([lambda s=s: ck.paged_decode_attention(*s)
                          for s in sets])
            plain_ms = time_ms([lambda s=s: ck.paged_decode_attention(
                *s, route="plain") for s in sets], rounds=1)
            del sets
            nbytes = (2 * rows * H * D + B * H * D) * esize \
                + B * H * D * 4 + B * NB * 4 + B * 4
            b_ms, b_by = bound(4.0 * rows * H * D, nbytes, tag)
            res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            say(f"paged_decode_attention NB={NB} {tag}: {json.dumps(res)}")
            if NB == 4 and dt == torch.float32:
                entry.update(res)
                entry["dtype"] = tag
                entry["shape"] = (f"B={B} bs={bs} NB={NB} H={H} D={D}, "
                                  "timed with every row live")
            else:
                entry[f"NB{NB}_{tag}"] = res
    return entry


# ---------------------------------------------------------------------------
# phase 3: serving GPT-2 small
# ---------------------------------------------------------------------------

def workload(seed: int, vocab: int):
    """8 prompts of 32-223 tokens (the serving_daemon mix, kept under 224 so
    that the first segment reads 256 rows and later ones 512), the first
    200 tokens long so that the 256-row prompt bucket is reached."""
    import numpy as np
    rs = np.random.RandomState(seed)
    lens = rs.randint(32, 224, N_REQUESTS)
    lens[0] = 200
    return [rs.randint(0, vocab, int(n)).astype(np.int32) for n in lens]


def serve(model, prompts, device):
    """Submit every prompt at once through start()/submit()/poll() (one
    burst, no arrival schedule); returns (tokens per request, (ttft, tpot)
    seconds per request, wall seconds, engine)."""
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, device=device, **ENGINE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.start()
    try:
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        while not all(eng.poll(r)[1] for r in rids):
            time.sleep(0.002)
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    check(eng.failed is None, f"engine failed: {eng.failed}")
    toks, lat = [], []
    for r in rids:
        out, done, reason = eng.poll(r)
        check(done and reason == "length",
              f"request {r} ended with {reason!r}")
        toks.append(out)
        t = eng.timings(r)
        lat.append((t["t_first"] - t["t_submit"],
                    (t["t_done"] - t["t_first"]) / (len(out) - 1)))
    return toks, lat, wall, eng


def latency_figures(lat, wall):
    import numpy as np
    ttft, tpot = np.asarray(lat).T
    return {"requests": len(lat), "tokens_per_s": len(lat) * NEW_TOKENS / wall,
            "ttft_p50_ms": float(np.median(ttft)) * 1e3,
            "ttft_max_ms": float(ttft.max()) * 1e3,
            "tpot_p50_ms": float(np.median(tpot)) * 1e3,
            "tpot_max_ms": float(tpot.max()) * 1e3}


def serving_phase(say, seed: int, device="cuda", config=GPT2_SMALL):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.ops import cuda_kernels as ck
    model = TransformerLM(**config).init(seed=seed, device=device)
    prompts = workload(seed, config["vocab"])
    n_layers = config["n_layers"]

    ck.reset_launch_counts()
    toks, lat, wall, eng = serve(model, prompts, device)
    launches = dict(ck.LAUNCHES)
    pool = eng.pool
    say(f"serving f32: admissions {pool.admissions_total} "
        f"{pool.admissions_by_bucket}, segments {pool.segments_total} "
        f"{pool.segments_by_pages} (read pages -> count), launches "
        f"{launches}")
    check(256 in pool.admissions_by_bucket,
          "the 256-row prompt bucket was not reached")
    check(len(pool.segments_by_pages) >= 2,
          "fewer than two cache-read buckets were reached")
    steps = pool.segments_total * pool.segment
    check(launches["flash_attention_fwd"] > 0
          and launches["flash_attention_fwd"]
          == n_layers * pool.admissions_total,
          f"flash launches {launches['flash_attention_fwd']} != "
          f"{n_layers} x {pool.admissions_total} admissions")
    check(launches["paged_decode_attention"] > 0
          and launches["paged_decode_attention"] == n_layers * steps,
          f"paged launches {launches['paged_decode_attention']} != "
          f"{n_layers} x {steps} steps")
    for i, p in enumerate(prompts):
        check(len(toks[i]) == NEW_TOKENS,
              f"request {i}: {len(toks[i])} tokens, want {NEW_TOKENS}")
        ids = torch.as_tensor(p[None].astype(np.int64), device=device)
        solo = model.generate_greedy(ids, NEW_TOKENS, route="plain")
        want = solo[0, len(p):].cpu().numpy().tolist()
        if toks[i] != want:
            j = next(n for n in range(NEW_TOKENS) if toks[i][n] != want[n])
            ctx = solo[:, :len(p) + j]
            top2 = torch.topk(model(ctx, route="plain")[0, -1].float(), 2)
            raise SmokeFailure(
                f"request {i} (prompt {len(p)}): engine token {j} = "
                f"{toks[i][j]}, solo = {want[j]}; solo top-2 logit gap "
                f"{(top2.values[0] - top2.values[1]).item():.3e}")
    say(f"serving f32: {N_REQUESTS} requests x {NEW_TOKENS} tokens equal "
        "to the solo plain-attention greedy decode")
    f32 = latency_figures(lat, wall)

    model.to(torch.bfloat16)
    serve(model, prompts, device)                     # warm the bf16 path
    torch.cuda.reset_peak_memory_stats()
    _, lat16, wall16, _ = serve(model, prompts, device)
    bf16 = latency_figures(lat16, wall16)
    bf16["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"serving smoke figures (not a benchmark): f32 first traffic of the "
        f"process {json.dumps(f32)}; bf16 warm {json.dumps(bf16)}")
    profile_breakdown(say, "bf16 serving",
                      lambda: serve(model, prompts, device), wall16)
    return launches


def profile_breakdown(say, what: str, run, wall: float) -> None:
    """Device busy share of ``run()`` and its top kernels, from one run
    under torch.profiler. The share divides device kernel time by the wall
    time ``wall`` of the same work run unprofiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        rows.append((us, e.count, e.key))
    dev_s = sum(r[0] for r in rows) / 1e6
    if dev_s == 0.0:
        say(f"profile {what}: the profiler saw no device time (not measured)")
        return
    rows.sort(reverse=True)
    say(f"profile {what}: device kernel time {dev_s * 1e3:.3f} ms, "
        f"wall {wall * 1e3:.3f} ms unprofiled / {wall_prof * 1e3:.3f} ms "
        f"profiled, device busy share {dev_s / wall:.4f}, "
        f"{sum(r[1] for r in rows)} kernel launches")
    for us, n, name in rows[:8]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e6 / dev_s:5.1f}% "
              f"x{n:<6d} {name[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the LSTM kernels against their plain versions
# ---------------------------------------------------------------------------

# the flagship text classifier (benchmarks/lstm_textcls.py:28-35, the
# reference's benchmark/paddle/rnn/rnn.py): vocab 30000, embed 128, one
# LSTM layer of 256, 2 classes, batch 64, padded length 100, lengths
# uniform in 30..100, Adam 2e-3, bf16 compute over f32 master weights
TEXTCLS = dict(vocab=30000, embed=128, hidden=256, classes=2)
TEXTCLS_BATCH, TEXTCLS_LEN, TEXTCLS_MIN_LEN = 64, 100, 30
TEXTCLS_NBUF, TEXTCLS_PASSES, TEXTCLS_LR = 8, 3, 2e-3
# the edge shape: a batch under one tile, lengths 0, 1 and T, h0/c0 != 0
LSTM_EDGE_LENS = (0, 1, 7, 3, 5)

LSTM_KERNELS = (
    ("lstm_seq", "paddle_tpu_torch/csrc/lstm_seq.cu",
     "paddle_tpu/ops/pallas_kernels.py:837", "_lstm_seq_kernel"),
    ("lstm_seq_train", "paddle_tpu_torch/csrc/lstm_seq.cu",
     "paddle_tpu/ops/pallas_kernels.py:872", "_lstm_seq_train_kernel"),
    ("lstm_seq_bwd", "paddle_tpu_torch/csrc/lstm_seq_bwd.cu",
     "paddle_tpu/ops/pallas_kernels.py:1019", "_lstm_seq_bwd_kernel"),
)


def lstm_close(got, want, what: str, dtype_name: str, sum_terms: int = 0):
    """Hold a kernel output against the plain version's, with the stated
    tolerance; returns the max abs error.

    Both compute in f32 and differ only in summation order (and carry h, c
    and dh in f32 across all steps: neither rounds state to bf16 between
    steps, as the JAX wrapper's chunked bf16 path does). f32 outputs: atol
    1e-5, rtol 1e-4. bf16 outputs are the same f32 values rounded once, so
    they differ by at most one bf16 ulp: rtol 2**-7, atol 1e-6. du is an
    f32 sum of ``sum_terms`` = B*T products per entry in both dtypes:
    rtol 1e-4, atol 1e-5 * its largest magnitude."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if sum_terms:
        atol, rtol = 1e-5 * w.abs().max().item(), 1e-4
    elif dtype_name == "float32":
        atol, rtol = 1e-5, 1e-4
    else:
        atol, rtol = 1e-6, 2.0 ** -7
    check(torch.allclose(g, w, atol=atol, rtol=rtol),
          f"{what} {dtype_name} differs from plain: max abs {err} "
          f"(atol {atol}, rtol {rtol})")
    return err


def _lstm_inputs(B, T, H, lens, dtype, gen, device, state: bool):
    """Kernel inputs as the model makes them: xw = x@W of unit-scale
    embeddings through U(-0.08, 0.08) weights, U and b likewise, the
    cotangents of a mean loss; h0/c0 nonzero when ``state``."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    xw = rnd(B, T, 4 * H, scale=0.5)
    u = ((torch.rand((H, 4 * H), generator=gen) - 0.5) * 0.16).to(device,
                                                                  dtype)
    b = rnd(4 * H, scale=0.1)
    h0 = rnd(B, H, scale=0.5) if state else zeros(B, H)
    c0 = rnd(B, H, scale=0.5) if state else zeros(B, H)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
    cot = (rnd(B, T, H, scale=0.01), rnd(B, H, scale=0.01),
           rnd(B, H, scale=0.01))
    return (xw, lengths, u, b, h0, c0), cot


def _lstm_case(B, T, H, lens, dtype, gen, device, state):
    """Inputs of all three kernels: the forward's, then the backward's with
    the residuals (out, c_seq) of the plain training forward."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    fwd, (g_out, g_ht, g_ct) = _lstm_inputs(B, T, H, lens, dtype, gen,
                                            device, state)
    out, _, _, c_seq = rk.lstm_sequence_fused(
        *fwd, forget_bias=1.0, save_cell=True, route="plain")
    return fwd, fwd + (out, c_seq, g_out, g_ht, g_ct)


def lstm_kernel_checks(say, seed: int, device="cuda", timed: bool = True,
                       flagship=(TEXTCLS_BATCH, TEXTCLS_LEN,
                                 TEXTCLS["hidden"])):
    """#8, #9 and #10 against their plain versions in f32 and bf16 at the
    flagship shape (lengths from the seed in 30..100) and at the edge
    shape; at the flagship shape also their times, the plain versions'
    and the bound. Returns the kernels' JSON entries (the bf16 flagship
    numbers first: that is what the training path runs)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import rnn_kernels as rk
    B, T, H = flagship
    rs = np.random.RandomState(seed)
    flag_lens = rs.randint(min(TEXTCLS_MIN_LEN, T), T + 1, B)
    edge_T = max(LSTM_EDGE_LENS)
    shapes = (("flagship", B, T, flag_lens, False),
              ("edge", len(LSTM_EDGE_LENS), edge_T, LSTM_EDGE_LENS, True))
    gen = torch.Generator().manual_seed(seed + 3)
    entries = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "replaces_kernel": body,
                      "library_ms": None,
                      "library_note": "no single PyTorch call: cuDNN's LSTM "
                                      "has no per-sample length mask with "
                                      "a frozen state"}
               for name, src, rep, body in LSTM_KERNELS}
    fwd_kw = dict(forget_bias=1.0)

    def run(name, args, route=None):
        if name == "lstm_seq_bwd":
            return rk.lstm_sequence_fused_bwd(*args, route=route, **fwd_kw)
        return rk.lstm_sequence_fused(*args, save_cell=name != "lstm_seq",
                                      route=route, **fwd_kw)

    for tag, Bs, Ts, lens, state in shapes:
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            fwd, bwd = _lstm_case(Bs, Ts, H, lens, dt, gen, device, state)
            for name, _, _, _ in LSTM_KERNELS:
                args = bwd if name == "lstm_seq_bwd" else fwd
                got, want = run(name, args), run(name, args, route="plain")
                if timed:
                    torch.cuda.synchronize()
                errs = [lstm_close(g, w, f"{name} {tag} output {i}", dname,
                                   sum_terms=Bs * Ts if (
                                       name == "lstm_seq_bwd" and i == 3)
                                   else 0)
                        for i, (g, w) in enumerate(zip(got, want))]
                if tag == "edge":
                    for b, n in enumerate(lens):
                        if n == 0 and name != "lstm_seq_bwd":
                            check(not got[0][b].any().item(),
                                  f"{name}: a 0-length sample has output")
                            check(torch.equal(got[1][b], fwd[4][b]),
                                  f"{name}: a 0-length sample's hT != h0")
                res = {"max_abs_err": max(errs)}
                if timed and tag == "flagship":
                    res.update(_lstm_times(name, run, Bs, Ts, H, lens, dt,
                                           dname, gen, device))
                say(f"{name} {tag} B={Bs} T={Ts} H={H} {dname}: "
                    f"{json.dumps(res)}")
                e = entries[name]
                if tag == "flagship" and dt == torch.bfloat16:
                    e.update(res)
                    e["dtype"] = dname
                    e["shape"] = (f"B={Bs} T={Ts} H={H}, lengths "
                                  f"{TEXTCLS_MIN_LEN}..{T} from the seed")
                else:
                    e[f"{tag}_{dname}"] = res
    return [entries[name] for name, _, _, _ in LSTM_KERNELS]


def _lstm_times(name, run, B, T, H, lens, dt, dname, gen, device):
    """Kernel and plain times (CUDA graph over input sets larger than L2)
    and the bound: the recurrent products of the live steps (2*H*4H per
    live (sample, step), three of them in the backward) against each
    input read and each output written once."""
    import torch
    esize = torch.empty((), dtype=dt).element_size()
    G = 4 * H
    seq, vec = B * T * H * esize, B * H * esize
    fwd_bytes = B * T * G * esize + H * G * esize + G * esize + 2 * vec \
        + B * 4 + seq + 2 * vec
    if name == "lstm_seq_train":
        fwd_bytes += seq
    if name == "lstm_seq_bwd":
        nbytes = (B * T * G * esize + H * G * esize + G * esize + 2 * vec
                  + B * 4 + 3 * seq + 2 * vec          # + out, c_seq, g_*
                  + B * T * G * esize + 2 * vec + H * G * 4)
        flops = 3 * 2.0 * int(sum(lens)) * H * G
    else:
        nbytes = fwd_bytes
        flops = 2.0 * int(sum(lens)) * H * G
    sets = input_sets(
        lambda i: _lstm_case(B, T, H, lens, dt, gen, device, False)[
            1 if name == "lstm_seq_bwd" else 0], nbytes)
    ms = time_ms([lambda s=s: run(name, s) for s in sets])
    plain_ms = time_ms([lambda s=s: run(name, s, route="plain")
                        for s in sets], rounds=1, reps=2)
    del sets
    b_ms, b_by = bound(flops, nbytes, dname)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


# ---------------------------------------------------------------------------
# phase 5: training the flagship LSTM text classifier
# ---------------------------------------------------------------------------

def textcls_batches(seed: int, n: int, device, batch=TEXTCLS_BATCH,
                    seq_len=TEXTCLS_LEN, vocab=TEXTCLS["vocab"]):
    """``n`` batches (data [B, T] int32, lengths [B] int32 in 30..T,
    labels [B]) from ``seed``. A label is the parity of the sample's last
    valid token, so that the loss of a batch seen before can fall (the
    benchmark's labels are random)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        data = rs.randint(0, vocab, (batch, seq_len)).astype(np.int32)
        lengths = rs.randint(min(TEXTCLS_MIN_LEN, seq_len), seq_len + 1,
                             batch).astype(np.int32)
        labels = data[np.arange(batch), lengths - 1] % 2
        out.append(tuple(torch.as_tensor(a, device=device)
                         for a in (data, lengths, labels)))
    return out


def bf16_loss(model):
    """The benchmark's loss: params cast to bf16 (f32 master weights stay
    the optimizer's), the forward in bf16, the loss as f32."""
    import torch
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.core.pytree import tree_map

    def loss_fn(params, data, lengths, labels):
        p16 = tree_map(lambda a: a.to(torch.bfloat16)
                       if a.dtype == torch.float32 else a, params)
        return model.call(p16, SeqBatch(data, lengths),
                          labels).to(torch.float32)
    return loss_fn


def f32_loss(model, route=None):
    from paddle_tpu_torch.core import SeqBatch

    def loss_fn(params, data, lengths, labels):
        return model.call(params, SeqBatch(data, lengths), labels,
                          route=route)
    return loss_fn


def f32_step_check(say, model, batch, device):
    """One f32 Adam step through the kernels against the same step with
    the plain versions, on the card. Tolerances: the gradients (read as
    Adam's first moment, 0.1 g) to rtol 1e-4 plus 1e-5 of each tensor's
    largest magnitude (summation order); the updated parameters to atol
    1e-5 (0.5% of the lr: the first Adam step lr*g/(|g|+eps) turns ~1e-11
    differences of gradients near eps into ~1e-6)."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_get, tree_items
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    params = model.tree()
    res = {}
    for route in (None, "plain"):
        tr = Trainer(f32_loss(model, route), Adam(TEXTCLS_LR), device=device)
        res[route] = tr.step(params, tr.opt.init(params), *batch)
    (pk, sk, lk), (pp, sp, lp) = res[None], res["plain"]
    check(abs(lk.item() - lp.item()) <= 1e-5, f"f32 loss {lk.item()} != "
          f"plain {lp.item()}")
    worst = {}
    for path, m_p in tree_items(sp["slots"]):
        m_k = tree_get(sk["slots"], path)
        atol = 1e-5 * m_p.abs().max().item()
        err = (m_k - m_p).abs().max().item()
        check(torch.allclose(m_k, m_p, rtol=1e-4, atol=atol),
              f"f32 step: {'/'.join(path)} differs from plain: {err}")
        worst["/".join(path)] = err
    for (path, a), (_, b) in zip(tree_items(pk), tree_items(pp)):
        err = (a - b).abs().max().item()
        check(err <= 1e-5, f"f32 step: param {'/'.join(path)} differs "
              f"from plain by {err}")
        worst["param " + "/".join(path)] = err
    say(f"f32 training step, kernels vs plain on the card: loss "
        f"{lk.item():.6f} vs {lp.item():.6f}; max abs differences "
        f"{json.dumps(worst)}")


def training_phase(say, seed: int, device="cuda", config=TEXTCLS,
                   batch=TEXTCLS_BATCH, seq_len=TEXTCLS_LEN,
                   passes=TEXTCLS_PASSES, warmup=4):
    """Trainer.train over 8 batches for ``passes`` passes (bf16 compute,
    f32 master, Adam), then Trainer.test over two held batches; launch
    counts, a falling loss and ms per step. Returns the counts."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer, event
    model = LSTMTextCls(config["vocab"], config["embed"], config["hidden"],
                        config["classes"], pool="last").init(seed, device)
    data = textcls_batches(seed, TEXTCLS_NBUF + 2, device, batch, seq_len,
                           config["vocab"])
    batches, held = data[:TEXTCLS_NBUF], data[TEXTCLS_NBUF:]
    f32_step_check(say, model, batches[0], device)

    trainer = Trainer(bf16_loss(model), Adam(TEXTCLS_LR), device=device)
    params = model.tree()
    before = trainer.test(lambda: batches[:1], params)["cost"]
    stamps, costs = [], []

    def on_event(e):
        if isinstance(e, event.EndIteration):
            stamps.append(time.perf_counter())
            costs.append(e.cost)

    if device != "cpu":
        torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    params, state = trainer.train(lambda: batches, params,
                                  num_passes=passes, event_handler=on_event)
    test = trainer.test(lambda: held, params)
    launches = dict(ck.LAUNCHES)
    after = trainer.test(lambda: batches[:1], params)["cost"]
    steps = passes * len(batches)
    say(f"textcls training: {steps} steps, costs {json.dumps(costs)}; "
        f"held-out test cost {test['cost']}; batch 0 cost before "
        f"{before} after {after}; launches {launches}")
    check(len(costs) == steps and int(state["step"]) == steps,
          f"{len(costs)} steps ran, want {steps}")
    check(all(np.isfinite(costs)) and np.isfinite(test["cost"]),
          "a non-finite cost")
    check(after < before, f"batch 0 cost did not fall: {before} -> {after}")
    check(launches["lstm_seq_train"] == steps
          and launches["lstm_seq_bwd"] == steps,
          f"LSTM training launches {launches} != one each per step "
          f"({steps})")
    check(launches["lstm_seq"] == len(held),
          f"LSTM inference launches {launches['lstm_seq']} != one per "
          f"held batch ({len(held)})")
    step_ms = np.diff([t0] + stamps)[warmup:] * 1e3
    fig = {"steps_timed": len(step_ms),
           "ms_per_step_median": float(np.median(step_ms)),
           "ms_per_step_min": float(step_ms.min()),
           "ms_per_step_max": float(step_ms.max()),
           "ms_per_step_p10": float(np.percentile(step_ms, 10)),
           "ms_per_step_p90": float(np.percentile(step_ms, 90)),
           "launches_per_step": {k: launches[k] / steps for k in
                                 ("lstm_seq_train", "lstm_seq_bwd")}}
    say(f"textcls training smoke figures (not a benchmark): "
        f"{json.dumps(fig)}")
    if device != "cpu":
        run = lambda: trainer.train(lambda: batches[:4], params)
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profile_breakdown(say, "bf16 textcls training (4 steps)", run,
                          time.perf_counter() - t1)
    return launches, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: the paddle_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    def say(msg: str) -> None:
        print(f"{msg} | {card}", flush=True)

    from paddle_tpu_torch.ops import _build
    build = _build.load()
    say(f"build: {build.seconds:.1f} s ({'built' if build.built else 'cached'}"
        f" with nvcc for sm_90a) -> {build.path.name}")
    for ln in build.resource_lines():
        print(f"  ptxas: {ln}")

    flash = flash_checks(say)
    paged = paged_checks(say)
    launches = serving_phase(say, args.seed)
    for entry in (flash, paged):
        entry["launches"] = launches[entry["name"]]
    lstm = lstm_kernel_checks(say, args.seed)
    launches, steps = training_phase(say, args.seed)
    for entry in lstm:
        entry["launches"] = launches[entry["name"]]
        entry["launches_note"] = (f"{steps} training steps, then a test "
                                  "pass over 2 batches")
    print(json.dumps({"kernels": [flash, paged] + lstm, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
