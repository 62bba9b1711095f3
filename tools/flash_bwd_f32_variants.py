#!/usr/bin/env python3
"""Time variants of the f32 flash-backward bodies (#2 dq, #3 dk/dv) on one
card: other warp counts a block and rows a pipeline stage.

    python3 tools/flash_bwd_f32_variants.py                 # the standard set
    python3 tools/flash_bwd_f32_variants.py 4x64/4x32 8x32/8x32

A variant is DQ/DKV, each WARPSxROWS: dq's warps (16 q rows each) and keys
a K/V stage, then dk/dv's warps (16 keys each) and q rows a Q/dO stage;
the first of the standard set is what ``csrc/flash_bwd.cu`` ships. Each
variant builds ``flash_bwd.cu`` alone with those constants into a library
of its own (under ``paddle_tpu_torch/_build/variants/``, built in
parallel), is held against the plain backward at chip_smoke.py's
BWD_SHAPES in f32 (``bwd_close``), then timed at the LM shape (B=8,
T=S=1023, H=12, causal) as chip_smoke.py times the kernels: the variants
in the order given, then again in the reverse order. Prints ptxas'
register lines and one line per timing, then a JSON summary.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STANDARD = ("4x64/4x32", "4x32/4x32", "8x32/8x32", "8x64/8x16",
            "4x32/4x16")
# the shipped constants, as csrc/flash_bwd.cu spells them
CONSTANTS = ("kDqWarps = 4;", "kDqRows = 64;", "kDkvWarps = 4;",
             "kDkvRows = 32;")


def parse(variant: str):
    m = re.fullmatch(r"(\d+)x(\d+)/(\d+)x(\d+)", variant)
    if not m:
        raise SystemExit(f"{variant}: want DQWARPSxROWS/DKVWARPSxROWS")
    dqw, dqr, kvw, kvr = (int(x) for x in m.groups())
    for warps, rows in ((dqw, dqr), (kvw, kvr)):
        # whole 16-byte copies a thread (load_tile_async)
        if warps not in (2, 4, 8) or rows not in (16, 32, 64) \
                or rows * 16 % (32 * warps):
            raise SystemExit(f"{variant}: warps 2/4/8 and rows 16/32/64, "
                             "whole 16-byte copies a thread")
    if 2 * kvr > 32 * kvw:             # a thread for each lse and delta
        raise SystemExit(f"{variant}: dk/dv needs 2 x rows <= threads")
    return dqw, dqr, kvw, kvr


def source(csrc: str, dqw, dqr, kvw, kvr) -> str:
    src = open(os.path.join(csrc, "flash_bwd.cu")).read()
    for old, value in zip(CONSTANTS, (dqw, dqr, kvw, kvr)):
        if old not in src:
            raise SystemExit(f"flash_bwd.cu no longer says {old!r}")
        src = src.replace(old, old.split("=")[0] + f"= {value};")
    return src


def build(variants, out_root: str):
    from paddle_tpu_torch.ops import _build
    csrc = str(_build.CSRC)
    shutil.rmtree(out_root, ignore_errors=True)
    procs = {}
    for v in variants:
        d = os.path.join(out_root, v.replace("/", "_"))
        os.makedirs(d)
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        with open(os.path.join(d, "flash_bwd.cu"), "w") as fh:
            fh.write(source(csrc, *parse(v)))
        cmd = [_build.find_nvcc(), *_build.CFLAGS, "-shared", "-I", d, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, "flash_bwd.cu")]
        procs[v] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{v}: nvcc failed\n{log[-4000:]}")
        for ln in log.splitlines():
            if "tf32_kernel" in ln or ("Used" in ln and "registers" in ln):
                print(f"  {v} ptxas: {ln.strip()[:140]}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for fn in ("paddle_flash_attention_bwd_dq",
                   "paddle_flash_attention_bwd_dkv"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[v] = _build.Build(lib, _build.BUILD_ROOT, log, 0.0, True)
    return libs


def main(argv=None) -> int:
    variants = list(argv if argv is not None else sys.argv[1:]) \
        or list(STANDARD)
    for v in variants:
        parse(v)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck
    print(cs.card_line(), flush=True)
    libs = build(variants, str(_build.BUILD_ROOT / "variants"))

    gen = torch.Generator().manual_seed(3)
    rs = np.random.RandomState(1)
    checks = []
    for tag, B, T, S, H, causal, kind, fused in cs.BWD_SHAPES:
        lens = cs._bwd_lens(kind, B, S, rs)
        args, kv = cs._bwd_inputs(B, T, S, H, causal, lens, fused,
                                  torch.float32, gen, "cuda")
        want = ck.flash_attention_bwd(*args, causal=causal, kv_lens=kv,
                                      route="plain")
        checks.append((tag, args, kv, causal, want))
    B, T, H, D = 8, 1023, 12, cs.HEAD_DIM
    sets = cs.input_sets(lambda i: cs._bwd_inputs(
        B, T, T, H, True, None, False, torch.float32, gen, "cuda")[0],
        5 * B * T * H * D * 4)
    times = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        _build._loaded = libs[v]       # the wrappers launch this variant
        for tag, args, kv, causal, want in checks:
            got = ck.flash_attention_bwd(*args, causal=causal, kv_lens=kv)
            for g, w in zip(got, want):
                cs.bwd_close(g, w, f"{v} {tag}", "float32")
        runs = [ck.FlashBwdLaunch(*s, True, D ** -0.5, None, None)
                for s in sets]
        for r in runs:
            r.dq()
        dq = cs.time_ms([r.dq for r in runs])
        dkv = cs.time_ms([r.dkv for r in runs])
        del runs
        times[v].append({"dq_ms": dq, "dkv_ms": dkv, "pair_ms": dq + dkv})
        print(f"{v}: dq {dq:.4f} ms, dk/dv {dkv:.4f} ms, pair "
              f"{dq + dkv:.4f} ms", flush=True)
    print(json.dumps({"shape": f"B={B} T=S={T} H={H} D={D} causal f32",
                      "card": cs.card_line(), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
