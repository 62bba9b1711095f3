#!/usr/bin/env python3
"""Time variants of the f32 flash-attention bodies on one card: other warp
counts a block and rows a pipeline stage.

    python3 tools/flash_f32_variants.py fwd               # the standard set
    python3 tools/flash_f32_variants.py fwd 4x64 8x32
    python3 tools/flash_f32_variants.py bwd               # the standard set
    python3 tools/flash_f32_variants.py bwd 4x64/4x32 8x32/8x32

``fwd`` takes the forward (#1, ``flash_fwd_tf32_kernel``): a variant is
WARPSxKEYS, warps a block (16 q rows each) and keys a K/V stage. ``bwd``
takes the backward (#2 dq, #3 dk/dv): a variant is DQ/DKV, each
WARPSxROWS, dq's warps (16 q rows each) and keys a K/V stage, then dk/dv's
warps (16 keys each) and q rows a Q/dO stage. The first of each standard
set is what ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu`` ships.

Each variant builds its source file alone with those constants into a
library of its own (under ``paddle_tpu_torch/_build/variants_<mode>/``,
built in parallel), is held against the plain version at chip_smoke.py's
BWD_SHAPES in f32 (the forward to F32_ATOL/F32_RTOL, the backward by
``bwd_close``), then timed as chip_smoke.py times the kernels: the
forward at the LM shape (B=8, T=S=1023, H=12, causal) and at T=256, the
backward at the LM shape; the variants in the order given, then again in
the reverse order. Prints ptxas' register lines and one line per timing,
then a JSON summary.
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

# mode -> source file, its shipped constants (WARPS, ROWS pairs, as the
# file spells them), C entry points, the standard set
MODES = {
    "fwd": dict(source="flash_fwd.cu", body="flash_fwd_tf32_kernel",
                constants=("kFwdWarps = 4;", "kFwdKeys = 64;"),
                entries=("paddle_flash_attention_fwd",),
                standard=("4x64", "4x32", "8x64", "8x32")),
    "bwd": dict(source="flash_bwd.cu", body="tf32_kernel",
                constants=("kDqWarps = 4;", "kDqRows = 64;",
                           "kDkvWarps = 4;", "kDkvRows = 32;"),
                entries=("paddle_flash_attention_bwd_dq",
                         "paddle_flash_attention_bwd_dkv"),
                standard=("4x64/4x32", "4x32/4x32", "8x32/8x32",
                          "8x64/8x16", "4x32/4x16")),
}


def parse(mode: str, variant: str):
    """The constants of ``variant``: (warps, rows) a stage, in order."""
    parts = variant.split("/")
    want = len(MODES[mode]["constants"]) // 2
    pairs = [re.fullmatch(r"(\d+)x(\d+)", p) for p in parts]
    if len(parts) != want or not all(pairs):
        raise SystemExit(f"{variant}: want {'/'.join(['WARPSxROWS'] * want)}")
    values = []
    for m in pairs:
        warps, rows = (int(x) for x in m.groups())
        # whole 16-byte copies a thread (load_tile_async)
        if warps not in (2, 4, 8) or rows not in (16, 32, 64) \
                or rows * 16 % (32 * warps):
            raise SystemExit(f"{variant}: warps 2/4/8 and rows 16/32/64, "
                             "whole 16-byte copies a thread")
        values += [warps, rows]
    if mode == "bwd" and 2 * values[3] > 32 * values[2]:
        # a thread for each lse and delta of a stage
        raise SystemExit(f"{variant}: dk/dv needs 2 x rows <= threads")
    return values


def source(mode: str, csrc: str, values) -> str:
    spec = MODES[mode]
    src = open(os.path.join(csrc, spec["source"])).read()
    for old, value in zip(spec["constants"], values):
        if old not in src:
            raise SystemExit(f"{spec['source']} no longer says {old!r}")
        src = src.replace(old, old.split("=")[0] + f"= {value};")
    return src


def build(mode: str, variants, out_root: str):
    """One library a variant, the nvcc runs in parallel -> {variant: Build}."""
    from paddle_tpu_torch.ops import _build
    spec = MODES[mode]
    csrc = str(_build.CSRC)
    shutil.rmtree(out_root, ignore_errors=True)
    procs = {}
    for v in variants:
        d = os.path.join(out_root, v.replace("/", "_"))
        os.makedirs(d)
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        cu = os.path.join(d, spec["source"])
        with open(cu, "w") as fh:
            fh.write(source(mode, csrc, parse(mode, v)))
        cmd = [_build.find_nvcc(), *_build.CFLAGS, "-shared", "-I", d, "-o",
               os.path.join(d, "lib.so"), cu]
        procs[v] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{v}: nvcc failed\n{log[-4000:]}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and spec["body"] in ln:
                for nxt in [ln] + lines[i + 1:i + 3]:
                    print(f"  {v} ptxas: {nxt.strip()[:140]}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for fn in spec["entries"]:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[v] = _build.Build(lib, _build.BUILD_ROOT, log, 0.0, True)
    return libs


def _checks(cs, torch, gen):
    """chip_smoke.py's BWD_SHAPES in f32: (tag, args, kv_lens, causal)."""
    import numpy as np
    rs = np.random.RandomState(1)
    out = []
    for tag, B, T, S, H, causal, kind, fused in cs.BWD_SHAPES:
        lens = cs._bwd_lens(kind, B, S, rs)
        args, kv = cs._bwd_inputs(B, T, S, H, causal, lens, fused,
                                  torch.float32, gen, "cuda")
        out.append((tag, args, kv, causal))
    return out


def run_fwd(cs, ck, torch, gen, checks, variants, use):
    D = cs.HEAD_DIM
    sets = {T: cs.input_sets(lambda i: cs._qkv_views(
        8, T, 12, D, torch.float32, gen, "cuda"), 3 * 8 * T * 12 * D * 4)
        for T in (1023, 256)}
    times = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        use(v)
        for tag, args, kv, causal in checks:
            o, lse = ck.flash_attention_fwd(*args[:3], causal=causal,
                                            kv_lens=kv)
            cs.fwd_f32_close(o, args[3], f"{v} {tag}")
            cs.check(torch.allclose(lse, args[4], atol=cs.F32_ATOL,
                                    rtol=cs.F32_RTOL), f"{v} {tag} lse")
        row = {f"T={T}_ms": cs.time_ms([
            lambda s=s: ck.flash_attention_fwd(*s, causal=True)
            for s in sets[T]]) for T in sets}
        times[v].append(row)
        print(f"{v}: " + ", ".join(f"{k} {x:.4f}" for k, x in row.items()),
              flush=True)
    return "B=8 T=S=1023 and 256 H=12 D=64 causal f32", times


def run_bwd(cs, ck, torch, gen, checks, variants, use):
    checks = [(tag, args, kv, causal,
               ck.flash_attention_bwd(*args, causal=causal, kv_lens=kv,
                                      route="plain"))
              for tag, args, kv, causal in checks]
    B, T, H, D = 8, 1023, 12, cs.HEAD_DIM
    sets = cs.input_sets(lambda i: cs._bwd_inputs(
        B, T, T, H, True, None, False, torch.float32, gen, "cuda")[0],
        5 * B * T * H * D * 4)
    times = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        use(v)
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
    return f"B={B} T=S={T} H={H} D={D} causal f32", times


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    mode, variants = argv[0], argv[1:] or list(MODES[argv[0]]["standard"])
    for v in variants:
        parse(mode, v)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck
    print(cs.card_line(), flush=True)
    libs = build(mode, variants, str(_build.BUILD_ROOT / f"variants_{mode}"))

    def use(v):                # the wrappers launch this variant
        _build._loaded = libs[v]

    gen = torch.Generator().manual_seed(3)
    checks = _checks(cs, torch, gen)
    run = run_fwd if mode == "fwd" else run_bwd
    shape, times = run(cs, ck, torch, gen, checks, variants, use)
    print(json.dumps({"mode": mode, "shape": shape, "card": cs.card_line(),
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
