"""The port's attention kernels (paddle_tpu_torch/ops/cuda_kernels.py)
against the JAX package's Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions (the tensors
lie on the CPU); those are held here against the Pallas kernels run in
interpret mode and against the JAX dense routes, on the same inputs made
with numpy. Tolerance: f32 atol 1e-5 — both sides compute in f32 and
differ only in summation order. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_gpu.py and by
chip_smoke.py.
"""

import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import rnn_kernels as rk

ATOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


def _qkv(rs, B, T, S, H, D):
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, S, H, D).astype(np.float32)
    v = rs.randn(B, S, H, D).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,T,S,lens", [
    (True, 48, 48, None),            # padded tail block in the JAX kernel
    (False, 48, 48, None),
    (False, 32, 48, None),           # T != S (cross-attention shape)
    (False, 32, 48, [48, 0, 17]),    # kv_lens with an empty sample
    (True, 32, 32, [32, 5, 0]),
])
def test_flash_plain_matches_pallas_interpret(causal, T, S, lens):
    rs = np.random.RandomState(0)
    B, H, D = 3, 2, 16
    q, k, v = _qkv(rs, B, T, S, H, D)
    kv_j = None if lens is None else jnp.asarray(lens, jnp.int32)
    kv_t = None if lens is None else torch.tensor(lens)
    want = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, kv_lens=kv_j, block_q=16,
                              block_k=16, interpret=True)
    got = ck.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             kv_lens=kv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if lens is not None:
        for b, n in enumerate(lens):
            if n == 0:
                assert not got[b].any()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_lse_matches_pallas_interpret(causal):
    rs = np.random.RandomState(1)
    q, k, v = _qkv(rs, 2, 40, 40, 2, 16)
    o_j, lse_j = pk.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    o_t, lse_t = ck.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=0)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (2, 40, 2)


def test_flash_plain_reads_strided_qkv_views():
    """The model hands attention q/k/v as views of one fused projection;
    the plain version (and the kernel, through its strides) takes them
    without a copy and gives the contiguous result."""
    rs = np.random.RandomState(2)
    qkv = torch.from_numpy(rs.randn(2, 24, 3 * 4 * 8).astype(np.float32))
    q, k, v = (t.unflatten(-1, (4, 8)) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous() and q.stride(-1) == 1
    got = ck.flash_attention(q, k, v, causal=True)
    want = ck.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _paged_inputs(seed):
    B, H, D, bs, NB, P = 3, 4, 16, 8, 4, 14
    rs = np.random.RandomState(seed)
    k_pool = rs.randn(P, bs, H, D).astype(np.float32)
    v_pool = rs.randn(P, bs, H, D).astype(np.float32)
    tables = np.stack([rs.choice(np.arange(1, P), NB, replace=False)
                       for _ in range(B)]).astype(np.int32)
    tables[0, 1:] = 0                  # past the live pages: the null page
    q = rs.randn(B, H, D).astype(np.float32)
    pos = np.array([3, 17, 30], np.int32)
    return q, k_pool, v_pool, tables, pos


@pytest.mark.parametrize("route", ["kernel", "dense"])
def test_paged_plain_matches_pallas(route):
    arrs = _paged_inputs(0)
    kw = {"interpret": True} if route == "kernel" else {}
    want = pk.paged_decode_attention(*(jnp.asarray(a) for a in arrs),
                                     route=route, **kw)
    got = ck.paged_decode_attention(*(torch.from_numpy(a) for a in arrs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gather_pages_matches_jax():
    _, k_pool, _, tables, _ = _paged_inputs(1)
    want = pk.gather_pages(jnp.asarray(k_pool), jnp.asarray(tables))
    got = ck.gather_pages(torch.from_numpy(k_pool), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ck.reset_launch_counts()
    arrs = [torch.from_numpy(a) for a in _paged_inputs(2)]
    ck.paged_decode_attention(*arrs)
    ck.paged_decode_attention(*arrs, route="plain")
    q = torch.randn(1, 8, 2, 64)
    ck.flash_attention(q, q, q, causal=True)
    xw, u = torch.randn(2, 3, 32), torch.randn(8, 32)
    out, _, _, c_seq = rk.lstm_sequence_fused(xw, torch.tensor([3, 1]), u,
                                              save_cell=True)
    z = torch.zeros(2, 8)
    rk.lstm_sequence_fused_bwd(xw, torch.tensor([3, 1]), u, torch.zeros(32),
                               z, z, out, c_seq, out, z, z)
    q.requires_grad_(True)
    ck.flash_attention(q, q, q, causal=True).sum().backward()
    q8, k8, v8, ks, vs, pos = _int8_cache_inputs(4)
    ck.decode_attention(q8, k8, v8, pos)
    ck.decode_attention(q8, k8, v8, pos, k_scale=ks, v_scale=vs)
    tables = torch.tensor([[1, 0], [2, 1], [0, 0]], dtype=torch.int32)
    ck.paged_decode_attention(q8, k8, v8, tables, pos, k_scale=ks,
                              v_scale=vs)
    gxw, gu, gl = torch.randn(2, 3, 24), torch.randn(8, 24), torch.tensor(
        [3, 1])
    gout, _ = rk.gru_sequence_fused(gxw, gl, gu)
    rk.gru_sequence_fused_bwd(gxw, gl, gu, z, gout, gout, z)
    assert ck.LAUNCHES == {"flash_attention_fwd": 0,
                           "flash_attention_bwd_dq": 0,
                           "flash_attention_bwd_dkv": 0,
                           "decode_attention": 0, "decode_attention_q": 0,
                           "paged_decode_attention": 0,
                           "paged_decode_attention_q": 0, "lstm_seq": 0,
                           "lstm_seq_train": 0, "lstm_seq_bwd": 0,
                           "gru_seq": 0, "gru_seq_bwd": 0}
    for route in ("dense", "kernel"):
        with pytest.raises(ValueError, match="unknown route"):
            ck.paged_decode_attention(*arrs, route=route)
        with pytest.raises(ValueError, match="unknown route"):
            ck.decode_attention(q8, k8, v8, pos, route=route)
    with pytest.raises(ValueError, match="go together"):
        ck.decode_attention(q8, k8, v8, pos, k_scale=ks)


def _int8_cache_inputs(seed):
    """q [3, 2, 16] f32, an int8 cache [3, 4, 2, 16] with its scales, pos."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(3, 2, 16).astype(np.float32))
    k8, ks = ck.quantize_kv(torch.from_numpy(
        rs.randn(3, 4, 2, 16).astype(np.float32)))
    v8, vs = ck.quantize_kv(torch.from_numpy(
        rs.randn(3, 4, 2, 16).astype(np.float32)))
    return q, k8, v8, ks, vs, torch.tensor([0, 2, 3], dtype=torch.int32)


def test_flash_fwd_attends_key_zero_for_an_empty_sample():
    """``flash_attention_fwd`` clamps a length to [1, S] before it routes,
    so both routes compute the same function: a 0-length sample attends
    key 0 (o = v[:, 0], lse = its one score) and a length past S reads all
    S keys."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rs, 3, 8, 12, 2, 16))
    o, lse = ck.flash_attention_fwd(q, k, v, kv_lens=torch.tensor([0, 5, 40]))
    want_o, want_lse = ck.flash_attention_fwd(
        q, k, v, kv_lens=torch.tensor([1, 5, 12]))
    torch.testing.assert_close(o, want_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    torch.testing.assert_close(o[0], v[0, :1].expand(8, 2, 16), atol=ATOL,
                               rtol=0)
    score = torch.einsum("thd,hd->th", q[0], k[0, 0]) * 16 ** -0.5
    torch.testing.assert_close(lse[0], score, atol=ATOL, rtol=0)


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    """The port runs where JAX is absent: no module of paddle_tpu_torch, nor
    chip_smoke.py, the card tools under tools/ or the tests' torch-side
    helpers (tests/torch_spmd.py, tests/torch_elastic_net.py,
    tests/torch_elastic_worker.py, tests/torch_configs.py and the
    cluster_train workers tests/torch_cluster*.py), may import jax or
    anything from paddle_tpu."""
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_spmd.py",
           ROOT / "tests" / "torch_configs.py"] \
        + sorted((ROOT / "tests").glob("torch_elastic_*.py")) \
        + sorted((ROOT / "tests").glob("torch_cluster*.py")) \
        + sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 10
    # the host runtime, the fault plane and the file formats among them
    rel = {str(f.relative_to(ROOT)) for f in files}
    assert {"paddle_tpu_torch/faults/inject.py",
            "paddle_tpu_torch/runtime/lib.py",
            "paddle_tpu_torch/runtime/master.py",
            "paddle_tpu_torch/runtime/recordio.py",
            "paddle_tpu_torch/utils/retry.py",
            "paddle_tpu_torch/data/chunks.py",
            "paddle_tpu_torch/data/format.py",
            "paddle_tpu_torch/data/parsers.py",
            "paddle_tpu_torch/data/provider.py",
            "paddle_tpu_torch/data/image.py",
            "paddle_tpu_torch/cli.py", "paddle_tpu_torch/__main__.py",
            "paddle_tpu_torch/analysis/diagnostics.py"} <= rel
    assert {f"paddle_tpu_torch/fluid/{m}.py" for m in (
        "__init__", "framework", "backward", "regularizer", "optimizer",
        "nets", "layers", "registry", "executor", "io", "evaluator")} <= rel
    assert {f"paddle_tpu_torch/v2/{m}.py" for m in (
        "__init__", "attr", "data_type", "evaluator", "inference", "layer",
        "networks", "optimizer", "parameters", "topology", "trainer")} <= rel
    assert {f"paddle_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "compat", "collectives", "sharding",
        "multihost", "ring_attention", "data_parallel", "tensor_parallel",
        "pipeline", "moe")} | {"tests/torch_spmd.py"} <= rel
    assert {f"paddle_tpu_torch/analysis/{m}.py" for m in (
        "__init__", "verify", "lints", "dataflow", "shape_infer",
        "bench_schema")} <= rel
    assert {f"paddle_tpu_torch/tune/{m}.py" for m in (
        "__init__", "cache", "driver", "fusion", "spaces")} <= rel
    assert {f"paddle_tpu_torch/cluster/{m}.py" for m in (
        "__init__", "actor", "scheduler", "spawn")} <= rel
    assert {f"paddle_tpu_torch/runtime/{m}.py" for m in (
        "arena", "capi_host", "coord", "lease")} | {
        "paddle_tpu_torch/trainer/elastic.py", "tests/torch_elastic_net.py",
        "tests/torch_elastic_worker.py"} <= rel
    assert {"tests/torch_configs.py", "tests/torch_cluster.py"} | {
        f"tests/torch_cluster_{k}_script.py"
        for k in ("train", "restart", "death")} <= rel
    banned = {"jax", "jaxlib", "paddle_tpu"}
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry point's parameter count equals the argtypes the loader
    declares (a mismatch would pass garbage through ctypes on the card)."""
    decl = re.compile(r'extern "C" int (\w+)\((.*?)\)\s*\{', re.S)
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in decl.findall(src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {n: len(a) for n, a in _build.SIGNATURES.items()}


def test_build_hash_tracks_sources_and_flags():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    names = {p.name for p in _build.sources()}
    assert {"flash_fwd.cu", "flash_bwd.cu", "paged_decode.cu", "common.cuh",
            "lstm_seq.cu", "lstm_seq_bwd.cu", "lstm.cuh", "decode.cu",
            "decode_attn.cuh", "recur.cuh", "gru_seq.cu",
            "gru_seq_bwd.cu", "flash_wide.cu", "flash_wide.cuh"} <= names
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
