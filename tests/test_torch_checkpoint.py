"""The port's checkpoints (paddle_tpu_torch/trainer/checkpoint.py) against
the JAX package's, on the CPU: the same files byte for byte, each side's
pass directories loading into the other, and the crash-safety rules
(torn, CRC-damaged and ``.tmp`` directories) applied alike.

bf16: JAX's ml_dtypes bf16 leaf is written with ``descr '<V2'``; the
port writes a bf16 tensor with the same header and words, and maps a
2-byte void member back to bf16. JAX's own ``from_tar`` returns such a
leaf as a raw ``|V2`` array (ROADMAP C.3), so the JAX side of a bf16
comparison reads the words through ``view(ml_dtypes.bfloat16)``.
Comparisons are exact: nothing is computed.
"""

import io
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.trainer.checkpoint as J
import paddle_tpu_torch.trainer.checkpoint as P
from paddle_tpu_torch.core.pytree import (flatten_path_tree, tree_spec,
                                          unflatten_path_tree)


def _np_tree(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "embed": {"w": rs.randn(5, 3).astype(np.float32)},
        "bf": rs.randn(4, 2).astype(np.float32).astype(ml_dtypes.bfloat16),
        "step": np.asarray(7, np.int32),
        "ids": rs.randint(0, 9, (3,)).astype(np.int32),
        "empty": {},
        "slots": {"sgd": {}, "list": [], "tup": ()},
        "seq": (rs.randn(2).astype(np.float32),
                [np.arange(3, dtype=np.int64), {"x": np.float32(1.5)}]),
    }


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _tar(mod, tree) -> bytes:
    buf = io.BytesIO()
    mod.to_tar(buf, tree)
    return buf.getvalue()


def _same(port, want):
    """A port tree (tensors) equal to a numpy tree, leaf by leaf and
    container by container."""
    assert tree_spec(port) == tree_spec(want)
    mine, theirs = dict(flatten_path_tree(port)), dict(
        flatten_path_tree(want))
    assert sorted(mine) == sorted(theirs)
    for p, a in mine.items():
        b = np.asarray(theirs[p])
        if b.dtype.kind == "V":            # JAX's restored bf16
            b = b.view(ml_dtypes.bfloat16)
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16, p
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16)), p
        else:
            assert np.array_equal(a.numpy(), b) and a.shape == b.shape, p


@pytest.mark.parametrize("seed", [0, 1])
def test_to_tar_is_byte_identical_to_jax(seed):
    tree = _np_tree(seed)
    want = _tar(J, tree)
    assert _tar(P, tree) == want               # numpy leaves
    assert _tar(P, _to_torch(tree)) == want    # tensor leaves, bf16 too


def test_bf16_member_header_is_v2():
    raw = _tar(P, {"b": torch.ones(2, 2, dtype=torch.bfloat16)})
    assert b"'descr': '<V2'" in raw


def test_tar_round_trips_tree_structure():
    tree = _to_torch(_np_tree())
    back = P.from_tar(io.BytesIO(_tar(P, tree)), device="cpu")
    _same(back, _np_tree())
    assert isinstance(back["seq"], tuple) and isinstance(back["seq"][1],
                                                         list)
    assert back["slots"] == {"sgd": {}, "list": [], "tup": ()}


def test_path_codec_matches_jax():
    from paddle_tpu.core import pytree as JT
    tree = _np_tree()
    assert [p for p, _ in flatten_path_tree(tree)] == \
        [p for p, _ in JT.flatten_path_tree(tree)]
    assert tree_spec(tree) == JT.tree_spec(tree)
    flat = dict(flatten_path_tree(tree))
    for spec in (tree_spec(tree), None):
        mine = unflatten_path_tree(flat, spec)
        theirs = JT.unflatten_path_tree(flat, spec)
        assert tree_spec(mine) == tree_spec(theirs)


def _rand_tree(rs, depth=0):
    """Dicts, lists and tuples to depth 3 with float leaves; no dict or
    sequence holds an empty container before a leaf (whose place the
    format does not record)."""
    kind = rs.choice(["dict", "list", "tuple"]) if depth else "dict"
    kids = [_rand_tree(rs, depth + 1) if depth < 3 and rs.rand() < 0.5
            else float(rs.rand()) for _ in range(rs.randint(0, 5))]
    leaves = [k for k in kids if isinstance(k, float)]
    full = [k for k in kids if not isinstance(k, float)
            and flatten_path_tree(k)]
    empty = [k for k in kids if not isinstance(k, float)
             and not flatten_path_tree(k)]
    kids = [k for k in kids if k in leaves or k in full] + empty
    if kind == "dict":
        return {f"k{rs.randint(100)}_{i}": v for i, v in enumerate(kids)}
    return tuple(kids) if kind == "tuple" else kids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unflatten_keeps_walk_order(seed):
    """Leaves and containers interleaved in any order come back in the
    order they were flattened; an empty container that stood before a
    leaf of its dict comes back after its leaves, with the same paths in
    the same order."""
    rs = np.random.RandomState(seed)
    for _ in range(200):
        tree = _rand_tree(rs)
        back = unflatten_path_tree(dict(flatten_path_tree(tree)),
                                   tree_spec(tree))
        assert back == tree
        assert list(tree_spec(back).items()) == list(tree_spec(tree).items())
        assert [p for p, _ in flatten_path_tree(back)] == \
            [p for p, _ in flatten_path_tree(tree)]
    tie = {"a": {}, "b": 1.0}
    back = unflatten_path_tree(dict(flatten_path_tree(tie)), tree_spec(tie))
    assert list(back) == ["b", "a"] and tree_spec(back) == tree_spec(tie)


def test_resaved_pass_is_the_same_bytes(tmp_path):
    """A loaded pass lists each dict's keys as the saved trees did (an
    optimizer state's ``step`` before its containers), so saving it again
    writes both archives byte for byte."""
    tree = _to_torch(_np_tree(2))
    state = {"step": torch.tensor(5, dtype=torch.int32),
             "slots": {"embed": {"w": {"m": torch.ones(5, 3)}}},
             "hooks": {"embed": {"w": {}}}}
    P.save_checkpoint(str(tmp_path / "a"), 0, tree, state)
    p, s, _ = P.load_checkpoint(str(tmp_path / "a"), device="cpu")
    assert list(s) == ["step", "slots", "hooks"] and list(p) == list(tree)
    assert [q for q, _ in flatten_path_tree(p)] == \
        [q for q, _ in flatten_path_tree(tree)]
    P.save_checkpoint(str(tmp_path / "b"), 0, p, s)
    for name in ("params.tar", "opt_state.tar"):
        assert (tmp_path / "a" / "pass-00000" / name).read_bytes() == \
            (tmp_path / "b" / "pass-00000" / name).read_bytes(), name


def _save(mod, d, pass_id, seed, extra=None):
    tree = _np_tree(seed)
    state = {"step": np.asarray(seed, np.int32), "slots": tree["embed"]}
    if mod is P:
        tree, state = _to_torch(tree), _to_torch(state)
    return mod.save_checkpoint(str(d), pass_id, tree, state, extra=extra)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pass_directories_load_across(tmp_path, writer):
    """A pass written by either side is the same files and loads into
    both."""
    wmod = J if writer == "jax" else P
    _save(wmod, tmp_path / "w", 0, 3)
    _save(wmod, tmp_path / "w", 1, 4, extra={"pass_complete": False,
                                             "batch_id": 2})
    other = P if writer == "jax" else J
    _save(other, tmp_path / "o", 1, 4, extra={"pass_complete": False,
                                              "batch_id": 2})
    for name in ("params.tar", "opt_state.tar", "state.json",
                 "_COMPLETE"):
        a = (tmp_path / "w" / "pass-00001" / name).read_bytes()
        b = (tmp_path / "o" / "pass-00001" / name).read_bytes()
        assert a == b, name
    pp, ps, pst = P.load_checkpoint(str(tmp_path / "w"), device="cpu")
    jp, js, jst = J.load_checkpoint(str(tmp_path / "w"))
    assert pst == jst == {"pass_id": 1, "version": 1,
                          "pass_complete": False, "batch_id": 2}
    _same(pp, jp)
    _same(ps, js)
    _same(pp, _np_tree(4))
    assert P.latest_pass(str(tmp_path / "w")) == \
        J.latest_pass(str(tmp_path / "w")) == 1


def _damage(d, how):
    if how == "crc":
        p = d / "pass-00001" / "params.tar"
        raw = bytearray(p.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        p.write_bytes(bytes(raw))
    elif how == "torn":
        os.remove(d / "pass-00001" / "_COMPLETE")
    elif how == "tmp":
        os.rename(d / "pass-00001", d / "pass-00001.tmp")
        m = json.loads((d / "pass-00001.tmp" / "_COMPLETE").read_text())
        m["members"]["params.tar"]["crc32"] ^= 1
        (d / "pass-00001.tmp" / "_COMPLETE").write_text(json.dumps(m))
    elif how == "swap":
        # a re-publish interrupted between its renames: the new pass as a
        # verified .tmp, the old one aside as .old
        os.rename(d / "pass-00001", d / "pass-00001.tmp")
        _save(J, d / "x", 1, 9)
        os.rename(d / "x" / "pass-00001", d / "pass-00001.old")


@pytest.mark.parametrize("how", ["crc", "torn", "tmp", "swap"])
def test_damaged_passes_are_handled_as_jax_does(tmp_path, how):
    runs = {}
    for name, mod in (("jax", J), ("port", P)):
        d = tmp_path / name
        _save(mod, d, 0, 3)
        _save(mod, d, 1, 4)
        _damage(d, how)
        if mod is P:
            params, _, st = P.load_checkpoint(str(d), device="cpu")
        else:
            params, _, st = J.load_checkpoint(str(d))
        runs[name] = (params, st, sorted(os.listdir(d)),
                      mod.latest_pass(str(d)),
                      mod.latest_pass(str(d), verify=True))
    (pp, pst, pls, plat, pver), (jp, jst, jls, jlat, jver) = (
        runs["port"], runs["jax"])
    assert pst == jst and plat == jlat and pver == jver
    assert [n for n in pls if n != "x"] == [n for n in jls if n != "x"]
    _same(pp, jp)
    want_pass = {"crc": 0, "torn": 0, "tmp": 0, "swap": 1}[how]
    assert pst["pass_id"] == want_pass
    if how == "swap":     # rolled forward: the verified .tmp is published
        _same(pp, _np_tree(4))


def test_explicit_pass_is_verified(tmp_path):
    _save(P, tmp_path, 0, 3)
    _damage_crc = tmp_path / "pass-00000" / "opt_state.tar"
    raw = bytearray(_damage_crc.read_bytes())
    raw[-1] ^= 1
    _damage_crc.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        P.load_checkpoint(str(tmp_path), 0, device="cpu")
    with pytest.raises(FileNotFoundError):
        P.load_checkpoint(str(tmp_path), device="cpu")


def test_load_defaults_to_the_card(tmp_path):
    _save(P, tmp_path, 0, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            P.load_checkpoint(str(tmp_path))
