"""The measurement driver — the counterpart of ``paddle_tpu/tune/driver.py``.

:func:`run_tune` enumerates the candidates of each plan space
(tune/spaces.py), measures every candidate on the current device and
persists the winners in the versioned autotune cache the routing entries
consult (tune/cache.py). The profile is ``bench`` on a card and ``cpu``
elsewhere.

Timing: on a card each candidate is timed with CUDA events around one
call on the current stream, after an untimed first call (which builds
the kernels on first use and captures what a graph captures), and takes
the best of ``reps``; elsewhere the wall clock does the same. On the CPU
the wrappers take their plain versions, which exercises the whole loop —
enumerate, measure, persist, consult — as JAX's interpreter sweeps do;
what carries to the card is the machinery, not the numbers. Every cached
plan was measured on the ``device_kind`` it is keyed under.

The swept kernels: ``fused_rnn`` launches #8-#12 (``ops/rnn_kernels.py``,
one launch a row tile), ``decode_route`` #4, #5 and #7 at each split
count, ``page_block`` #6; ``bucket_grid`` times a proxy body's CUDA graph
replays and captures; ``fusion`` whole executor runs
(tune/fusion.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import cache as _cache
from . import spaces as _spaces


def _device_kind() -> str:
    from ..obs.roofline import _device_kind as dk
    return dk()


def _sync(device) -> None:
    import torch
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_callable(fn, args: Sequence[Any], *, reps: int = 3,
                     space: str = "unknown", device=None) -> float:
    """Best-of-``reps`` seconds for one call of ``fn(*args)``.

    The first, untimed call pays the kernels' first-use build and any
    graph capture; on a card each timed call runs between two CUDA events
    on the current stream and is read after a synchronize, elsewhere the
    wall clock times it. Each measurement counts
    ``tune.measurements_total{space=...}`` on the obs plane."""
    import torch

    from .. import obs
    cuda = device is not None and torch.device(device).type == "cuda"
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(max(1, reps)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args)
            sec = time.perf_counter() - t0
        best = min(best, sec)
        obs.count("tune.measurements_total", space=space)
    return best


def _ms(sec: Optional[float]) -> Optional[float]:
    return round(sec * 1e3, 4) if sec is not None else None


# -- per-space sweeps ----------------------------------------------------------

#: the kernels a fused_rnn family sweeps, by its gate count
_FAMILY_KERNELS = {4: ("lstm_seq", "lstm_seq_train", "lstm_seq_bwd"),
                   3: ("gru_seq", "gru_seq_bwd")}


def _rnn_inputs(gates: int, T: int, H: int, B: int, device):
    """Seeded inputs of one family: xw, lengths, u, b, h0 (and c0), and
    the residuals and cotangents of its backward."""
    import numpy as np
    import torch

    from ..ops import rnn_kernels as rk
    rs = np.random.RandomState(0)

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=dt, device=device)

    ins = {"xw": t(rs.randn(B, T, gates * H) * 0.1),
           "lens": t(rs.randint(1, T + 1, B), torch.int32),
           "u": t(rs.randn(H, gates * H) * 0.1),
           "b": t(rs.randn(gates * H) * 0.1),
           "h0": t(np.zeros((B, H)))}
    if gates == 4:
        ins["c0"] = t(np.zeros((B, H)))
        out, _, _, c_seq = rk.lstm_sequence_fused(
            ins["xw"], ins["lens"], ins["u"], ins["b"], ins["h0"], ins["c0"],
            save_cell=True)
        ins.update(out=out, c_seq=c_seq)
    else:
        out, _ = rk.gru_sequence_fused(ins["xw"], ins["lens"], ins["u"],
                                       None, ins["h0"])
        ins["out"] = out
    ins["g_out"] = t(rs.randn(B, T, H) * 0.1)
    ins["g_ht"] = t(rs.randn(B, H) * 0.1)
    ins["g_ct"] = t(rs.randn(B, H) * 0.1)
    return ins


def _rnn_call(kernel: str, ins: Dict[str, Any], route):
    """One call of ``kernel``'s wrapper on the family's inputs under the
    row-tile route ``route``."""
    from ..ops import rnn_kernels as rk
    i = ins
    if kernel in ("lstm_seq", "lstm_seq_train"):
        return rk.lstm_sequence_fused(
            i["xw"], i["lens"], i["u"], i["b"], i["h0"], i["c0"],
            save_cell=kernel == "lstm_seq_train", plan=route)
    if kernel == "lstm_seq_bwd":
        return rk.lstm_sequence_fused_bwd(
            i["xw"], i["lens"], i["u"], i["b"], i["h0"], i["c0"], i["out"],
            i["c_seq"], i["g_out"], i["g_ht"], i["g_ct"], plan=route)
    if kernel == "gru_seq":
        return rk.gru_sequence_fused(i["xw"], i["lens"], i["u"], i["b"],
                                     i["h0"], plan=route)
    return rk.gru_sequence_fused_bwd(i["xw"], i["lens"], i["u"], i["h0"],
                                     i["out"], i["g_out"], i["g_ht"],
                                     plan=route)


def _limits(device):
    import torch

    from ..ops import rnn_kernels as rk
    dev = torch.device(device)
    return rk.limits_for(dev) or rk.H100


def _sweep_fused_family(fam: Dict[str, Any], reps: int,
                        device) -> List[Dict[str, Any]]:
    """One row per kernel of the family: every resident row tile timed,
    the fastest the plan; ``plan_route``'s choice timed beside it."""
    import torch

    from ..ops import rnn_kernels as rk
    gates, T, H, B = fam["gates"], fam["T"], fam["H"], fam["batch"]
    family = _spaces.fused_family(gates=gates, T=T, H=H, batch=B)
    lim = _limits(device)
    ins = _rnn_inputs(gates, T, H, B, device)
    rows = []
    for kernel in _FAMILY_KERNELS[gates]:
        cands = _spaces.fused_candidates(T=T, H=H, gates=gates, batch=B,
                                         kernel=kernel, limits=lim)
        heur = rk.plan_route(kernel, B, H, torch.float32, *lim)
        heur_plan = ("whole" if heur.kind == "whole" else
                     heur.tiles[0][1] if heur.kind == "tiles" else None)
        if heur_plan is not None and heur_plan not in cands:
            cands.append(heur_plan)
        timed: List[Tuple[Any, float]] = []
        for plan in cands:
            route = _spaces.route_of(plan, kernel=kernel, H=H, batch=B,
                                     limits=lim)
            timed.append((plan, measure_callable(
                lambda r=route: _rnn_call(kernel, ins, r), (), reps=reps,
                space="fused_rnn", device=device)))
        if not timed:
            rows.append({"space": "fused_rnn", "kernel": kernel,
                         "family": family, "plan": None,
                         "note": fam.get("note", ""),
                         "skipped": "no resident row tile (the step loop "
                                    "owns this family)"})
            continue
        plan, tuned_s = min(timed, key=lambda kv: kv[1])
        heur_s = next((s for p, s in timed if p == heur_plan), None)
        rows.append({
            "space": "fused_rnn", "kernel": kernel, "family": family,
            "plan": plan, "tuned_ms": _ms(tuned_s),
            "heuristic_plan": heur_plan, "heuristic_ms": _ms(heur_s),
            "speedup": (round(heur_s / tuned_s, 3)
                        if heur_s and tuned_s else None),
            "candidates": len(timed), "note": fam.get("note", ""),
            "sweep": [{"plan": p, "ms": _ms(s)} for p, s in timed],
        })
    return rows


def _decode_reads(B: int, Hh: int, Dh: int, L: int, device, rs):
    """The reads one split count is timed over: #4 in f32 and bf16, #5
    (an int8 cache) and #7 (int8 pools of 64-row pages)."""
    import torch

    from ..ops import cuda_kernels as ck

    def t(a, dt=torch.float32):
        return torch.tensor(a, device=device).to(dt)

    q = t(rs.randn(B, Hh, Dh))
    k = t(rs.randn(B, L, Hh, Dh))
    v = t(rs.randn(B, L, Hh, Dh))
    pos = torch.full((B,), L - 1, dtype=torch.int32, device=device)
    kq, ks = ck.quantize_kv(k)
    vq, vs = ck.quantize_kv(v)
    bs = 64 if L % 64 == 0 else L
    NB = L // bs
    P = B * NB + 1
    tables = torch.arange(1, P, dtype=torch.int32,
                          device=device).reshape(B, NB)

    def pool(x):
        flat = x.reshape((B * NB, bs) + tuple(x.shape[2:]))
        return torch.cat([torch.zeros_like(flat[:1]), flat])

    scale = Dh ** -0.5
    cuda = torch.device(device).type == "cuda"
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kp, vp, ksp, vsp = pool(kq), pool(vq), pool(ks), pool(vs)

    def run(n):
        if cuda:
            ck._decode_attention_kernel(q, k, v, pos, scale, None, None, n)
            ck._decode_attention_kernel(qb, kb, vb, pos, scale, None, None,
                                        n)
            ck._decode_attention_kernel(q, kq, vq, pos, scale, ks, vs, n)
            ck._paged_decode_attention_kernel(q, kp, vp, tables, pos, scale,
                                              ksp, vsp, splits=n)
            return
        ck.decode_attention(q, k, v, pos)
        ck.decode_attention(qb, kb, vb, pos)
        ck.decode_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs)
        ck.paged_decode_attention(q, kp, vp, tables, pos, k_scale=ksp,
                                  v_scale=vsp)

    return run


def _sweep_decode(cfg: Dict[str, Any], reps: int,
                  device) -> Dict[str, Any]:
    """The split count of each length of the grid: every distinct count
    of the space's candidates timed over #4 (f32, bf16), #5 and #7, the
    fastest total the plan; ``decode_splits``' own count beside it."""
    import numpy as np
    import torch

    from ..ops import cuda_kernels as ck
    B, Hh, Dh = cfg["batch"], cfg["n_heads"], cfg["d_head"]
    bh = B * Hh
    rs = np.random.RandomState(1)
    cuda = torch.device(device).type == "cuda"
    per_len: List[Dict[str, Any]] = []
    splits: Dict[str, int] = {}
    for L in cfg["lengths"]:
        run = _decode_reads(B, Hh, Dh, L, device, rs)
        counts = sorted({ck.decode_splits(bh, L, n)[0] for n in
                         _spaces.SPACE_DEFS["decode_route"]["splits"]})
        heur = ck.decode_splits(bh, L, ck.default_split_count(bh, L))[0]
        if heur not in counts:
            counts.append(heur)
        timed = [(n, measure_callable(run, (n,), reps=reps,
                                      space="decode_route", device=device))
                 for n in counts]
        win, win_s = min(timed, key=lambda kv: kv[1])
        heur_s = next(s for n, s in timed if n == heur)
        splits[_spaces.decode_family(bh, L)] = win
        per_len.append({"len": L, "splits": win, "tuned_ms": _ms(win_s),
                        "heuristic_splits": heur,
                        "heuristic_ms": _ms(heur_s),
                        "sweep": [{"splits": n, "ms": _ms(s)}
                                  for n, s in timed]})
    tuned = sum(r["tuned_ms"] for r in per_len)
    heur = sum(r["heuristic_ms"] for r in per_len)
    return {
        "space": "decode_route", "kernel": "decode_attention",
        "family": "default",
        # on a card every read of a CUDA tensor takes the kernel (from
        # length 1); elsewhere the plain version served every read
        "plan": {"kernel_min_len": 1 if cuda else None, "splits": splits},
        "heuristic_plan": {"kernel_min_len": 1 if cuda else None,
                           "splits": {_spaces.decode_family(bh, r["len"]):
                                      r["heuristic_splits"]
                                      for r in per_len}},
        "tuned_ms": round(tuned, 4), "heuristic_ms": round(heur, 4),
        "speedup": round(heur / tuned, 3) if tuned else None,
        "sweep": per_len, "note": cfg.get("note", ""),
        "candidates": sum(len(r["sweep"]) for r in per_len),
    }


def _sweep_page_block(cfg: Dict[str, Any], reps: int,
                      device) -> Dict[str, Any]:
    """#6 at each page size over ``read_pages`` pages a sample, compared
    per position read (the read length grows with the page), as JAX
    compares."""
    import numpy as np
    import torch

    from ..ops import cuda_kernels as ck
    B, Hh, Dh = cfg["batch"], cfg["n_heads"], cfg["d_head"]
    read_pages = cfg["read_pages"]
    rs = np.random.RandomState(2)
    q = torch.tensor(rs.randn(B, Hh, Dh), dtype=torch.float32,
                     device=device)
    timed: List[Tuple[int, float]] = []
    for bs in cfg["blocks"]:
        L = read_pages * bs
        P = B * read_pages + 1
        k_pool = torch.tensor(rs.randn(P, bs, Hh, Dh), dtype=torch.float32,
                              device=device)
        v_pool = torch.tensor(rs.randn(P, bs, Hh, Dh), dtype=torch.float32,
                              device=device)
        tables = torch.tensor(
            1 + np.arange(B * read_pages).reshape(B, read_pages) % (P - 1),
            dtype=torch.int32, device=device)
        pos = torch.full((B,), L - 1, dtype=torch.int32, device=device)
        timed.append((bs, measure_callable(
            ck.paged_decode_attention, (q, k_pool, v_pool, tables, pos),
            reps=reps, space="page_block", device=device)))
    per_tok = [(bs, sec / (read_pages * bs)) for bs, sec in timed]
    win_bs, _ = min(per_tok, key=lambda kv: kv[1])
    heur = 64
    heur_s = next((sec for bs, sec in timed if bs == heur), None)
    tuned_s = next(sec for bs, sec in timed if bs == win_bs)
    return {
        "space": "page_block", "kernel": "paged_decode_attention",
        "family": "default", "plan": {"page_block": win_bs},
        "tuned_ms": _ms(tuned_s),
        "heuristic_plan": {"page_block": heur},
        "heuristic_ms": _ms(heur_s),
        "route": ("kernel" if torch.device(device).type == "cuda"
                  else "plain"),
        "note": cfg.get("note", ""),
        "sweep": [{"page_block": bs, "ms": _ms(sec),
                   "ms_per_token": round(mt * 1e3, 6)}
                  for (bs, sec), (_, mt) in zip(timed, per_tok)],
        "candidates": len(timed),
    }


def _sweep_fusion(cfg: Dict[str, Any], reps: int,
                  device) -> List[Dict[str, Any]]:
    """One row per certified group of the MLP proxy program, measured
    fused-vs-unfused through whole executor runs (tune/fusion.py)."""
    from . import fusion as _fusion
    main, startup, feed, fetch = _fusion.build_proxy_program(
        batch=cfg["batch"], width=cfg["width"], depth=cfg["depth"])
    rows = _fusion.measure_fusion(main, startup, feed, fetch, reps=reps,
                                  note=cfg.get("note", ""), device=device)
    if not rows:
        return [{"space": "fusion", "kernel": "fused_region",
                 "family": "none", "plan": None,
                 "skipped": "oracle certified no schedulable groups on "
                            "the proxy program",
                 "note": cfg.get("note", "")}]
    return rows


def _sweep_bucket_grid(cfg: Dict[str, Any], reps: int,
                       device) -> List[Dict[str, Any]]:
    """Whole bucket grids, as JAX measures them: a grid's cost over a
    seeded zipf-like length sample is each request's replay time at its
    padded bucket plus one capture per distinct bucket the sample
    touches (the counterpart of a compile). One row per kind."""
    import numpy as np
    import torch

    from ..core.graphs import GraphCache
    from ..data.feeder import next_bucket
    B, D, max_len = cfg["batch"], cfg["d_model"], cfg["max_len"]
    rs = np.random.RandomState(3)
    raw = rs.zipf(cfg["zipf_a"], cfg["samples"])
    lens = np.minimum(raw * max(1, max_len // 64), max_len).astype(int)
    rs2 = np.random.RandomState(4)
    w1 = torch.tensor(rs2.randn(D, D) * 0.05, dtype=torch.float32,
                      device=device)
    w2 = torch.tensor(rs2.randn(D, D) * 0.05, dtype=torch.float32,
                      device=device)
    graphs = GraphCache("tune.bucket_grid", device)

    def body(x):
        return torch.tanh(x @ w1) @ w2

    def proxy(x):
        return graphs.run("proxy", body, {"x": x})

    dispatch_s: Dict[int, float] = {}
    capture_s: Dict[int, float] = {}

    def measured(bucket: int) -> Tuple[float, float]:
        """(replay seconds, capture seconds) of one padded length."""
        if bucket not in dispatch_s:
            x = torch.tensor(rs2.randn(B, bucket, D) * 0.1,
                             dtype=torch.float32, device=device)
            _sync(device)
            t0 = time.perf_counter()
            proxy(x)                        # eager run + capture
            _sync(device)
            first = time.perf_counter() - t0
            best = measure_callable(proxy, (x,), reps=reps,
                                    space="bucket_grid", device=device)
            dispatch_s[bucket] = best
            capture_s[bucket] = max(0.0, first - best)
        return dispatch_s[bucket], capture_s[bucket]

    heuristics = {"prompt": [32, 64, 128, 256, 512], "cache": [256]}
    rows: List[Dict[str, Any]] = []
    try:
        for kind in _spaces.SPACE_DEFS["bucket_grid"]["kinds"]:
            grids = [tuple(b for b in g if b <= max_len) for g in
                     _spaces.SPACE_DEFS["bucket_grid"]["grids"][kind]]
            grids = [g for g in dict.fromkeys(grids) if g]
            heur = tuple(b for b in heuristics[kind] if b <= max_len)
            if heur and heur not in grids:
                grids.append(heur)
            timed: List[Tuple[Tuple[int, ...], float, int]] = []
            for grid in grids:
                used = sorted({next_bucket(int(n), grid) for n in lens})
                cost = sum(measured(b)[1] for b in used)
                for n in lens:
                    cost += measured(next_bucket(int(n), grid))[0]
                timed.append((grid, cost, len(used)))
            win, tuned_c, _ = min(timed, key=lambda kv: kv[1])
            heur_c = next((c for g, c, _ in timed if g == heur), None)
            rows.append({
                "space": "bucket_grid", "kernel": "prefill_dispatch",
                "family": kind, "plan": {"buckets": list(win)},
                "tuned_ms": _ms(tuned_c),
                "heuristic_plan": {"buckets": list(heur)},
                "heuristic_ms": _ms(heur_c),
                "speedup": (round(heur_c / tuned_c, 3)
                            if heur_c and tuned_c else None),
                "candidates": len(timed), "note": cfg.get("note", ""),
                "sweep": [{"buckets": list(g), "ms": _ms(c),
                           "distinct_buckets": nb} for g, c, nb in timed],
            })
    finally:
        graphs.clear()
    return rows


# -- ledger seeding ------------------------------------------------------------

#: substring -> (plan space, fused-RNN gate filter): the profile's hottest
#: op sites onto the spaces that can move them. First match wins (paged
#: before decode). The port's kernels are named ``lstm_seq*``,
#: ``gru_seq*``, ``decode_split_kernel<PagedRows...>`` and so on; JAX's
#: op names are kept beside them.
_LEDGER_HINTS: Tuple[Tuple[str, str, Optional[int]], ...] = (
    ("lstm", "fused_rnn", 4),
    ("gru", "fused_rnn", 3),
    ("paged", "page_block", None),
    ("decode", "decode_route", None),
    ("prefill", "bucket_grid", None),
    ("prompt", "bucket_grid", None),
    ("fused_", "fusion", None),
    ("elementwise", "fusion", None),
    ("matmul", "fusion", None),
    ("mul", "fusion", None),
    ("fc", "fusion", None),
)


def _ledger_sites(path: str, topk: int = 8) -> List[Dict[str, Any]]:
    """Top-``topk`` op sites by self time from a profile.

    Accepts a JSON/JSONL row dump (``[{"op": ..., "self_ns": ...}, ...]``
    or ``{"rows": [...]}``), a ``torch.profiler`` Chrome trace, or an
    XSpace protobuf; the last two go through ``obs.xplane``'s reader and
    its ``op_totals`` (the port's own profile rows)."""
    import json as _json

    from ..obs import xplane
    if path.endswith((".json", ".jsonl")):
        with open(path) as f:
            txt = f.read()
        try:
            data = _json.loads(txt)
        except ValueError:
            data = [_json.loads(ln) for ln in txt.splitlines() if ln.strip()]
        if isinstance(data, dict) and "traceEvents" in data:
            rows = [{"op": r["op"], "self_ns": r["self_ns"]} for r in
                    xplane.op_totals(xplane.read_torch_trace(path))]
        else:
            if isinstance(data, dict):
                data = data.get("rows") or data.get("ops") or []
            rows = [{"op": str(r.get("op", "")),
                     "self_ns": int(r.get("self_ns", r.get("total_ns", 0)))}
                    for r in data if isinstance(r, dict) and r.get("op")]
    else:
        rows = [{"op": r["op"], "self_ns": r["self_ns"]}
                for r in xplane.op_totals(xplane.read_trace(path))]
    rows.sort(key=lambda r: -r["self_ns"])
    return rows[:max(1, topk)]


def _ledger_seeding(sites: List[Dict[str, Any]]
                    ) -> Tuple[List[str], List[int], List[Dict[str, Any]]]:
    """(implicated spaces, implicated fused-RNN gate counts, annotated
    sites)."""
    spaces_hit: List[str] = []
    gates: List[int] = []
    annotated: List[Dict[str, Any]] = []
    for site in sites:
        op = site["op"].lower()
        hit_space = None
        for needle, space, g in _LEDGER_HINTS:
            if needle in op:
                hit_space = space
                if space not in spaces_hit:
                    spaces_hit.append(space)
                if g and g not in gates:
                    gates.append(g)
                break
        annotated.append(dict(site, space=hit_space))
    return spaces_hit, gates, annotated


# -- the entry point -----------------------------------------------------------

def run_tune(spaces: Optional[Sequence[str]] = None,
             profile: Optional[str] = None,
             cache_path: Optional[str] = None,
             reps: Optional[int] = None,
             save: bool = True,
             from_ledger: Optional[str] = None,
             ledger_topk: int = 8, *, device=None) -> Dict[str, Any]:
    """Sweep ``spaces`` under ``profile``, persist winners, return results
    — JAX's signature and report, plus ``device`` (default: the card;
    ``device="cpu"`` sweeps the plain versions).

    ``profile=None`` selects ``bench`` on a card and ``cpu`` elsewhere.
    ``from_ledger`` seeds the sweep from a profile (see
    :func:`_ledger_sites`): the top-``ledger_topk`` op sites by self time
    pick the plan spaces (and fused-RNN families) swept when the caller
    pinned no ``spaces``; each seeded family counts
    ``tune.ledger_seeded_families_total``. The report carries
    ``device_kind``, ``backend`` (``device`` on a card, ``plain``
    elsewhere), the per-family ``results`` with their sweeps, the
    ``ledger`` report when seeded, and the ``cache_path`` written (None
    with ``save=False``). Winners merge into an existing cache file."""
    from .. import obs
    from ..core.place import require_device
    device = require_device(device)
    on_card = device.type == "cuda"
    if profile is None:
        profile = "bench" if on_card else "cpu"
    prof = _spaces.PROFILES[profile]
    user_pinned = bool(spaces)
    spaces = tuple(spaces) if spaces else _spaces.SPACE_NAMES
    for s in spaces:
        if s not in _spaces.SPACE_DEFS:
            raise ValueError(f"unknown plan space {s!r} "
                             f"(known: {list(_spaces.SPACE_NAMES)})")
    n_reps = reps if reps is not None else prof["reps"]
    device_kind = _device_kind()
    backend = "device" if on_card else "plain"

    ledger_report = None
    ledger_gates: List[int] = []
    seeded_spaces: List[str] = []
    if from_ledger:
        sites = _ledger_sites(from_ledger, ledger_topk)
        seeded_spaces, ledger_gates, annotated = _ledger_seeding(sites)
        if seeded_spaces and not user_pinned:
            spaces = tuple(s for s in _spaces.SPACE_NAMES
                           if s in seeded_spaces)
        ledger_report = {"path": from_ledger, "topk": ledger_topk,
                         "sites": annotated,
                         "seeded_spaces": seeded_spaces,
                         "swept_spaces": list(spaces)}

    results: List[Dict[str, Any]] = []
    if "fused_rnn" in spaces:
        fams = prof["fused_families"]
        if ledger_gates:
            fams = [f for f in fams if f["gates"] in ledger_gates] or fams
        for fam in fams:
            results.extend(_sweep_fused_family(fam, n_reps, device))
    if "decode_route" in spaces:
        results.append(_sweep_decode(prof["decode"], n_reps, device))
    if "page_block" in spaces:
        results.append(_sweep_page_block(prof["page_block"], n_reps, device))
    if "fusion" in spaces:
        results.extend(_sweep_fusion(prof["fusion"], n_reps, device))
    if "bucket_grid" in spaces:
        results.extend(_sweep_bucket_grid(prof["bucket_grid"], n_reps,
                                          device))

    if from_ledger:
        for r in results:
            if r["space"] in seeded_spaces and not (
                    r.get("plan") is None and "skipped" in r):
                obs.count("tune.ledger_seeded_families_total")

    out_path = None
    if save:
        path = cache_path or _cache.default_cache_path()
        try:
            existing = _cache.load_cache(path)
        except (OSError, ValueError):
            existing = _cache.AutotuneCache()
        for r in results:
            if r.get("plan") is None and "skipped" in r:
                continue
            meta = {k: r[k] for k in ("tuned_ms", "heuristic_ms",
                                      "heuristic_plan", "speedup", "note",
                                      "sweep", "certificate",
                                      "program_signature", "shape_family",
                                      "fused_ms", "unfused_ms") if k in r}
            meta.update(methodology="measured", backend=backend,
                        profile=profile)
            existing.put(r["space"], r["kernel"], device_kind, r["family"],
                         r["plan"], _spaces.space_hash(r["space"]), **meta)
        out_path = existing.save(path)
        _cache.reset()       # the fresh file is the consult target now
    report = {"device_kind": device_kind, "backend": backend,
              "profile": profile, "results": results,
              "cache_path": out_path}
    if ledger_report is not None:
        report["ledger"] = ledger_report
    return report


def results_markdown(report: Dict[str, Any]) -> str:
    """One run's winners as a markdown table."""
    lines = [
        "| space | kernel | family | tuned plan | tuned ms | heuristic "
        "plan | heuristic ms | speedup |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in report["results"]:
        if r.get("plan") is None and "skipped" in r:
            lines.append(f"| {r['space']} | {r['kernel']} | {r['family']} "
                         f"| — (step loop) | — | — | — | — |")
            continue
        lines.append(
            f"| {r['space']} | {r['kernel']} | {r['family']} "
            f"| {r.get('plan')} | {r.get('tuned_ms', '—')} "
            f"| {r.get('heuristic_plan')} | {r.get('heuristic_ms', '—')} "
            f"| {r.get('speedup', '—')} |")
    lines.append("")
    lines.append(f"(device_kind={report['device_kind']}, "
                 f"backend={report['backend']}, "
                 f"profile={report['profile']})")
    return "\n".join(lines)
