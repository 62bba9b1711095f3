"""Plan spaces — the enumerable candidate sets the tuner searches; the
counterpart of ``paddle_tpu/tune/spaces.py`` over the decisions the port
really makes on the card.

Each space maps onto one dispatch choice of the port:

* ``fused_rnn`` — the row tile of a recurrent kernel's launch (#8-#12),
  per ``(kernel, shape family)``: ``"whole"`` (one launch over the batch)
  or a tile of b rows, b from ``blocks``, one launch a tile in row order
  (``ops.rnn_kernels.tile_route``). The counterpart of JAX's ``block_b``;
  JAX's ``chunk_t`` has no counterpart (the CUDA bodies walk T whole).
  Candidates are exactly the tiles whose grid is resident on the card
  (``tile_route``'s check, the one :func:`ops.rnn_kernels.plan_route`
  makes), so a cached winner can never be an illegal launch.
* ``decode_route`` — the split count of a decode read (#4-#7,
  ``ops.cuda_kernels.decode_splits``) over a length grid, per (B*H,
  length). On the card every read of a CUDA tensor takes the kernel, so
  JAX's dense-vs-kernel crossover has one answer there; the entry
  records it as ``kernel_min_len`` (1 on a card, null where the plain
  version served every read: a CPU host), as JAX's does.
* ``page_block`` — the paged KV-cache page size, as in JAX.
* ``fusion`` — per certified group: fuse into one dispatch region or
  not, as in JAX (tune/fusion.py).
* ``bucket_grid`` — the prompt/cache bucket grids serving captures
  against, as in JAX; a grid's cost is the replay time of a length sample
  plus one CUDA graph capture per distinct bucket it touches.

Every space carries ``"target": "torch-cuda"`` in its ``SPACE_DEFS``
literal, so each of its hashes differs from the JAX package's: an entry
that JAX's tuner wrote is stale here and never consulted (ROADMAP C.13).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple, Union

#: the tag every space of the port carries: it keeps the port's hashes
#: apart from JAX's
TARGET = "torch-cuda"

#: static, hash-stable definition of each plan space. Bump ``version`` (or
#: change any constant) to invalidate previously tuned entries.
SPACE_DEFS: Dict[str, Dict[str, Any]] = {
    "fused_rnn": {
        "version": 1,
        "target": TARGET,
        "blocks": [8, 16, 32, 64],
        "plan": "row_tile",
    },
    "decode_route": {
        "version": 1,
        "target": TARGET,
        "routes": ["kernel"],
        "splits": [1, 2, 4, 8, 16],
        "plan": "splits",
    },
    "page_block": {
        "version": 1,
        "target": TARGET,
        "blocks": [16, 32, 64, 128],
    },
    "fusion": {
        "version": 1,
        "target": TARGET,
        "kinds": ["elementwise_chain", "producer_consumer"],
        "plan": "fuse",
    },
    "bucket_grid": {
        "version": 1,
        "target": TARGET,
        "kinds": ["prompt", "cache"],
        "grids": {
            "prompt": [[32, 64, 128, 256, 512], [64, 128, 256, 512],
                       [64, 256, 512], [128, 256, 512],
                       [32, 64, 128, 256], [256, 512]],
            "cache": [[128, 256, 512, 1024], [256, 512, 1024],
                      [256, 1024], [512, 1024]],
        },
    },
}

SPACE_NAMES = tuple(sorted(SPACE_DEFS))


def _hash_def(name: str) -> str:
    blob = json.dumps({"space": name, "def": SPACE_DEFS[name]},
                      sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


#: digests computed once at import: consults run on every launch's route
_SPACE_HASHES: Dict[str, str] = {n: _hash_def(n) for n in SPACE_DEFS}


def space_hash(name: str) -> str:
    """Stable digest of one plan space's candidate-set definition."""
    return _SPACE_HASHES[name]


def fused_family(*, gates: int, T: int, H: int, batch: int) -> str:
    """The fused-RNN shape-family key — exact (gates, T, H, B), as JAX's:
    lookups never interpolate across shapes."""
    return f"g{gates}_t{T}_h{H}_b{batch}"


#: the forward kernel of each gate count (the default of
#: :func:`fused_candidates`)
_FORWARD = {4: "lstm_seq_train", 3: "gru_seq"}

Plan = Union[str, int]


def fused_candidates(*, T: int, H: int, gates: int, batch: int,
                     kernel: Optional[str] = None, dtype=None,
                     limits: Optional[Tuple[int, int]] = None
                     ) -> List[Plan]:
    """Every legal row tile of one fused-RNN family: ``"whole"`` where the
    batch's grid is resident, then each tile b of ``blocks`` below the
    batch whose grid is (``ops.rnn_kernels.tile_route``). ``kernel`` is a
    ``LAUNCHES`` name of ops/rnn_kernels.py (default: the forward of the
    gate count); ``limits`` (SMs, shared memory a block) default to an
    H100's. ``T`` names the family only: the kernels walk T whole."""
    import torch

    from ..ops import rnn_kernels as rk
    kernel = kernel or _FORWARD[gates]
    dtype = dtype or torch.float32
    lim = limits or rk.H100
    out: List[Plan] = []
    if rk.tile_route(kernel, batch, H, batch, dtype, *lim) is not None:
        out.append("whole")
    for b in SPACE_DEFS["fused_rnn"]["blocks"]:
        if b < batch and rk.tile_route(kernel, batch, H, b, dtype,
                                       *lim) is not None:
            out.append(b)
    return out


def route_of(plan: Plan, *, kernel: str, H: int, batch: int, dtype=None,
             limits: Optional[Tuple[int, int]] = None):
    """The ``ops.rnn_kernels.Route`` of one cached row-tile plan, or None
    where the plan is malformed or not resident on ``limits``."""
    import torch

    from ..ops import rnn_kernels as rk
    if plan == "whole":
        tile = batch
    elif isinstance(plan, int) and not isinstance(plan, bool) and plan > 0:
        tile = plan
    else:
        return None
    return rk.tile_route(kernel, batch, H, tile, dtype or torch.float32,
                         *(limits or rk.H100))


def decode_family(bh: int, L: int) -> str:
    """The ``splits`` key of one decode read: (sample, head) pairs and the
    read's rows."""
    return f"{bh}x{L}"


#: measurement profiles: which families/lengths the driver sweeps.
#: ``smoke`` is the seconds-long check; ``cpu`` the default off-card
#: profile (proxy dims for the plain versions); ``bench`` the card's, at
#: the flagship shapes: the LSTM text classifier (T 100, B 64, H 256; and
#: H 512), the NMT encoder GRU (T 32, B 64, H 512), GPT-2 small's decode
#: (B 8, 12 heads of 64).
PROFILES: Dict[str, Dict[str, Any]] = {
    "smoke": {
        "reps": 1,
        "fused_families": [
            {"gates": 4, "T": 8, "H": 8, "batch": 16, "note": "smoke"},
        ],
        "decode": {"lengths": [32, 64], "batch": 2, "n_heads": 2,
                   "d_head": 8, "note": "smoke"},
        "page_block": {"read_pages": 4, "batch": 2, "n_heads": 2,
                       "d_head": 8, "blocks": [16, 32], "note": "smoke"},
        "fusion": {"batch": 8, "width": 16, "depth": 2, "note": "smoke"},
        "bucket_grid": {"batch": 2, "d_model": 16, "max_len": 128,
                        "samples": 16, "zipf_a": 1.2, "note": "smoke"},
    },
    "cpu": {
        "reps": 2,
        "fused_families": [
            {"gates": 4, "T": 16, "H": 32, "batch": 16,
             "note": "textcls proxy"},
            {"gates": 3, "T": 16, "H": 32, "batch": 16,
             "note": "nmt-encoder proxy"},
        ],
        "decode": {"lengths": [64, 128, 256], "batch": 4, "n_heads": 4,
                   "d_head": 8, "note": "serving-dims proxy"},
        "page_block": {"read_pages": 8, "batch": 4, "n_heads": 4,
                       "d_head": 8, "blocks": [16, 32, 64],
                       "note": "serving-dims proxy"},
        "fusion": {"batch": 32, "width": 64, "depth": 3,
                   "note": "mlp proxy"},
        "bucket_grid": {"batch": 4, "d_model": 64, "max_len": 512,
                        "samples": 48, "zipf_a": 1.2,
                        "note": "serving-dims proxy"},
    },
    "bench": {
        "reps": 3,
        "fused_families": [
            {"gates": 4, "T": 100, "H": 256, "batch": 64,
             "note": "textcls h256"},
            {"gates": 4, "T": 100, "H": 512, "batch": 64,
             "note": "textcls h512"},
            {"gates": 3, "T": 32, "H": 512, "batch": 64,
             "note": "nmt encoder"},
        ],
        "decode": {"lengths": [256, 512, 1024], "batch": 8, "n_heads": 12,
                   "d_head": 64, "note": "gpt2s decode"},
        "page_block": {"read_pages": 16, "batch": 8, "n_heads": 12,
                       "d_head": 64, "blocks": [16, 32, 64, 128],
                       "note": "gpt2s decode"},
        "fusion": {"batch": 256, "width": 256, "depth": 4,
                   "note": "mlp bench dims"},
        "bucket_grid": {"batch": 8, "d_model": 768, "max_len": 1024,
                        "samples": 96, "zipf_a": 1.2,
                        "note": "gpt2s serving"},
    },
}
