#!/usr/bin/env python3
"""Where the BiLSTM-CRF tagger's training step spends its device time, on
one card.

    python3 tools/tagger_step_profile.py

Builds the kernels, trains chip_smoke.py's tagger (phase 16: vocab 30000,
embed 128, hidden 256 a direction, 9 tags, batch 64, padded length 100,
lengths 30..100, f32, Adam 2e-3) three warm steps through the trainer's
graph, then profiles one step with ``torch.profiler`` in a fresh profiler
session, graphed and eager, and prints the device time a step, the
kernels by device time, and the share of the LSTM kernels (#9, the
training forward ``lstm_seq_kernel``; #10, ``lstm_seq_bwd_kernel``)
against the rest (the CRF's 99-step forward and backward loops, the
embedding, the projections and Adam). Last line: a JSON summary. The
smoke's own profiles, taken after many earlier profiler sessions in one
process, can miss the first kernels of a step; this script runs alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tagger_step_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.core import SeqBatch, graphs
    from paddle_tpu_torch.models import BiLSTMCRFTagger
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    card = cs.card_line()
    model = BiLSTMCRFTagger(**cs.TAGGER).init(0, "cuda")
    rs = np.random.RandomState(16)
    B, T = cs.TEXTCLS_BATCH, cs.TEXTCLS_LEN
    batch = tuple(torch.as_tensor(a.astype(np.int32), device="cuda") for a in (
        rs.randint(0, cs.TAGGER["vocab_size"], (B, T)),
        rs.randint(cs.TEXTCLS_MIN_LEN, T + 1, B),
        rs.randint(0, cs.TAGGER["num_tags"], (B, T))))
    tr = Trainer(lambda p, d, n, t: model.call(p, SeqBatch(d, n), t,
                                               method="loss"),
                 Adam(cs.ZOO_LR), device="cuda")
    state = {"p": model.tree()}
    state["s"] = tr.opt.init(state["p"])

    def step():
        state["p"], state["s"], c = tr.step(state["p"], state["s"], *batch)
        return c

    summary = {"card": card}
    for route in ("graphed", "eager"):
        with (graphs.disabled() if route == "eager"
              else contextlib.nullcontext()):
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            rows, _ = cs.device_rows(step)
        total = sum(r[0] for r in rows)
        lstm = {k: sum(r[0] for r in rows if k in r[2])
                for k in ("lstm_seq_kernel", "lstm_seq_bwd_kernel")}
        print(f"== {route}: device {total / 1e3:.4f} ms a step, "
              f"{sum(r[1] for r in rows)} kernels | {card}")
        for us, n, name in sorted(rows, reverse=True)[:12]:
            print(f"{us / 1e3:9.4f} ms x{n:<5d} {name[:110]}")
        summary[route] = {
            "device_ms_per_step": total / 1e3,
            "kernels_per_step": sum(r[1] for r in rows),
            "lstm_fwd_ms": lstm["lstm_seq_kernel"] / 1e3,
            "lstm_bwd_ms": lstm["lstm_seq_bwd_kernel"] / 1e3,
            "lstm_share": sum(lstm.values()) / total}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
