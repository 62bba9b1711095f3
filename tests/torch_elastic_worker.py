"""Subprocess elastic worker of the port — the torch copy of
``tests/elastic_worker_script.py``.

Usage: python torch_elastic_worker.py HOST PORT WORKER_ID [MAX_SECONDS]
       [--workload testnet|flagship] [--device DEVICE]

Joins the elastic master at HOST:PORT under a heartbeat lease, serves
shard-gradient tasks until the master reports the job done, then leaves
and exits 0. A worker the caller SIGKILLs mid-pass never reaches the
leave: its eviction and the re-bucketing of its shard are what the
caller checks. torch only (the tests' chaos runs and ``chip_smoke.py``
phase 24 start it).
"""

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("host")
    ap.add_argument("port", type=int)
    ap.add_argument("worker")
    ap.add_argument("max_seconds", type=float, nargs="?", default=120.0)
    ap.add_argument("--workload", default="testnet")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    import torch
    torch.set_num_threads(1)
    from torch_elastic_net import WORKLOADS
    from paddle_tpu_torch.trainer.elastic import ElasticWorker

    worker = ElasticWorker(WORKLOADS[args.workload](),
                           (args.host, args.port), worker=args.worker,
                           device=args.device)
    summary = worker.run(max_seconds=args.max_seconds)
    print("WORKER_DONE", summary["worker"], summary["shards"], flush=True)
    sys.exit(0 if summary["done"] else 2)


if __name__ == "__main__":
    main()
