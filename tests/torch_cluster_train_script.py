"""Worker script of the port's cluster_train test: joins the job through
``multihost.initialize()`` (PADDLE_TPU_* from the launcher), trains a toy
data-parallel model over the world's mesh on the CPU (gloo), and checks
that the job really is multi-process. torch only (tests/torch_cluster.py
holds the model and data the three worker scripts share)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from torch_cluster import dp_step_fn, finish  # noqa: E402
from paddle_tpu_torch.parallel import multihost  # noqa: E402


def main():
    info = multihost.initialize(backend="gloo")
    assert info["process_count"] == int(os.environ["PADDLE_TPU_NUM_PROCESSES"])
    assert info["process_count"] > 1
    mesh = multihost.global_mesh(data=info["global_devices"], device="cpu")
    dp, params, opt_state = dp_step_fn(mesh)
    rs = np.random.RandomState(0)
    GB = 16
    X = rs.randn(GB, 4).astype(np.float32)
    Y = rs.randint(0, 2, GB).astype(np.int32)
    sl = multihost.process_batch_slice(GB)
    bx, by = multihost.make_global_batch(mesh, (X[sl], Y[sl]))
    l0 = None
    for i in range(5):
        params, opt_state, l = dp.step(params, opt_state, bx, by)
        if i == 0:
            l0 = float(l)
    assert float(l) < l0
    print(f"worker {info['process_index']} OK", flush=True)
    finish()


if __name__ == "__main__":
    main()
