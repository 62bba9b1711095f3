"""Worker script of the port's elastic-restart test: 2 workers train the
toy data-parallel model of tests/torch_cluster.py for 3 passes on the CPU
(gloo), rank 0 checkpointing the parameters after each pass. On attempt 0
rank 1 SIGKILLs itself once the pass-1 checkpoint has landed (a machine
lost mid-job); the launcher's --restart-on-failure relaunches both, which
resume from the latest checkpoint and finish. Rank 0 writes final.npz,
which the test compares with an uninterrupted run of this script alone
(no PADDLE_TPU_COORDINATOR: a world of one rank of its own). torch only."""

import os
import signal
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from torch_cluster import dp_step_fn, finish, host  # noqa: E402
from paddle_tpu_torch.parallel import multihost  # noqa: E402

PASSES = 3
STEPS_PER_PASS = 2


def pass_batches(pass_idx):
    """The same data every attempt."""
    rs = np.random.RandomState(100 + pass_idx)
    GB = 16
    for _ in range(STEPS_PER_PASS):
        yield (rs.randn(GB, 4).astype(np.float32),
               rs.randint(0, 2, GB).astype(np.int32))


def latest_checkpoint(ckpt_dir):
    done = sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith("pass-") and f.endswith(".npz"))
    return os.path.join(ckpt_dir, done[-1]) if done else None


def _join():
    if os.environ.get("PADDLE_TPU_COORDINATOR"):
        return multihost.initialize(backend="gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo")


def main():
    info = _join()
    rank = info["process_index"]
    attempt = int(os.environ.get("PADDLE_TPU_RESTART_COUNT", "0"))
    ckpt_dir = os.environ["RESTART_TEST_DIR"]
    mesh = multihost.global_mesh(data=info["global_devices"], device="cpu")

    start_pass, start = 0, None
    ck = latest_checkpoint(ckpt_dir)
    if ck is not None:
        data = np.load(ck)
        start = {"fc": {"w": data["w"], "b": data["b"]}}
        start_pass = int(data["pass_idx"]) + 1
    dp, params, opt_state = dp_step_fn(mesh, start)

    for pass_idx in range(start_pass, PASSES):
        for X, Y in pass_batches(pass_idx):
            sl = multihost.process_batch_slice(len(X))
            bx, by = multihost.make_global_batch(mesh, (X[sl], Y[sl]))
            params, opt_state, _ = dp.step(params, opt_state, bx, by)
        if rank == 0:
            hp = host(params)
            tmp = os.path.join(ckpt_dir, f".pass-{pass_idx:05d}.tmp.npz")
            np.savez(tmp, w=hp["fc"]["w"], b=hp["fc"]["b"],
                     pass_idx=pass_idx)
            os.replace(tmp, os.path.join(ckpt_dir,
                                         f"pass-{pass_idx:05d}.npz"))
        if attempt == 0 and pass_idx == 1 and rank == 1:
            # wait until rank 0's pass-1 checkpoint is durable, then die
            target = os.path.join(ckpt_dir, "pass-00001.npz")
            deadline = time.time() + 60
            while not os.path.exists(target) and time.time() < deadline:
                time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGKILL)

    if rank == 0:
        hp = host(params)
        np.savez(os.path.join(ckpt_dir, "final.npz"),
                 w=hp["fc"]["w"], b=hp["fc"]["b"])
    print(f"worker {rank} attempt {attempt} done", flush=True)
    finish()


if __name__ == "__main__":
    main()
