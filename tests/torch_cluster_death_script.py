"""Worker script of the port's host-death test: 2 workers join one job
and run real collective steps (gloo, on the CPU); then rank 1 SIGKILLs
itself (a machine lost). Rank 0 waits as for its next input; the
launcher must see the death and SIGTERM rank 0, whose multihost teardown
handler writes the ``clean-exit-<rank>`` marker (standing for a final
checkpoint) before it exits with TEARDOWN_EXIT_CODE. torch only."""

import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from paddle_tpu_torch.parallel import multihost  # noqa: E402

torch.set_num_threads(1)


def main():
    info = multihost.initialize(backend="gloo")
    rank = info["process_index"]
    out_dir = os.environ["DEATH_TEST_DIR"]

    def write_marker():
        with open(os.path.join(out_dir, f"clean-exit-{rank}"), "w") as f:
            f.write("checkpointed\n")

    multihost.on_job_teardown(write_marker)
    import torch.distributed as dist
    for _ in range(3):                   # coupled steps while both live
        x = torch.full((4,), float(rank + 1))
        dist.all_reduce(x)
        assert float(x.sum()) > 0

    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)   # the machine loses power

    # the survivor waits for its next input chunk; the launcher's SIGTERM
    # must end this through the teardown hook
    for _ in range(600):
        time.sleep(0.1)
    print("survivor was never torn down", flush=True)
    sys.exit(5)


if __name__ == "__main__":
    main()
