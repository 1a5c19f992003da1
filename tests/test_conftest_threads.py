"""The thread share that the root conftest.py gives each pytest-xdist worker."""
import os
import subprocess
import sys

import torch


def test_torch_pool_is_the_process_share_of_the_cpus():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        # a plain run keeps torch's own default: the pool a fresh interpreter
        # gets in this environment
        out = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
            capture_output=True, text=True, check=True, timeout=300)
        expected = int(out.stdout)
    else:
        share = max(1, len(os.sched_getaffinity(0)) // int(workers))
        # torch takes MKL_NUM_THREADS over OMP_NUM_THREADS; either, exported by
        # the caller, wins over the share
        expected = int(os.environ.get("MKL_NUM_THREADS")
                       or os.environ.get("OMP_NUM_THREADS") or share)
    assert torch.get_num_threads() == expected
