"""Thread share of each pytest-xdist worker.  pytest imports this file before
tests/conftest.py and before the tests load numpy or torch.

Without it every worker starts torch's default OpenMP pool, one spinning thread
per CPU, and six workers on eight CPUs run 48 threads.  A worker sees
PYTEST_XDIST_WORKER_COUNT (the controller and a plain run do not) and sizes its
pool to its share of the CPUs it may use.  A value the caller exported wins:
torch sizes its pool from MKL_NUM_THREADS when that is set, so MKL follows an
exported OMP_NUM_THREADS.
"""
import os
import sys

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _share = max(1, len(os.sched_getaffinity(0))
                 // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    os.environ.setdefault("OMP_NUM_THREADS", str(_share))
    os.environ.setdefault("MKL_NUM_THREADS", os.environ["OMP_NUM_THREADS"])


def pytest_configure(config):
    torch = sys.modules.get("torch")
    if torch is not None and "PYTEST_XDIST_WORKER_COUNT" in os.environ:
        # a plugin imported torch before the variables were set
        torch.set_num_threads(int(os.environ["MKL_NUM_THREADS"]))
