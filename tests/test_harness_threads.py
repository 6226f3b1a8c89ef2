"""The test harness's thread cap (the root conftest.py): each test process, and
each process a test starts, takes its share of the CPU's cores, or the count
exported before pytest."""

import os
import subprocess
import sys

import torch


def _cap(exported):
    """A count exported before pytest is kept (a torch built with MKL takes
    MKL's over OpenMP's); else the cores divided among xdist's workers."""
    var = "OMP_NUM_THREADS"
    if torch.backends.mkl.is_available() and exported["MKL_NUM_THREADS"]:
        var = "MKL_NUM_THREADS"
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return int(exported[var] or max(1, os.cpu_count() // workers))


def test_this_process_takes_its_share_of_the_cores(exported_threads):
    assert torch.get_num_threads() == _cap(exported_threads)


def test_a_child_process_inherits_the_cap(exported_threads):
    r = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) == _cap(exported_threads)
