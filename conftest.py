"""Test settings for the whole tree: each test process, and every process a
test starts, takes its share of the CPU's threads, and the longest test files
start first. (`tests/conftest.py` sets up JAX's virtual CPU devices.)"""

import collections
import contextlib
import os

import pytest

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
_EXPORTED = pytest.StashKey[dict]()


def pytest_configure(config):
    """Cap torch's, OpenMP's and the BLAS libraries' threads at this process's
    share of the cores before any test module imports torch: six workers that
    each take every core of eight spend their small ops in OpenMP barriers,
    waiting for descheduled threads, up to tens of times slower than on one
    thread. The processes tests start (the CLIs, torchrun ranks, `python -c`
    snippets) inherit the variables. A count exported before pytest is kept,
    and an exported OMP_NUM_THREADS sets the other two where they are not."""
    # xdist orders the files by pytest_collection_modifyitems below
    config.option.loadscopereorder = False
    if config.getoption("numprocesses", None) and "PYTEST_XDIST_WORKER" not in os.environ:
        return  # xdist's controller: it runs no test, and its workers inherit what it was given
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    share = max(1, os.cpu_count() // workers)
    config.stash[_EXPORTED] = {var: os.environ.get(var) for var in THREAD_VARS}
    threads = os.environ.setdefault("OMP_NUM_THREADS", str(share))
    for var in THREAD_VARS[1:]:
        os.environ.setdefault(var, threads)
    import torch

    # a torch built with MKL sizes its OpenMP pool by MKL's count, as a process
    # a test starts does
    var = "MKL_NUM_THREADS" if torch.backends.mkl.is_available() else "OMP_NUM_THREADS"
    torch.set_num_threads(int(os.environ[var]))
    # refused once inter-op work has run in this process
    with contextlib.suppress(RuntimeError):
        torch.set_num_interop_threads(int(os.environ[var]))


@pytest.fixture
def exported_threads(pytestconfig):
    """The thread variables as they were before pytest_configure set them."""
    return pytestconfig.stash[_EXPORTED]


# Test files of the JAX package that compile hundreds of small XLA programs one
# after another: 3-12 minutes of one core each, at any thread count. Under
# `--dist loadfile` a file runs on one worker, so a run waits on whichever of
# them starts last.
LONG_FILES = ("test_perf_paths.py", "test_budgets.py", "test_path_tracing.py", "test_remat.py")


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    """Order the files for xdist's workers: LONG_FILES first, then the others
    by their number of tests, as xdist would; a file's tests keep their order."""
    count = collections.Counter(item.path for item in items)
    items.sort(key=lambda item: (item.path.name not in LONG_FILES, -count[item.path]))
