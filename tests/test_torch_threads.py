"""Intra-op threads of torch in a test worker, for the port's CPU tests.

Every tests/test_torch_port_*.py file imports `torch_worker_threads` from
here, first: an autouse fixture that, under pytest-xdist
(PYTEST_XDIST_WORKER_COUNT set), runs the module's tests with the worker's
share of the host's CPUs as torch's intra-op threads, at least one, and
restores the count after. Torch's default, one OpenMP thread per CPU in
every worker, starts six times as many threads as there are CPUs under six
workers, and their spinning slows small torch ops by more than 50x. A
module that runs a large convolution on the CPU may ask for more threads
with a module-level `TORCH_THREADS`. A run in one process keeps torch's
default.
"""
import os

import pytest
import torch


def worker_threads(env=os.environ, cpus: int | None = None) -> int | None:
    """Intra-op threads for one of env's xdist workers on `cpus` CPUs (the
    ones this process may run on), or None outside xdist."""
    workers = env.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    cpus = cpus or len(os.sched_getaffinity(0))
    return max(1, cpus // int(workers))


@pytest.fixture(autouse=True, scope="module")
def torch_worker_threads(request):
    threads = worker_threads()
    if threads is None:
        yield None
        return
    threads = getattr(request.module, "TORCH_THREADS", threads)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    yield threads
    torch.set_num_threads(before)


def test_worker_threads_share_the_cpus(torch_worker_threads):
    assert worker_threads({}, 8) is None
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8) == 1
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8) == 4
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "16"}, 8) == 1
    if torch_worker_threads is not None:
        assert torch.get_num_threads() == torch_worker_threads
