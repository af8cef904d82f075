"""Torch's intra-op threads in the port's tests.

The tier-1 run gives each of its pytest-xdist workers every core: six
workers, each with torch's eight OpenMP threads beside XLA's, on eight
cores. OpenMP's threads spin while they wait for one another, so a forward
that takes about 4 s alone took 518 s in each of six concurrent copies
(test_torch_compiled.py's yolofastest-D case, measured on an 8-core
machine; 4 s each with one thread apiece). Every port test file calls
cap_threads() where it imports torch: under xdist each worker takes its
share of the cores, run alone a file keeps torch's default. Nothing the
tests compute depends on the thread count.
"""

import os

import pytest

torch = pytest.importorskip("torch")


def thread_share(cores: int, workers: int) -> int:
    return max(1, cores // max(1, workers))


def cap_threads() -> None:
    """Torch's intra-op threads: the cores over the xdist workers
    (PYTEST_XDIST_WORKER_COUNT, set in each worker), or unchanged alone."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(thread_share(len(os.sched_getaffinity(0)), int(workers)))


cap_threads()


@pytest.mark.parametrize("cores,workers,share", [(8, 6, 1), (8, 2, 4), (8, 1, 8), (2, 6, 1)])
def test_workers_share_the_cores(cores, workers, share):
    assert thread_share(cores, workers) == share


def test_a_worker_takes_its_share(monkeypatch):
    before = torch.get_num_threads()
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(len(os.sched_getaffinity(0))))
        cap_threads()
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(before)
