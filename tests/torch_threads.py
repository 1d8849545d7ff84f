"""One intra-op thread for the port's tests (`one_thread`, an autouse
fixture each tests/test_torch_*.py file imports).

The suite runs its files in parallel worker processes (`-n 6 --dist
loadfile`), and torch's default of one intra-op thread per core in each of
them oversubscribes the CPU many times over: at tiny widths the threads
spend their time waiting on each other. A `vqa_mplug` run at tiny widths
took 7.4 s at 8 threads and 2.4 s at 1 beside a loaded suite, and eight of
the port's files 1480 s of worker time against 350. The fixture sets one
thread for each port test module and gives the worker's count back after
it, so the JAX package's own test files run as they always did.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
