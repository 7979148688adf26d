"""One torch intra-op thread for the length of a test module.

A test module takes the fixture by importing it (``from
tests.torch_one_thread import one_thread``). Its ops are small, and
under the parallel test run (several workers on the machine's cores) a
pool of intra-op threads in every worker oversubscribes the cores: each
worker's torch ops then wait on each other's threads.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
