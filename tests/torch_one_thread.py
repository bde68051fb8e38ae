"""The port's CPU test files run PyTorch on one thread.

The tier-1 run starts several pytest workers on one host, and PyTorch
takes a thread per core in each: the workers then oversubscribe the
cores, and a test of the plain versions (indexing, scatters, long
chains of small operations) runs many times slower than on one thread.
The plain versions' results do not depend on the thread count; a CPU
BLAS product's do (its order of adds follows the threads), so a test
that holds such a product to a bound runs it under
:func:`default_threads`.  A test file takes the fixture below by
importing it::

    from torch_one_thread import one_thread  # noqa: F401  (autouse)
"""

import contextlib

import pytest
import torch

_DEFAULT = [torch.get_num_threads()]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread for the module's tests; the count restored after."""
    _DEFAULT[0] = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(_DEFAULT[0])


@contextlib.contextmanager
def default_threads():
    """PyTorch on the thread count it had before :func:`one_thread`, within
    the block."""
    threads = torch.get_num_threads()
    torch.set_num_threads(_DEFAULT[0])
    try:
        yield
    finally:
        torch.set_num_threads(threads)
