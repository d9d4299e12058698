"""One torch intra-op thread for a test module of the port.

Import the fixture into a test module to use it there::

    from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

The port's CPU tests run many small ops.  With torch's default of one
OpenMP thread per core, every op is a parallel region whose threads spin
at its barrier, and under ``pytest -n 6`` six workers' regions share the
cores: an op then waits for descheduled threads, and a file that takes
seconds in one process takes minutes.  One thread per worker has no such
barrier; results are those of a single-threaded run.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
