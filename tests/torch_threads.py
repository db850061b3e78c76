"""The port's tests' share of the CPU's cores under pytest-xdist.

PyTorch sizes its intra-op (OpenMP) pool to every core of the machine in
each process.  Under ``-p xdist -n N`` the N workers then run N full pools
on the same cores, and OpenMP's spinning threads take the CPU from each
other: four concurrent runs of ``test_torch_gan_loop.py`` on an 8-core
machine took 310 s apiece with 8 threads each and 60 s with 2
(``OMP_NUM_THREADS``).

A test module that imports ``share_cores`` (an autouse fixture of module
scope) runs its tests and module fixtures at ``cores // N`` threads (at
least 1) inside an xdist worker, and at PyTorch's own number outside
xdist; the number is restored after the module.  Modules whose tolerances
were set at the default threads and do not hold at one thread
(``test_torch_flash_wide.py``: its embedding gradient) do not import it.
"""

import os

import pytest
import torch


def worker_threads() -> int:
    """This xdist worker's share of the cores, or PyTorch's current number
    of threads outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1 and os.environ.get("PYTEST_XDIST_WORKER"):
        return max(1, (os.cpu_count() or 1) // workers)
    return torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    before = torch.get_num_threads()
    torch.set_num_threads(worker_threads())
    yield
    torch.set_num_threads(before)
