"""One intra-op torch thread per port test file.

Under ``pytest -n 6 --dist loadfile`` each file runs in a worker of its own,
six beside one another on a machine of a few cores. A worker whose torch
calls each start a thread per core oversubscribes them, and the small cases
of these files then wait on one another (a gradcheck of the center kernels'
plain versions took 280-360 s in the suite). Each ``tests/test_torch_*.py``
imports :func:`one_thread`. numpy's BLAS keeps its threads: the CG blocks
that ``lib/wigner.py`` caches per process come from its SVDs, whose last
bits depend on the BLAS thread count, and ``test_torch_cg_blocks.py``
compares the header they render byte for byte.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
