"""The port's CPU tests run torch on one thread a process.

The plain versions that these tests run work on small tensors, where
torch's intra-op pool gains nothing, and ``pytest -n`` already runs one
process a core.  There the pool's OpenMP threads, which spin between ops,
only take the cores from the other processes and from the CUDA mock's
block threads: on an 8-core host, six ``test_torch_*`` files of the heavy
kind ran under ``-n 6`` in 1,302 s of summed test time on one thread a
process against 3,659 s on torch's default of eight.  Each
``tests/test_torch_*.py`` that runs on the CPU calls :func:`one_thread`
when it is imported (the card's tests, ``test_torch_cuda.py``, do not).
"""

import torch


def one_thread() -> None:
    """One torch intra-op thread for this process."""
    torch.set_num_threads(1)
