"""One intra-op thread for torch in the port's CPU tests.

The eager solvers make hundreds of small tensor operations a step; on
tensors of a few thousand entries torch's intra-op thread pool costs far
more than it gains (one elementwise pass over [1024, 35] took 20 ms with 8
threads and 0.13 ms with one), and under pytest-xdist every worker would
start a pool of its own. Every tests/test_torch_*.py imports this module
before its tests run; the package itself keeps torch's default.
"""

import torch

torch.set_num_threads(1)
