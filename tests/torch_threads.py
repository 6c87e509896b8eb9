"""One intra-op thread per test process, for the port's tests
(``tests/test_torch_*.py``, each of which imports this module): the suite
runs in several worker processes at once, and torch's default pool of a
thread per core in each of them stalls the CPU harness tests many times
over."""

import torch

torch.set_num_threads(1)
