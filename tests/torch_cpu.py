"""One intra-op thread for PyTorch in the port's CPU tests.

The suite runs in several worker processes at once (``-n 6``), each of
which would otherwise start an intra-op pool as wide as the host. The
port's reduced models run many small ops, and with the workers' pools
oversubscribing the cores every parallel op waits on threads that are
not running: on an 8-core host, a lockstep serving test whose torch part
takes 1.4 s alone took 120 s beside five copies of itself, and 5.6 s with
one thread each. Importing this module (every ``tests/test_torch_*.py``
does, first) sets the thread count for its process; it changes no input,
check or tolerance.
"""

import torch

torch.set_num_threads(1)
