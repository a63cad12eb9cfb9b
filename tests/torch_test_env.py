"""Imported first by every port test file (``tests/test_torch_*.py``):
one intra-op thread for torch in each test process.

The suite runs in several worker processes at once, and torch's default
(an intra-op thread for every core, in every process) oversubscribes
the host many times over: the workers' threads then spend their time
waiting on one another. One thread a process keeps every worker busy.
No result depends on it: every comparison in the port's tests holds at
any thread count."""
import torch

torch.set_num_threads(1)
