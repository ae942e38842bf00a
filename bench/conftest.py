"""The benchmark's CPU tests run the cells at their tiny sizes, whose ops
take microseconds. Under parallel test workers, each op's intra-op
threads would wait on cores the other workers hold, and those waits, not
the work, would set the tests' time: each test runs on one thread."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
