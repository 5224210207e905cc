"""Fixtures shared by the port's tests; a test module imports the ones it
wants into its namespace."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Small shapes: two torch threads.  Under the suite's parallel workers
    (more threads than cores) OpenMP regions of many threads wait on each
    other; a detection file then took ten times its time alone, and the
    model files 10 to 28 times theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
