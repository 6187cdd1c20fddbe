"""One ATen thread per test, for the port's CPU-heavy test files.

The tier-1 run spreads the test files over six workers that share the
machine's cores. A test whose many small float64 and f32 products each
fan out over every core makes the workers contend: each of the heaviest
files ran 2-2.5x slower beside the others than alone. One thread a test
keeps a worker to about one core. Import ``one_torch_thread`` into a test
file to apply it there (autouse)."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
