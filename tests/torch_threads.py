"""One torch thread for a port test module.

The tier-1 command (ROADMAP.md) runs the tests in six pytest-xdist
workers. On eight torch
threads each, the workers' small CPU ops contend for the cores and run
several times slower (tests/test_torch_samples.py: 425 s on eight, ~20 s
on one). Every port test file imports `one_torch_thread` from here, which
makes it autouse there: module-scoped, it sets one thread and restores
the count afterwards.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
