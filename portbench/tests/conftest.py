"""The harness's CPU tests work at small sizes: one intra-op thread per
test process keeps the pytest-xdist workers from crowding the cores."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    torch.set_num_threads(1)
    yield
