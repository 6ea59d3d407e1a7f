"""The benchmark's own tests: tiny cells on the CPU; the tests marked
``card`` need a CUDA card and skip inside the test without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch

    # the tiny cells are a few small products a step: more threads than
    # this only contend with the other test workers
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips inside the test without)")
