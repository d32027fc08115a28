"""The benchmark's tests import the program from ``src``, as ``bench.run``
does, so ``pytest bench`` runs on its own; and they run torch on one CPU
thread, as a run does (the tiny shapes take seconds on many threads that
share a loaded machine, and under a second on one)."""
import sys

import pytest
import torch

from bench.harness import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
