"""Shared pieces of the benchmark's CPU tests: a tiny configuration and
library, a cache directory of their own, and the ``cuda`` marker's
fixture, which skips a card test where no card is present."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# an 80 kbp genome with 4 genes, 100 bp reads, gpu-full at 64-pair batches
TINY = {"library_pairs": 160,
        "genome": {"length": 80_000, "n_genes": 4, "dup_frac": 0.0,
                   "seed": 5},
        "reads": {"read_len": 100, "frag_len": [150, 350],
                  "err_rate": 0.005},
        "config": {"kmer": 20, "max_read_len": 100, "max_ed": 4,
                   "threads": 1},
        "pipeline": {"executor": "gpu-full", "batch_size": 64}}
ENRICHED = {"circ_frac": 0.2, "libraries": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on hosts without one")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    """The benchmark's cache directory, moved under the test's tmp."""
    from cmbench import inputs
    old = inputs.CACHE
    inputs.CACHE = str(tmp_path_factory.mktemp("cmbench_cache"))
    yield inputs.CACHE
    inputs.CACHE = old


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
