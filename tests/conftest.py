"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see the host's single
device; only launch/dryrun.py forces 512 placeholder devices."""
import os

import jax
import pytest

# the whole serving suite runs with the per-iteration block-pool audit on
# (refcounts, ownership, writable-block exclusivity — see
# ContinuousServingEngine._audit_pool); export REPRO_VALIDATE_POOL=0 to
# opt out when profiling test runtime
os.environ.setdefault("REPRO_VALIDATE_POOL", "1")


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel on an NVIDIA GPU; skips without one")
