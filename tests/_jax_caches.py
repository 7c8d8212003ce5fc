"""A module-scoped fixture for the port's parity test files, which run the
JAX reference beside the port in one process.

Every compiled XLA CPU program that JAX keeps cached holds about three
memory maps, and a pytest-xdist worker runs many JAX-heavy test files in
one process: past the kernel's ``vm.max_map_count`` (65530 by default)
the next XLA compile crashes the worker with a segmentation fault, and
xdist's per-file scheduling then waits on the lost files until the run's
time limit.  Dropping the caches when a parity module ends returns the
maps of every program no longer in use, its own and those of the files
the worker ran before it."""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def release_jax_caches():
    yield
    jax.clear_caches()
