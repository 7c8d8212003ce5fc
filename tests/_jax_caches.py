"""Module-scoped fixtures for the port's parity test files, which run the
JAX reference beside the port in one process.

``release_jax_caches``: every compiled XLA CPU program that JAX keeps
cached holds about three memory maps, and a pytest-xdist worker runs
many JAX-heavy test files in one process: past the kernel's
``vm.max_map_count`` (65530 by default) the next XLA compile crashes the
worker with a segmentation fault, and xdist's per-file scheduling then
waits on the lost files until the run's time limit.  Dropping the caches
when a parity module ends returns the maps of every program no longer in
use, its own and those of the files the worker ran before it.

``one_torch_thread``: one torch intra-op thread while a parity module
runs.  The suite runs several workers on the machine's cores, and a
torch thread pool per worker oversubscribes them (measured on one file:
237 s with the default pool, 67 s on one thread); the port's small
reduced-width calls gain little from more threads.

``once_per_run``: a module fixture's value computed once for the whole
run rather than once for each pytest-xdist worker that runs a test of
the module."""
import fcntl
import os

import jax
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def release_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def once_per_run(tmp_path_factory, name, compute):
    """``compute()``, once for the whole test run.  Under pytest-xdist
    every worker that runs a test of a module builds that module's
    fixtures again, and the mesh files' fixtures start worlds of rank
    processes: several workers building them at once crowd the machine's
    cores.  The first worker to need ``name`` computes it under a lock in
    the run's shared temporary directory and saves it there; the others
    wait for it and load it.  Without xdist it is ``compute()``."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pt"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return torch.load(path, weights_only=False)
            value = compute()
            torch.save(value, root / f"{name}.pt.part")
            os.replace(root / f"{name}.pt.part", path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
