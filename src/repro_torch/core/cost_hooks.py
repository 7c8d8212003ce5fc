"""The hooks by which the dry run's cost counter
(``launch.op_cost.OpCounter``) sees the model's loops, kept below the
model so that the model imports nothing of ``launch/``.

A loop whose iterations have the same shapes (a layer stack of one
kind, the microbatches, the flash tiles) iterates over :func:`trips`:
``range(n)`` unless a weighting counter is active, which then runs two
iterations and weights the second (``OpCounter._weighted_trips``).  Its
per-iteration results go through :func:`fill_skipped`.  A form that is
right only on the counter's stand-ins calls :func:`stand_ins_only`.
"""
from __future__ import annotations

from typing import Iterable

import torch


def active_counter():
    """The cost counter this thread runs under (a ``FakeTensorMode``
    whose class sets ``counts_cost``), or None."""
    mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    return mode if getattr(mode, "counts_cost", False) else None


def stand_ins_only(what: str):
    """The active counter; raises when there is none: ``what`` is a dry
    run's form, which costs a step on stand-ins but would compute wrong
    values on real DTensors (the serving engine's real mesh runs on
    local shards instead, ``core/tp.py``)."""
    c = active_counter()
    if c is None:
        raise RuntimeError(f"{what} is the dry run's form for stand-in "
                           "tensors; it ran outside its cost counter")
    return c


def trips(n: int, heavy_first: bool = False) -> Iterable[int]:
    """The indices of a loop of ``n`` iterations of the same shapes:
    ``range(n)``, or under a weighting counter iterations 0 and 1, at
    weights 1 and n - 1 (``heavy_first``: n - 1 and 1).

    Which runs first matters where iterations differ in what autograd
    does with them.  A loop that reads one shared leaf in every
    iteration (a layer stack's stacked ``[L, ...]`` parameters) takes
    ``heavy_first``: the backward sums the leaf's n gradients with n - 1
    adds, run under the node of the use it reaches last, the first in
    forward order.  A loop whose first iteration starts a carry that
    later ones add to (gradient accumulation over microbatches) runs
    the light iteration first."""
    c = active_counter()
    if c is None or not c.weighted or n <= 2:
        return range(n)
    return c._weighted_trips(n, heavy_first)


def fill_skipped(items: list) -> list:
    """A loop's per-iteration results (a list indexed by iteration),
    with each iteration that :func:`trips` skipped (None) taking the
    first result: same shapes, one storage.  The full loop's list
    comes back unchanged."""
    if all(x is not None for x in items):
        return items
    first = next(x for x in items if x is not None)
    return [first if x is None else x for x in items]
