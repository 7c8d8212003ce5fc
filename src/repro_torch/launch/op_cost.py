"""Dispatch-level cost counter of the port's dry run (the counterpart of
``repro.launch.hlo_cost``).

:class:`OpCounter` is a ``FakeTensorMode``: inside it every tensor is a
stand-in that holds no memory, and every ATen op that runs on a LOCAL
tensor passes through its ``__torch_dispatch__``.  Under DTensor the op
on the global DTensor is skipped and its local ops are counted, so every
count is PER DEVICE.  It counts:

* FLOPs: ``torch.utils.flop_counter``'s formulas (2·M·N·K a matrix
  product, the rule of ``hlo_cost.py``), so a count matches what
  ``FlopCounterMode`` reports for the same ops on a real card;
* bytes: operand plus result bytes of every op that moves data (views,
  metadata and uninitialised allocations move none; an indexed write
  into a buffer moves the written region).  Eager PyTorch fuses
  nothing, so this is the port's eager HBM traffic: an upper bound on
  what a fused program moves;
* collective bytes by kind: the result bytes of each functional
  collective (``_c10d_functional``) that DTensor issues, as
  ``hlo_cost.py`` counts a collective's result;
* kernels: the shape-only branches of the CUDA kernels' dispatchers
  (``kernels/shape_only.py``) add their calls, FLOPs and bytes by the
  kernel's own formula (:meth:`OpCounter.record_kernel`);
* memory: the live bytes of the stand-ins' storages, argument bytes
  (:meth:`OpCounter.track_args`) and the peak.

Trip counts (``hlo_cost.py`` multiplies while bodies by theirs): a loop
whose iterations have the same shapes (the layer stack of one kind, the
microbatches, the flash tiles, the SSD chunks) iterates over
``core.cost_hooks.trips``.  Outside a weighting counter that is
``range(n)``.  Inside one it runs iteration 0 at weight 1 and iteration
1, the steady state, at weight n - 1, so FLOPs, bytes and collectives come out as the
unrolled loop's.  Backward ops take the weight of the forward region
that made their autograd node (by the node's sequence number).  Memory:
in a layer stack (``heavy_first``) the heavy iteration's net growth of
live bytes (its stash) stands for each of the n - 2 iterations not run;
it is attached to the storages that iteration left alive and released
with them, and the region's peak is raised by it.  A carry loop's later
iterations replace their carry, so they add none.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# functional collectives -> the kind they are counted under
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no data: bookkeeping and uninitialised allocations
_FREE = {"detach", "alias", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "wait_tensor", "lift_fresh",
         "_wrap_tensor_autograd", "set_", "resize_", "_local_scalar_dense",
         "device", "layout", "dim", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_contiguous", "sym_is_contiguous",
         "record_stream"}
# indexed writes into a buffer: read the update, write its region
_INDEXED_WRITES = {"index_copy_", "index_copy", "index_put_", "index_put",
                   "_index_put_impl_", "scatter_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _indexed_write_bytes(name: str, args) -> int:
    """An indexed write's traffic: its indices read, its update read
    and written into the buffer's region (not the whole buffer)."""
    if name.startswith(("index_copy", "scatter")):   # (self, dim, index, src)
        idx, upd = args[2], args[3]
    else:                                            # (self, indices, values)
        idx, upd = args[1], args[2]
    nb = sum(_nbytes(t) for t in _tensors(idx))
    return nb + (2 * _nbytes(upd) if isinstance(upd, torch.Tensor) else 0)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Pause:
    def __init__(self, counter: "OpCounter"):
        self.counter = counter

    def __enter__(self):
        self.counter._paused += 1

    def __exit__(self, *exc):
        self.counter._paused -= 1


class _Region:
    __slots__ = ("weight", "extra", "live0", "max_live", "allocated",
                 "seq0")

    def __init__(self, weight: float, extra: int, live0: float):
        self.weight, self.extra = weight, extra
        self.live0 = self.max_live = live0
        self.allocated: List[weakref.ref] = []
        self.seq0 = None


class OpCounter(FakeTensorMode):
    """Counts the per-device cost of what runs inside it; see the module
    docstring.  ``weighted=False`` runs every loop in full (the tests
    hold the weighted counts to those)."""

    # what ``core.cost_hooks.active_counter`` looks for
    counts_cost = True

    def __init__(self, weighted: bool = True):
        super().__init__(allow_non_fake_inputs=False)
        self.weighted = weighted
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.kernel_calls: Dict[str, float] = defaultdict(float)
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.ops = 0.0
        self.live = 0.0
        self.peak = 0.0
        self.arg_bytes = 0.0
        self._size: Dict[int, float] = {}      # id(storage ref) -> bytes
        self._refs: Dict[int, weakref.ref] = {}
        self._regions: List[_Region] = []
        self._ranges: List[tuple] = []         # (seq0, seq1, weight)
        self._paused = 0
        self._depth = 0
        self._saved: List[tuple] = []
        self._entries = 0
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry

    # DTensor infers an op's global output shape by running the op once on
    # global-shaped fakes in the active fake mode (this one); those runs
    # are not the program's.  The methods of its propagator that do so
    # (their names differ between torch releases) run paused.
    _SHAPE_INFERENCE = ("_propagate_tensor_meta_non_cached",
                        "_propagate_tensor_meta")

    def __enter__(self):
        # a fake tensor re-enters its mode for each op run outside it:
        # patch on the outermost entry only
        self._entries += 1
        if self._entries > 1:
            return super().__enter__()
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._saved = []
        for name in self._SHAPE_INFERENCE:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue
            self._saved.append((name, orig))
            setattr(ShardingPropagator, name, self._paused_method(orig))
        if not self._saved:
            raise RuntimeError("this torch's DTensor has none of "
                               f"{self._SHAPE_INFERENCE}: the counter "
                               "cannot tell its shape inference apart")
        return super().__enter__()

    def __exit__(self, *exc):
        self._entries -= 1
        if self._entries == 0:
            from torch.distributed.tensor._sharding_prop import (
                ShardingPropagator)
            for name, orig in self._saved:
                setattr(ShardingPropagator, name, orig)
        return super().__exit__(*exc)

    def _paused_method(self, orig):
        counter = self

        def method(prop, *args, **kwargs):
            with counter.paused():
                return orig(prop, *args, **kwargs)
        return method

    # -- weights -----------------------------------------------------------

    def _weight(self) -> float:
        node = torch._C._current_autograd_node()
        if node is not None:
            # a backward op: the weights of the regions that made its
            # node, closed ones and those still open (a backward run
            # inside a weighted iteration, as gradient accumulation does)
            seq = node._sequence_nr()
            w = 1.0
            for s0, s1, rw in self._ranges:
                if s0 < seq < s1:
                    w *= rw
            for r in self._regions:
                if r.seq0 is not None and r.seq0 < seq:
                    w *= r.weight
            return w
        w = 1.0
        for r in self._regions:
            w *= r.weight
        return w

    def _seq_probe(self) -> Optional[int]:
        """The autograd sequence number a node made now would get."""
        if not torch.is_grad_enabled():
            return None
        self._paused += 1
        try:
            x = torch.empty((), requires_grad=True)
            return (x * 1.0).grad_fn._sequence_nr()
        finally:
            self._paused -= 1

    def _weighted_trips(self, n: int, heavy_first: bool):
        if not heavy_first:
            yield 0
        # memory: a layer stack (heavy first) keeps each iteration's
        # stash; a carry loop's later iterations replace their carry
        region = _Region(float(n - 1), n - 2 if heavy_first else 0,
                         self.live)
        region.seq0 = self._seq_probe()
        self._regions.append(region)
        try:
            yield 0 if heavy_first else 1
        finally:
            self._regions.pop()
            seq1 = self._seq_probe()
            if region.seq0 is not None and seq1 is not None:
                self._ranges.append((region.seq0, seq1, region.weight))
            self._close_region(region)
        if heavy_first:
            yield 1

    def _close_region(self, region: _Region) -> None:
        growth = self.live - region.live0
        kept = [r for r in region.allocated if r() is not None]
        kept_bytes = sum(self._size[id(r)] for r in kept)
        if growth > 0 and kept_bytes > 0:
            share = min(1.0, growth / kept_bytes) * region.extra
            for r in kept:
                add = self._size[id(r)] * share
                self._size[id(r)] += add
                self.live += add
        top = region.max_live + region.extra * max(growth, 0.0)
        self.peak = max(self.peak, top, self.live)
        for r in self._regions:
            r.max_live = max(r.max_live, top)

    def paused(self) -> "_Pause":
        """A reusable context: count nothing inside it (building the
        stand-in arguments, DTensor's shape inference)."""
        return _Pause(self)

    # -- memory ------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs and self._refs[key]() is st:
            return
        ref = weakref.ref(st, self._freed)
        self._refs[key] = ref
        self._size[id(ref)] = float(st.nbytes())
        self.live += st.nbytes()
        if self.live > self.peak:
            self.peak = self.live
        for r in self._regions:
            r.allocated.append(ref)
            if self.live > r.max_live:
                r.max_live = self.live

    def _freed(self, ref: weakref.ref) -> None:
        self.live -= self._size.pop(id(ref), 0.0)

    def track_args(self, *trees) -> float:
        """Count the storages of the step's arguments (DTensors by their
        local shards) as live, once each; returns their bytes."""
        before = self.live
        for t in _tensors(trees):
            self._track(_local(t))
        self.arg_bytes += self.live - before
        return self.live - before

    def fresh_bytes(self, tree) -> float:
        """Bytes of the storages in ``tree`` that the step allocated (its
        outputs not written into argument buffers)."""
        seen, total = set(), 0.0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        return total

    # -- counting ----------------------------------------------------------

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel, costed by its own formula
        (the dispatchers' shape-only branch)."""
        w = self._weight()
        self.kernel_calls[name] += w
        self.kernel_flops += w * flops
        self.kernel_bytes += w * nbytes
        self.flops += w * flops
        self.bytes += w * nbytes

    def record_collective(self, kind: str, nbytes: float) -> None:
        """A collective the port's own code stands for (a cross-device
        merge that no DTensor op issues)."""
        w = self._weight()
        self.collectives[kind] += w * nbytes
        self.bytes += w * nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # ops that the fake mode runs to implement an op (its
        # decompositions, meta functions) are not the program's
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or self._paused or self._depth:
            return out
        if any(t is not FakeTensor and t is not torch.Tensor for t in types):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if name in _FREE or func.is_view:
            return
        w = self._weight()
        self.ops += w
        ins = _tensors((args, kwargs))
        kind = (_COLLECTIVES.get(name)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None:
            nb = sum(_nbytes(t) for t in outs)
            self.collectives[kind] += w * nb
            self.bytes += w * nb
            return
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += w * self._flop_registry[packet](
                *args, **kwargs, out_val=out)
        if name in _INDEXED_WRITES:
            nb = _indexed_write_bytes(name, args)
        elif name == "copy_":
            nb = 2 * _nbytes(args[1])
        else:
            nb = (sum(_nbytes(t) for t in ins)
                  + sum(_nbytes(t) for t in outs))
        self.bytes += w * nb

    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def report(self) -> Dict:
        """The counts as plain numbers."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes(),
                "collectives": dict(self.collectives),
                "kernel_calls": dict(self.kernel_calls),
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "ops": self.ops}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t
