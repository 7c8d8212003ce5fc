"""The dry run's forms of what DTensor cannot follow op by op, or would
lay out otherwise than the reference's rules imply (``launch/dryrun.py``):
each runs on every device's local shards and states the collectives it
needs, so the counts are per device.  The model and the trainer call
them only on DTensors; a plain tensor never reaches them.  They sit
below the model (``core/``) so that the model imports nothing of
``launch/``, which builds the meshes and the rules that reach them.

* :func:`shard_as` — the hook of every sharding constraint (the
  reference's ``with_sharding_constraint``): a DTensor redistributed to
  a ``launch.sharding.NamedSharding``, anything else untouched.

* :func:`batch_only`, :func:`gather_fsdp` — a sublayer's input whole
  over all but the batch axes (sequence parallelism's all-gather), a
  layer's parameters gathered over the batch axes (FSDP; the backward's
  reduce-scatter is DTensor's).
* :func:`embed_sharded`, :func:`cross_entropy_sharded` — the
  vocab-parallel lookup and loss: no device holds the whole table, the
  whole [B, S, V] logits or their gradient.
* :func:`attend_sharded` — an attention core on batch and head shards;
  keys split along their sequence (a cross-attention cache) merge
  partials across the split.

Those two and :func:`moe_apply_sharded` cost the step but do not
compute it: a vocabulary or expert shard is indexed as if it began at
row 0, and split keys' partials are recorded, not merged.  They raise
outside the dry run's counter (``core.cost_hooks.stand_ins_only``), so a
real DTensor never gets their values.
* :func:`replicated_call` — a block whose heads or gates no split
  survives (the SSD mixer, the RG-LRU block), whole over the model axis.
* :func:`moe_apply_sharded` — the MoE block, whose dispatch (a sort, a
  cumulative count, indexed writes and gathers) has no sharding rule:
  per device over its batch shard, the experts split over the model
  axis by ``mlp`` (tensor parallelism) or by expert (expert
  parallelism), the output a ``Partial`` sum for the residual add.
* :func:`split_microbatches` — gradient accumulation's split: each
  microbatch takes its rows from every device's batch shard, so it is
  batch-sharded as a whole (the reference's ``microbatch_sharding``)
  and the split moves nothing.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.core.cost_hooks import stand_ins_only


def shard_as(x, sharding):
    """``x`` laid out as ``sharding`` (a ``launch.sharding.NamedSharding``
    or None): a DTensor is redistributed (the collectives this takes are
    DTensor's), its dims that the mesh axes do not divide replicated; a
    plain tensor, or no sharding, passes through untouched, so the
    single-card path keeps its bits."""
    if sharding is None or not hasattr(x, "redistribute"):
        return x
    pl = sharding.placements_for(tuple(x.shape))
    return x if tuple(x.placements) == pl else \
        x.redistribute(sharding.mesh, pl)


def moe_apply_sharded(p: dict, cfg, x, shardings, local_fn: Callable):
    """``models.moe.moe_apply`` on a DTensor ``x [B, T, d]``.  Each
    device routes the
    tokens of its batch shard, whole over the model axis (gathered there
    if the residual stream was sequence-sharded), over all experts.
    Tensor parallelism (``experts`` unsplit): the expert weights keep
    their ``mlp`` split over the model axis.  Expert parallelism
    (``experts`` over the model axis): each device keeps its experts
    whole and runs their dispatch rows only (``local_fn``'s
    ``experts``).  Either way any FSDP split is gathered, and a device's
    output is a partial sum over the model axis, handed back as a
    ``Partial`` DTensor for the residual add to reduce.  ``shardings``
    (the reference's dispatch-buffer constraints) need no action here:
    each device's buffers are its own.  Stand-ins only: an expert
    shard's dispatch rows are taken as experts [0, E/n)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    stand_ins_only("moe_apply_sharded")

    mesh = x.device_mesh
    x_pl = tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)
    xl = x.redistribute(mesh, x_pl).to_local()
    split_dim = {"w_gate": (0, 2), "w_up": (0, 2), "w_down": (0, 1)}
    partial = [False] * mesh.ndim
    experts = None
    local = {}
    for name, w in p.items():
        keep = split_dim.get(name, ())
        pl = tuple(q if any(q == Shard(k) for k in keep) else Replicate()
                   for q in w.placements)
        partial = [a or (q != Replicate() and keep != ())
                   for a, q in zip(partial, pl)]
        local[name] = w.redistribute(mesh, pl).to_local()
        if keep and any(q == Shard(0) for q in pl):
            e_local = local[name].shape[0]
            experts = (0, e_local)
    yl, aux = (local_fn(local, cfg, xl) if experts is None
               else local_fn(local, cfg, xl, experts))
    out_pl = tuple(Partial() if part else q for part, q in zip(partial, x_pl))
    y = DTensor.from_local(yl, mesh, out_pl, run_check=False,
                           shape=x.shape, stride=x.stride())
    # the router's losses and statistics, per device over its tokens,
    # wrapped so that the loss adds them as DTensors
    rep = (Replicate(),) * mesh.ndim
    return y, {k: DTensor.from_local(a, mesh, rep, run_check=False)
               for k, a in aux.items()}


def split_microbatches(x, m: int, sharding: Callable) -> List:
    """``x [B, ...]`` cut into ``m`` microbatches of B/m rows.  A DTensor
    is split on each device's shard (rows ``i`` of every shard's ``m``
    groups form microbatch ``i``), each wrapped in the layout of
    ``sharding(ndim)`` without its leading microbatch dim; a plain
    tensor by consecutive row groups, as the single-card step does."""
    b = x.shape[0]
    if not hasattr(x, "to_local"):
        return list(x.reshape(m, b // m, *x.shape[1:]))
    DTensor, Replicate, Shard = _dt()

    sh = sharding(x.dim() + 1)      # its leading microbatch dim unsplit
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in sh.placements)
    xl = x.to_local()
    shape = (b // m,) + tuple(x.shape[1:])
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return [DTensor.from_local(part, sh.mesh, pl, run_check=False,
                               shape=shape, stride=tuple(reversed(stride)))
            for part in xl.reshape(m, xl.shape[0] // m, *xl.shape[1:])]


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def _local_as(a, mesh, placements):
    """This device's shard of ``a`` laid out as ``placements``; a plain
    tensor counts as replicated (a mask or positions the step built
    whole), anything else passes through."""
    import torch
    DTensor, Replicate, Shard = _dt()
    if isinstance(a, torch.Tensor) and not hasattr(a, "device_mesh"):
        if a.dim() == 0:
            return a
        a = DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    if hasattr(a, "device_mesh"):
        return a.redistribute(mesh, placements).to_local()
    return a


def _dt():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def batch_only(x):
    """``x`` with only its batch split (dim 0) kept: gathered over every
    other mesh-axis split (DTensor issues the all-gathers)."""
    DTensor, Replicate, Shard = _dt()
    pl = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def gather_fsdp(p):
    """Parameters gathered over the batch axes (pod, data): FSDP's
    all-gather before use (its reduce-scatter of the gradients is this
    redistribution's backward); their splits over the model axis stay."""
    DTensor, Replicate, Shard = _dt()

    def one(w):
        names = w.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in ("pod", "data") else q
                   for n, q in zip(names, w.placements))
        return w if tuple(w.placements) == pl else \
            w.redistribute(w.device_mesh, pl)
    return _map(one, p)


def replicate(x):
    DTensor, Replicate, Shard = _dt()
    pl = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def _wrap(local, mesh, placements):
    """A local result as the DTensor of ``placements`` (Shard(0) only:
    the global batch is the local one times its axes)."""
    DTensor, Replicate, Shard = _dt()
    n = 1
    for size, p in zip(mesh.shape, placements):
        if p == Shard(0):
            n *= size
    shape = (local.shape[0] * n,) + tuple(local.shape[1:])
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if hasattr(tree, "device_mesh") else tree


def replicated_call(fn: Callable, p: dict, *acts, **kw):
    """``fn(p, *acts, **kw)`` on each device's shards, the weights ``p``
    whole (gathered over every split) and the activations ``acts``
    (tensors, dicts of tensors or None, batch first) split over their
    batch axes only: a block whose internals no head or channel split
    survives (the SSD heads, the RG-LRU gates) runs replicated over the
    model axis, as the reference's uneven splits leave it.  Tensor
    results come back as DTensors split over the batch axes."""
    DTensor, Replicate, Shard = _dt()
    mesh, batch_pl = None, None
    for a in acts:
        for t in (a.values() if isinstance(a, dict) else [a]):
            if hasattr(t, "device_mesh"):
                mesh = t.device_mesh
                batch_pl = tuple(q if q == Shard(0) else Replicate()
                                 for q in t.placements)
                break
        if mesh is not None:
            break
    pl_ = _map(lambda w: replicate(w).to_local(), p)
    acts_ = [_map(lambda t: batch_only(t).to_local(), a) for a in acts]
    kw_ = {k: _map(lambda t: batch_only(t).to_local(), v)
           for k, v in kw.items()}
    out = fn(pl_, *acts_, **kw_)
    return _map_local(lambda t: _wrap(t, mesh, batch_pl), out)


def _map_local(fn, tree):
    import torch
    if isinstance(tree, dict):
        return {k: _map_local(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_local(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def attend_sharded(fn: Callable, q, k, v, **kw):
    """An attention core ``fn(q, k, v, **kw)`` (q [B,T,H,D], k/v
    [B,S,KV,D]; tensor keywords batch-first, ``kv_pos`` / ``kv_valid``
    [B, S] on the key side) on each device's shards: batch split as q's,
    heads split where q's heads are (k/v repeated to H heads first when
    theirs are not split the same way), everything else whole.  Keys
    split along S over a mesh axis (an encoder-decoder's cached cross
    K/V) stay where they are: q comes whole over that axis, each device
    attends over its own keys, and the partial results merge across the
    axis (recorded as the all-reduce of the fp32 partials and two row
    statistics), as the ring's split-KV merge does.  The output keeps
    q's layout, whole over such an axis."""
    DTensor, Replicate, Shard = _dt()
    counter = stand_ins_only("attend_sharded")
    mesh = q.device_mesh
    seq = [kp == Shard(1) for kp in k.placements]
    target = tuple(Replicate() if s else p if p in (Shard(0), Shard(2))
                   else Replicate() for s, p in zip(seq, q.placements))
    if k.shape[2] != q.shape[2] and any(
            p == Shard(2) and kp != Shard(2)
            for p, kp in zip(target, k.placements)):
        g = q.shape[2] // k.shape[2]
        k, v = (x.redistribute(mesh, tuple(
            Shard(1) if s else p if p == Shard(0) else Replicate()
            for s, p in zip(seq, x.placements))).repeat_interleave(g, dim=2)
            for x in (k, v))
    kv_target = tuple(Shard(1) if s else p for s, p in zip(seq, target))
    ql = q.redistribute(mesh, target).to_local()
    kl, vl = (x.redistribute(mesh, kv_target).to_local() for x in (k, v))
    bpl = tuple(p if p == Shard(0) else Replicate() for p in target)
    kpl = tuple(Shard(1) if s else p for s, p in zip(seq, bpl))
    kw = {key: _local_as(a, mesh, kpl if key in ("kv_pos", "kv_valid")
                         else bpl) for key, a in kw.items()}
    out = fn(ql, kl, vl, **kw)
    b, t, h, d = out.shape
    for _ in range(sum(seq)):
        counter.record_collective("all-reduce", 4.0 * b * t * h * (d + 2))
    return DTensor.from_local(out, mesh, target, run_check=False)


def embed_sharded(table, tokens):
    """Vocab-parallel lookup of ``tokens [B, T]`` in a DTensor ``table
    [V, d]``: each device looks up in its vocabulary shard (the rows it
    lacks come out 0), and the result is a partial sum over the vocab
    axes, which the caller's reduction completes (an all-reduce of
    [B, T, d]); the whole table never moves.  Stand-ins only: the ids
    index the shard with no vocabulary offset."""
    import torch
    DTensor, Replicate, Shard = _dt()
    from torch.distributed.tensor import Partial
    stand_ins_only("embed_sharded")
    mesh = table.device_mesh
    tok = batch_only(tokens)
    pl = tuple(Partial() if w == Shard(0) else t
               for w, t in zip(table.placements, tok.placements))
    out = torch.nn.functional.embedding(tok.to_local().long(),
                                        table.to_local())
    shape = tuple(tokens.shape) + (table.shape[1],)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def cross_entropy_sharded(logits, labels, vocab_size: int, mask,
                          whole: Callable):
    """``training.train.cross_entropy`` on DTensor logits ``[B, S, V]``,
    the vocabulary split over the model axis (Megatron's vocab-parallel
    loss): each device takes its shard's max, sum of exponentials and
    label logit (its slice of the vocabulary, padding masked), reduces
    the three [B, S] rows across the split (recorded as all-reduces), and
    averages its tokens' losses; the mean over the batch split is the
    returned DTensor's reduction.  It runs on the local shards, so no
    device ever holds the whole [B, S, V] logits or their gradient.
    ``whole(logits, labels, vocab_size, mask)`` is the single-card loss,
    run when the vocabulary is whole on each device.  Stand-ins only: a
    shard's labels are matched against its local vocabulary rows."""
    import torch
    from torch.distributed.tensor import Partial
    DTensor, Replicate, Shard = _dt()
    counter = stand_ins_only("cross_entropy_sharded")
    mesh = logits.device_mesh
    last = logits.dim() - 1
    split = [p == Shard(last) for p in logits.placements]
    bpl = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
    lg = logits.redistribute(mesh, tuple(
        Shard(last) if s else p for s, p in zip(split, bpl))).to_local()
    lab = _local_as(labels, mesh, bpl)
    m = None if mask is None else _local_as(mask, mesh, bpl)
    pl = tuple(Partial("avg") if p == Shard(0) else Replicate() for p in bpl)
    if not any(split):
        # the vocabulary whole on each device: the single-card loss, op
        # for op (the one-card check holds its memory to the card's)
        return DTensor.from_local(whole(lg, lab, vocab_size, m),
                                  mesh, pl, run_check=False)
    # a stand-in's indices hold no values: any first vocabulary row will do
    rows = torch.arange(lg.shape[-1], device=lg.device)
    lg = torch.where(rows < vocab_size, lg.float(), -1e30)
    top = lg.amax(-1, keepdim=True).detach()
    sumexp = (lg - top).exp().sum(-1)
    tok = torch.where(rows == lab.long()[..., None], lg, 0.0).sum(-1)
    for _ in range(sum(split)):            # max, sum of exp, label logit
        counter.record_collective("all-reduce", 3.0 * 4 * tok.numel())
    ll = tok - (top[..., 0] + sumexp.log())
    if m is not None:
        m = m.to(ll.dtype)
        local = -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        local = -ll.mean()
    return DTensor.from_local(local, mesh, pl, run_check=False)
