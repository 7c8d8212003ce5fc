"""Parameters of the port: seeded init, the bridge from reference
parameters, and a reader for the reference's ``.npz`` checkpoints.

Parameters are a nested ``dict`` of tensors with the reference's layouts
(``repro.models.module`` / ``repro.models.transformer.model_specs``):

* ``embed [Vp, d]``, ``final_norm [d]``, and ``lm_head [d, Vp]`` when
  the head is untied (``tie_embeddings=False``; tied, the head is
  ``embed``);
* ``layers``: every leaf stacked over a leading ``[L, ...]`` axis —
  ``ln1``/``ln2 [L, d]``, ``attn.wq [L, d, H, D]`` (H = ``q_head_pad``
  when set), ``attn.wk/wv [L, d, KV, D]``, ``attn.wo [L, H, D, d]``,
  ``attn.bq [L, H, D]``/``bk``/``bv [L, KV, D]`` (``qkv_bias``),
  ``attn.q_norm``/``k_norm [L, D]`` (``qk_norm``); then the dense MLP
  ``mlp.w_gate/w_up [L, d, F]``, ``mlp.w_down [L, F, d]``, or the MoE
  block ``moe.router [L, d, E]``, ``moe.w_gate/w_up [L, E, d, Fe]``,
  ``moe.w_down [L, E, Fe, d]``;
* an encoder-decoder (audio): decoder ``layers`` of ``ln1``,
  ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``mlp``; encoder
  ``enc_layers`` of ``ln1``, ``attn``, ``ln2``, ``mlp`` stacked over
  ``[num_encoder_layers, ...]``; and ``enc_norm [d]``;
* RMSNorm scales are stored as offsets from 1 (the layer multiplies by
  ``1 + scale``), so a fresh norm is all zeros.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import FAMILIES, ModelConfig
from repro_torch.models.rglru import rglru_shapes
from repro_torch.models.ssm import ssm_shapes

Params = Dict[str, Any]

# the reference pads the vocabulary of its serving models to a multiple
# of 128 (``model_specs(cfg, vocab_pad_multiple=128)``)
VOCAB_PAD_MULTIPLE = 128


def param_shapes(cfg: ModelConfig,
                 vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE) -> Dict[str, Any]:
    """Nested ``{name: Spec(shape, init, scale, axes)}`` of ``cfg``'s
    parameters, the vocabulary padded to ``vocab_pad_multiple`` (the
    dry run pads to 2048, ``launch/steps.py``).
    ``scale`` is the normal init's stddev: 0.02 for the embedding, the
    untied LM head, the router and the RG-LRU gates, 0.5 for the conv
    filters, else the reference's fan-in rule ``1/sqrt(shape[0])`` on the
    STACKED shape, whose leading axis is the layer count (the group count
    in a hybrid stack's groups).  ``axes`` are the reference's logical
    axis names, one per dim (``layers`` on a stacked axis)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port runs the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r}")
    vp = cfg.padded_vocab(vocab_pad_multiple)
    shapes = {"embed": _normal(vp, cfg.d_model, scale=0.02,
                               axes=("vocab", "embed")),
              "final_norm": _norm(cfg.d_model)}
    if cfg.family == "hybrid":
        shapes["layers"] = _hybrid_shapes(cfg)
    else:
        shapes["layers"] = _resolve(_stack(_layer_shapes(cfg),
                                           cfg.num_layers))
    if cfg.is_encoder_decoder:
        d = cfg.d_model
        enc = {"ln1": _norm(d), "attn": _attention_shapes(cfg),
               "ln2": _norm(d), "mlp": _mlp_shapes(d, cfg.d_ff)}
        shapes["enc_layers"] = _resolve(_stack(enc, cfg.num_encoder_layers))
        shapes["enc_norm"] = _norm(d)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = _normal(cfg.d_model, vp, scale=0.02,
                                    axes=("embed", "vocab"))
    return shapes


class Spec(NamedTuple):
    """One parameter's shape and init: ``init`` "normal" (stddev
    ``scale``), "zeros" or "ones"; ``axes`` the logical axis name of
    each dim (None: never sharded), as the reference's ``Spec`` has
    them.  A leaf of :func:`param_shapes`'s tree (never taken for a
    tuple subtree)."""
    shape: Tuple[int, ...]
    init: str
    scale: Optional[float]
    axes: Tuple[Optional[str], ...]


def _normal(*shape, scale=None, axes):
    return Spec(shape, "normal", scale, axes)


def _zeros(*shape, axes):
    return Spec(shape, "zeros", None, axes)


def _ones(*shape, axes):
    return Spec(shape, "ones", None, axes)


def _norm(d: int) -> Spec:
    """An RMSNorm scale over the model width."""
    return _zeros(d, axes=("embed",))


def _stack(tree, n: int):
    """``tree``'s leaves with a leading ``[n]`` axis named ``layers``
    (the reference's ``_stack_specs``: an explicit scale stays, a fan-in
    one is read off the stacked shape)."""
    return map_params(lambda leaf: leaf._replace(
        shape=(n,) + leaf.shape, axes=("layers",) + leaf.axes), tree)


def _resolve(tree):
    """The fan-in stddev ``1/sqrt(shape[0])`` of every normal leaf whose
    scale is not explicit."""
    return map_params(
        lambda leaf: (leaf if leaf.init != "normal" or leaf.scale is not None
                      else leaf._replace(
                          scale=1.0 / math.sqrt(max(leaf.shape[0], 1)))),
        tree)


def _attention_shapes(cfg: ModelConfig) -> dict:
    d, kv = cfg.d_model, cfg.num_kv_heads
    h, hd = cfg.q_head_pad or cfg.num_heads, cfg.resolved_head_dim
    attn = {"wq": _normal(d, h, hd, axes=("embed", "heads", "head_dim")),
            "wk": _normal(d, kv, hd, axes=("embed", "kv_heads", "head_dim")),
            "wv": _normal(d, kv, hd, axes=("embed", "kv_heads", "head_dim")),
            "wo": _normal(h, hd, d, axes=("heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        attn.update(bq=_zeros(h, hd, axes=("heads", "head_dim")),
                    bk=_zeros(kv, hd, axes=("kv_heads", "head_dim")),
                    bv=_zeros(kv, hd, axes=("kv_heads", "head_dim")))
    if cfg.qk_norm:
        attn.update(q_norm=_zeros(hd, axes=("head_dim",)),
                    k_norm=_zeros(hd, axes=("head_dim",)))
    return attn


def _mlp_shapes(d: int, f: int) -> dict:
    return {"w_gate": _normal(d, f, axes=("embed", "mlp")),
            "w_up": _normal(d, f, axes=("embed", "mlp")),
            "w_down": _normal(f, d, axes=("mlp", "embed"))}


def _layer_shapes(cfg: ModelConfig) -> dict:
    """One layer of a homogeneous stack (dense, vlm, MoE, SSM, an audio
    decoder), unstacked."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln": _norm(d),
                "mixer": ssm_shapes(cfg, _normal, _zeros, _ones)}
    if cfg.family == "audio":
        return {"ln1": _norm(d), "self_attn": _attention_shapes(cfg),
                "ln2": _norm(d), "cross_attn": _attention_shapes(cfg),
                "ln3": _norm(d), "mlp": _mlp_shapes(d, cfg.d_ff)}
    layers = {"ln1": _norm(d), "attn": _attention_shapes(cfg),
              "ln2": _norm(d)}
    if cfg.family == "moe":
        e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff
        layers["moe"] = {
            "router": _normal(d, e, scale=0.02, axes=("embed", None)),
            "w_gate": _normal(e, d, fe, axes=("experts", "embed", "mlp")),
            "w_up": _normal(e, d, fe, axes=("experts", "embed", "mlp")),
            "w_down": _normal(e, fe, d, axes=("experts", "mlp", "embed"))}
    else:
        layers["mlp"] = _mlp_shapes(d, cfg.d_ff)
    return layers


def _hybrid_layer_shapes(cfg: ModelConfig, attention: bool) -> dict:
    temporal = (_attention_shapes(cfg) if attention else
                rglru_shapes(cfg, _normal, _zeros, _ones))
    return {"ln1": _norm(cfg.d_model), "temporal": temporal,
            "ln2": _norm(cfg.d_model),
            "mlp": _mlp_shapes(cfg.d_model, cfg.d_ff)}


def _hybrid_shapes(cfg: ModelConfig) -> dict:
    """The hybrid stack's tree (the reference's ``model_specs``): the
    ``(rec x bpa, attn)`` groups stacked over a leading ``[ngroups]``
    axis (``groups``: ``rec`` leaves ``[ngroups, bpa, ...]``, ``attn``
    leaves ``[ngroups, ...]``; None without a whole group), then the
    remainder of recurrent layers unstacked (``tail``: a tuple of
    per-layer dicts)."""
    bpa = cfg.rglru.blocks_per_attention
    ngroups, tail = divmod(cfg.num_layers, bpa + 1)
    group = {"rec": _stack(_hybrid_layer_shapes(cfg, False), bpa),
             "attn": _hybrid_layer_shapes(cfg, True)}
    return {"groups": _resolve(_stack(group, ngroups)) if ngroups else None,
            "tail": tuple(_resolve(_hybrid_layer_shapes(cfg, False))
                          for _ in range(tail))}


def logical_to_pspec(axes, rules) -> Tuple:
    """The spec that the rules table ``rules`` (a ``ShardingConfig``)
    gives logical dims ``axes``: one entry per dim, trailing Nones
    trimmed (``launch.sharding.canonical_spec``'s form)."""
    mapping = {
        "embed": rules.embed,
        "mlp": rules.mlp,
        "heads": rules.heads,
        "kv_heads": rules.heads,     # kv heads follow the heads rule
        "vocab": rules.vocab,
        "experts": rules.experts,
        "batch": tuple(rules.batch) or None,
        "cache_seq": rules.cache_seq,
        "seq": rules.seq,
        "lru": rules.mlp,
        # never sharded: head_dim, layers, conv, state
    }
    spec = [mapping.get(name) for name in axes]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def count_params(cfg: ModelConfig,
                 vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    """Parameters of ``cfg``, from the shapes alone."""
    return sum(math.prod(leaf.shape) for _, leaf in
               param_leaves(param_shapes(cfg, vocab_pad_multiple)))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32, rng_device="cpu",
                vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE,
                plan=None) -> Params:
    """The port's own seeded init: the reference's shapes and scales,
    drawn from one ``torch.Generator`` on ``rng_device`` and moved to
    ``device``.  With the default CPU generator the same seed gives the
    same weights on every device; ``rng_device="cuda"`` draws on the
    card instead (other values, the same distribution), which a model of
    billions of parameters needs to start in seconds.  It cannot
    reproduce ``jax.random`` draws; parity tests convert reference
    parameters with :func:`from_reference` instead.
    ``vocab_pad_multiple``: as :func:`param_shapes` takes it.

    ``plan`` (a ``core.tp.MeshPlan``): each leaf is cut to this rank's
    shard right after it is drawn, so no rank holds more than one whole
    leaf at a time, and the shards of all ranks are the whole draw's."""
    device = resolve_device(device)
    gen = torch.Generator(device=resolve_device(rng_device)).manual_seed(seed)

    def make(name: str, leaf: Spec) -> torch.Tensor:
        shape, init, scale, axes = leaf
        if init in ("zeros", "ones"):
            if plan is not None:
                shape = serve_local_shape(cfg, plan, name, leaf)
            fill = torch.zeros if init == "zeros" else torch.ones
            return fill(shape, dtype=dtype, device=device)
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        if plan is not None:
            t = plan.local_slice(t, *serve_cut(cfg, plan, name, leaf))
        return t.mul_(scale).to(device=device, dtype=dtype)

    return map_named(make, param_shapes(cfg, vocab_pad_multiple))


# the Mamba-2 mixer's leaves over its joint x | B | C axis
XBC_LEAVES = ("wxbc", "conv_w", "conv_b")


def serve_cut(cfg: ModelConfig, plan, name: str, leaf: Spec
              ) -> Tuple[Tuple, Optional[torch.Tensor]]:
    """(spec, cols): how a serving mesh's rank cuts the leaf ``name`` of
    ``cfg`` (``core.tp.MeshPlan.local_slice`` takes both): the ``serve``
    rules' guarded spec (:meth:`~repro_torch.core.tp.MeshPlan.param_spec`,
    the RG-LRU block whole), but for the Mamba-2 mixer, whose width
    leaves follow its SSD heads (``HeadLayout.ssd``; all whole where
    *model* does not divide them) and whose x | B | C leaves keep this
    rank's x columns and all of B and C (``cols``,
    :meth:`~repro_torch.core.tp.MeshPlan.xbc_columns`)."""
    if cfg.family == "ssm" and "mlp" in leaf.axes:
        if plan.layout(cfg).ssd is None:
            return (), None
        if name in XBC_LEAVES:
            return (), plan.xbc_columns(cfg)
    return plan.param_spec(leaf.shape, leaf.axes), None


def serve_local_shape(cfg: ModelConfig, plan, name: str, leaf: Spec
                      ) -> Tuple[int, ...]:
    """The shape of this rank's :func:`serve_cut` of a leaf."""
    spec, cols = serve_cut(cfg, plan, name, leaf)
    if cols is not None:
        return tuple(leaf.shape[:-1]) + (len(cols),)
    return plan.local_shape(leaf.shape, spec)


def shard_params(params: Params, cfg: ModelConfig, plan,
                 vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE) -> Params:
    """``params`` (``cfg``'s whole tree, e.g. from :func:`from_reference`)
    cut leaf by leaf to this rank's shards under ``plan`` (a
    ``core.tp.MeshPlan``: :func:`serve_cut`, the reference's
    ``param_shardings`` but for the RG-LRU block and the Mamba-2 mixer's
    x | B | C leaves).  A leaf already at its local shape
    (an :func:`init_params` with ``plan``) stays as it is."""
    def cut(name: str, leaf: Spec, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) == tuple(leaf.shape):
            return plan.local_slice(x, *serve_cut(cfg, plan, name, leaf))
        if tuple(x.shape) != serve_local_shape(cfg, plan, name, leaf):
            raise ValueError(f"parameter of shape {tuple(x.shape)} is neither "
                             f"{leaf.shape} nor its shard")
        return x
    return map_named(cut, param_shapes(cfg, vocab_pad_multiple), params)


def map_params(fn, *trees: Params) -> Params:
    """Leafwise ``fn`` over parameter trees of the same structure: nested
    dicts and tuples (a hybrid stack's ``tail``), with None as an empty
    subtree (its ``groups`` when it has no whole group), which the other
    trees may leave out."""
    first = trees[0]
    if isinstance(first, dict):
        # an empty subtree of the first tree is absent from a tree rebuilt
        # from leaves (:func:`unflatten_params`)
        return {k: (None if first[k] is None else
                    map_params(fn, *(t[k] for t in trees))) for k in first}
    if isinstance(first, tuple) and not isinstance(first, Spec):
        return tuple(map_params(fn, *sub) for sub in zip(*trees))
    if first is None:
        return None
    return fn(*trees)


def map_named(fn, shapes, *trees: Params, name: str = "") -> Params:
    """:func:`map_params` over a :func:`param_shapes` tree and trees of
    its structure, ``fn(name, spec, *leaves)`` given each leaf's key."""
    if isinstance(shapes, dict):
        return {k: (None if shapes[k] is None else
                    map_named(fn, shapes[k], *(t[k] for t in trees), name=k))
                for k in shapes}
    if isinstance(shapes, tuple) and not isinstance(shapes, Spec):
        return tuple(map_named(fn, sub[0], *sub[1:], name=name)
                     for sub in zip(shapes, *trees))
    return fn(name, shapes, *trees)


def from_reference(tree, device="cuda", dtype=torch.float32) -> Params:
    """Convert a reference parameter tree (nested dicts of numpy or
    array-like leaves, e.g. ``jax.tree_util.tree_map(np.asarray,
    params)``) to the port's tensors.  The layouts are the same, so the
    conversion is a copy."""
    device = resolve_device(device)
    return map_params(lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                             device=device), tree)


def param_leaves(tree, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(key path, leaf)`` pairs of a nested dict / tuple tree in the
    reference's leaf order: jax flattens a dict by its sorted keys and a
    tuple in order (its keys are the indices), and None holds no leaf,
    so reductions over leaves and checkpoint manifests follow the same
    order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in param_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and not isinstance(tree, Spec):
        return [pair for i, sub in enumerate(tree)
                for pair in param_leaves(sub, prefix + (str(i),))]
    if tree is None:
        return []
    return [(prefix, tree)]


def _tuples(node):
    """A dict whose keys are exactly "0" .. "n-1" back to the tuple it
    was flattened from (the reference's trees key no dict by digits)."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return tuple(node[str(i)] for i in range(len(node)))
    return node


def unflatten_params(pairs) -> Params:
    """The nested tree of ``(key path, leaf)`` pairs; index-keyed levels
    come back as tuples.  A subtree that held no leaf (a hybrid stack's
    ``groups`` of None, an empty ``tail``) has no path and comes back
    absent; the model reads both with defaults."""
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return _tuples(tree)


def read_checkpoint(fname: str) -> Dict[str, Any]:
    """The whole tree of a ``.npz`` checkpoint in the reference's format
    (``training/checkpoint.py`` of either package: leaves ``leaf_<i>``
    plus a JSON ``manifest`` of their ``/``-joined key paths), as nested
    dicts of numpy arrays: ``{"params": ..., "extra": ...}``."""
    with np.load(fname, allow_pickle=False) as data:
        keys = json.loads(str(data["manifest"]))
        return unflatten_params((tuple(k.split("/")), data[f"leaf_{i}"])
                                for i, k in enumerate(keys))


def load_reference_checkpoint(fname: str, device="cuda",
                              dtype=torch.float32) -> Params:
    """Read a ``.npz`` checkpoint (:func:`read_checkpoint`) and return its
    ``params`` subtree as the port's tensors."""
    return from_reference(read_checkpoint(fname)["params"], device=device,
                          dtype=dtype)


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.  Asking
    for CUDA where there is none raises: nothing quietly moves to the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
