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
* RMSNorm scales are stored as offsets from 1 (the layer multiplies by
  ``1 + scale``), so a fresh norm is all zeros.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.config import FAMILIES, ModelConfig

Params = Dict[str, Any]

# the reference pads the vocabulary of its serving models to a multiple
# of 128 (``model_specs(cfg, vocab_pad_multiple=128)``)
VOCAB_PAD_MULTIPLE = 128


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested ``{name: (shape, init, scale)}`` for the dense and MoE
    families.  ``scale`` is the normal init's stddev: 0.02 for the
    embedding, the untied LM head and the router, else the reference's
    fan-in rule ``1/sqrt(shape[0])`` on the STACKED shape, whose leading
    axis is the layer count."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port runs the {' and '.join(FAMILIES)} families, not "
            f"{cfg.family!r}")
    d, kv = cfg.d_model, cfg.num_kv_heads
    h = cfg.q_head_pad or cfg.num_heads
    hd, f, n = cfg.resolved_head_dim, cfg.d_ff, cfg.num_layers
    vp = cfg.padded_vocab(VOCAB_PAD_MULTIPLE)

    def normal(*shape, scale=None):
        return (shape, "normal",
                scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1)))

    def zeros(*shape):
        return (shape, "zeros", None)

    attn = {"wq": normal(n, d, h, hd), "wk": normal(n, d, kv, hd),
            "wv": normal(n, d, kv, hd), "wo": normal(n, h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(n, h, hd), bk=zeros(n, kv, hd),
                    bv=zeros(n, kv, hd))
    if cfg.qk_norm:
        attn.update(q_norm=zeros(n, hd), k_norm=zeros(n, hd))
    layers = {"ln1": zeros(n, d), "attn": attn, "ln2": zeros(n, d)}
    if cfg.family == "moe":
        e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff
        layers["moe"] = {"router": normal(n, d, e, scale=0.02),
                         "w_gate": normal(n, e, d, fe),
                         "w_up": normal(n, e, d, fe),
                         "w_down": normal(n, e, fe, d)}
    else:
        layers["mlp"] = {"w_gate": normal(n, d, f), "w_up": normal(n, d, f),
                         "w_down": normal(n, f, d)}
    shapes = {"embed": ((vp, d), "normal", 0.02), "final_norm": zeros(d),
              "layers": layers}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, vp), "normal", 0.02)
    return shapes


def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, from the shapes alone."""
    return sum(math.prod(shape)
               for _, (shape, _, _) in param_leaves(param_shapes(cfg)))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32, rng_device="cpu") -> Params:
    """The port's own seeded init: the reference's shapes and scales,
    drawn from one ``torch.Generator`` on ``rng_device`` and moved to
    ``device``.  With the default CPU generator the same seed gives the
    same weights on every device; ``rng_device="cuda"`` draws on the
    card instead (other values, the same distribution), which a model of
    billions of parameters needs to start in seconds.  It cannot
    reproduce ``jax.random`` draws; parity tests convert reference
    parameters with :func:`from_reference` instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=resolve_device(rng_device)).manual_seed(seed)

    def make(leaf: Tuple) -> torch.Tensor:
        shape, init, scale = leaf
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return t.mul_(scale).to(device=device, dtype=dtype)

    return map_params(make, param_shapes(cfg))


def map_params(fn, *trees: Params) -> Params:
    """Leafwise ``fn`` over parameter trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_params(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


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
    """``(key path, leaf)`` pairs of a nested dict in the reference's
    leaf order: jax flattens a dict by its sorted keys, so reductions
    over leaves and checkpoint manifests follow the same order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in param_leaves(tree[k], prefix + (str(k),))]
    return [(prefix, tree)]


def unflatten_params(pairs) -> Params:
    """The nested dict of ``(key path, leaf)`` pairs."""
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


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
