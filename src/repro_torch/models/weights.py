"""Parameters of the port: seeded init, the bridge from reference
parameters, and a reader for the reference's ``.npz`` checkpoints.

Parameters are a nested ``dict`` of tensors with the reference's layouts
(``repro.models.module`` / ``repro.models.transformer.model_specs``):

* ``embed [Vp, d]`` (tied LM head), ``final_norm [d]``;
* ``layers``: every leaf stacked over a leading ``[L, ...]`` axis —
  ``ln1``/``ln2 [L, d]``, ``attn.wq [L, d, H, D]``, ``attn.wk/wv
  [L, d, KV, D]``, ``attn.wo [L, H, D, d]``, ``mlp.w_gate/w_up
  [L, d, F]``, ``mlp.w_down [L, F, d]``;
* RMSNorm scales are stored as offsets from 1 (the layer multiplies by
  ``1 + scale``), so a fresh norm is all zeros.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig

Params = Dict[str, Any]

# the reference pads the vocabulary of its serving models to a multiple
# of 128 (``model_specs(cfg, vocab_pad_multiple=128)``)
VOCAB_PAD_MULTIPLE = 128


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested ``{name: (shape, init, scale)}`` for the dense family.
    ``scale`` is the normal init's stddev: 0.02 for the embedding, else
    the reference's fan-in rule ``1/sqrt(shape[0])`` on the STACKED
    shape, whose leading axis is the layer count."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port runs the dense family, not {cfg.family!r}")
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, f, n = cfg.resolved_head_dim, cfg.d_ff, cfg.num_layers
    vp = cfg.padded_vocab(VOCAB_PAD_MULTIPLE)

    def normal(*shape):
        return (shape, "normal", 1.0 / math.sqrt(max(shape[0], 1)))

    def zeros(*shape):
        return (shape, "zeros", None)

    return {
        "embed": ((vp, d), "normal", 0.02),
        "final_norm": zeros(d),
        "layers": {
            "ln1": zeros(n, d),
            "attn": {"wq": normal(n, d, h, hd), "wk": normal(n, d, kv, hd),
                     "wv": normal(n, d, kv, hd), "wo": normal(n, h, hd, d)},
            "ln2": zeros(n, d),
            "mlp": {"w_gate": normal(n, d, f), "w_up": normal(n, d, f),
                    "w_down": normal(n, f, d)},
        },
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32) -> Params:
    """The port's own seeded init: the reference's shapes and scales,
    drawn from one CPU ``torch.Generator`` (so the same seed gives the
    same weights on every device) and moved to ``device``.  It cannot
    reproduce ``jax.random`` draws; parity tests convert reference
    parameters with :func:`from_reference` instead."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def make(leaf: Tuple) -> torch.Tensor:
        shape, init, scale = leaf
        if init == "zeros":
            t = torch.zeros(shape, dtype=torch.float32)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
        return t.to(device=device, dtype=dtype)

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


def load_reference_checkpoint(fname: str, device="cuda",
                              dtype=torch.float32) -> Params:
    """Read the reference's ``.npz`` checkpoint (``training/checkpoint.py``:
    leaves ``leaf_<i>`` plus a JSON ``manifest`` of ``/``-joined key
    paths) and return the ``params`` subtree as the port's tensors."""
    data = np.load(fname, allow_pickle=False)
    keys = json.loads(str(data["manifest"]))
    tree: Dict[str, Any] = {}
    for i, path in enumerate(keys):
        parts = path.split("/")
        if parts[0] != "params":
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[f"leaf_{i}"]
    return from_reference(tree, device=device, dtype=dtype)


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
