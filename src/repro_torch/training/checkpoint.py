"""Parameter checkpoints on local disk, in the reference's format
(``repro.training.checkpoint``), so each package reads the other's files.

Layout: one ``ckpt_%08d.npz`` per step holding the leaves ``leaf_<i>``
of ``{"params": ..., "extra": ...}`` plus a JSON ``manifest`` of their
``/``-joined key paths (``params/layers/attn/wq``), in jax's leaf order
(dict keys sorted), and a ``latest`` pointer file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.weights import (param_leaves, read_checkpoint,
                                        unflatten_params)

_SEP = "/"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, step: int, params: Any,
                    extra: Optional[Any] = None) -> str:
    """Write ``params`` (and ``extra``) as ``path/ckpt_<step>.npz`` and
    point ``path/latest`` at it; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    tree = {"params": params}
    if extra is not None:
        tree["extra"] = extra
    pairs = param_leaves(tree)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, (_, leaf) in enumerate(pairs)}
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fname, manifest=json.dumps([_SEP.join(k) for k, _ in pairs]),
             **arrays)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(os.path.basename(fname))
    return fname


def latest_checkpoint(path: str) -> Optional[str]:
    ptr = os.path.join(path, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return os.path.join(path, f.read().strip())


def restore_checkpoint(fname: str, template: Any) -> Tuple[Any, Any]:
    """Restore ``(params, extra)`` into the structure of ``template``
    (``{"params": ..., "extra": ...}`` or params only).  A tensor leaf
    of the template comes back as a tensor of its dtype on its device,
    any other leaf as the stored numpy array.  A leaf the file lacks
    raises ``KeyError``, a shape that differs ``ValueError``, as in the
    reference."""
    stored = dict(param_leaves(read_checkpoint(fname)))
    tree = (template if isinstance(template, dict) and "params" in template
            else {"params": template})
    pairs = []
    for key, leaf in param_leaves(tree):
        name = _SEP.join(key)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = stored[key]
        shape = (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
                 else np.shape(leaf))
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {shape}")
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, dtype=leaf.dtype, device=leaf.device)
        pairs.append((key, arr))
    restored = unflatten_params(pairs)
    return restored.get("params"), restored.get("extra")
