"""Speculation drafters of the port.  Importing this package registers
``model`` (a separate draft model with a KV cache in the target's
layout), ``ngram`` (prompt lookup over the sequence's own text, no draft
model) and ``self`` (the target's leading layers, early exit, over the
target's own cache)."""
from repro_torch.core.drafters.base import (DraftProposal, Drafter,
                                            available_drafters, build_drafter,
                                            model_flops_per_token,
                                            register_drafter)
from repro_torch.core.drafters.model import ModelDrafter, autoregressive_draft_loop
from repro_torch.core.drafters.ngram import NGramDrafter
from repro_torch.core.drafters.self_draft import SelfDrafter

__all__ = [
    "DraftProposal", "Drafter", "ModelDrafter", "NGramDrafter",
    "SelfDrafter", "autoregressive_draft_loop",
    "available_drafters", "build_drafter", "model_flops_per_token",
    "register_drafter",
]
