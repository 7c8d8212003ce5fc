"""Speculation drafters of the port.  Importing this package registers
``model`` (a separate draft model with a mirrored paged KV cache) and
``ngram`` (prompt lookup over the sequence's own text, no draft model)."""
from repro_torch.core.drafters.base import (DraftProposal, Drafter,
                                            available_drafters, build_drafter,
                                            model_flops_per_token,
                                            register_drafter)
from repro_torch.core.drafters.model import ModelDrafter, autoregressive_draft_loop
from repro_torch.core.drafters.ngram import NGramDrafter

__all__ = [
    "DraftProposal", "Drafter", "ModelDrafter", "NGramDrafter",
    "autoregressive_draft_loop",
    "available_drafters", "build_drafter", "model_flops_per_token",
    "register_drafter",
]
