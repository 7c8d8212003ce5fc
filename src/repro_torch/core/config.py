"""Configuration dataclasses of the PyTorch port.

A copy of the parts of ``repro.core.config`` the port runs (the port
imports nothing of the JAX package): the architecture description, the
speculation config and the serving config.  Field names, defaults and
``reduced()`` are kept identical, so a config built here describes the
same model and the same schedule as its twin in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  The port runs the dense family with
    tied embeddings; the fields of other families and layouts (MoE, SSM,
    RG-LRU, qkv bias, qk norm, M-RoPE, head padding) come with their
    slices."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    rope_theta: float = 10000.0
    attention_window: Optional[int] = None
    norm_eps: float = 1e-6
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def padded_vocab(self, multiple: int = 2048) -> int:
        """Vocab padded to a multiple with at least one spare row serving
        as the reserved padding token id: ``pad_id == vocab_size``
        always embeds validly (paper §3.2)."""
        return ((self.vocab_size + multiple) // multiple) * multiple

    def reduced(self) -> "ModelConfig":
        """Small variant of the same architecture (<= 2 layers, d_model
        <= 256), identical to the reference's ``reduced()``."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        head_dim = max(d_model // num_heads, 16)
        num_kv = max(1, min(self.num_kv_heads, num_heads,
                            max(1, num_heads * self.num_kv_heads // self.num_heads)))
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
        )
        if self.attention_window is not None:
            kw["attention_window"] = min(self.attention_window, 64)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SpecDecodeConfig:
    """DSDE adapter configuration; defaults follow the paper.  ``policy``
    names a registered :class:`repro_torch.core.policies.SpecPolicy`,
    ``drafter`` a registered :class:`repro_torch.core.drafters.Drafter`."""
    policy: str = "dsde"
    drafter: str = "model"
    ngram_n: int = 3                   # n-gram drafter suffix length
    sl_min: int = 2
    sl_max: int = 10
    static_sl: int = 4
    decay: float = 0.85                # Eq. (5)
    short_window: int = 10
    long_window: int = 30
    sf_scale: float = 2.0              # Eq. (3)
    sf_normalize: bool = False
    calibration_steps: int = 4         # Eq. (1)
    calibration_sl: int = 5
    eps: float = 1e-6
    use_sl_cap: bool = True            # Eq. (11)
    # AdaEDL baseline: stop drafting when the entropy-based acceptance
    # lower bound drops below the threshold; base=7 is the paper's
    adaedl_base: int = 7
    adaedl_threshold: float = 0.1
    # goodput controller: EMA decay of the per-round acceptance, the
    # per-draft-step cost relative to one verification (None = the
    # serving drafter's ``step_cost()``), the optimistic prior
    goodput_ema: float = 0.75
    goodput_draft_cost: Optional[float] = None
    goodput_init_acc: float = 0.7
    # self drafter: leading target layers the early-exit draft runs
    self_draft_layers: int = 1
    temperature: float = 0.0           # 0.0 = greedy
    penalty_cutoff: float = 1.0        # Eq. (8)


@dataclass(frozen=True)
class ServingConfig:
    """Serving shape.  ``paged_kv`` picks the KV layout: a dense ring of
    ``max_seq_len`` (or window + slack) slots per batch slot (the
    default, as in the reference) or the shared block-paged pool.
    ``pipelined`` dispatches round N+1 before the host reconciles round
    N.  ``kv_quant`` is the paged pool's storage mode: ``"none"`` (fp32)
    or ``"int8"`` (int8 values plus one fp32 scale per stored vector).
    ``slo_defer_limit`` bounds the SLO admission gate's deferrals.
    Prefix caching comes with its slice."""
    max_batch_size: int = 64
    max_seq_len: int = 4096
    pipelined: bool = False
    paged_kv: bool = False
    kv_block_size: int = 16
    num_kv_blocks: Optional[int] = None     # None = dense-equivalent
    kv_quant: str = "none"
    # SLO admission (DESIGN.md §15): times a fresh request predicted to
    # miss its deadline may be deferred behind feasible later arrivals
    # before it admits anyway (0 = never deferred, still surfaced)
    slo_defer_limit: int = 4

    def blocks_per_seq(self) -> int:
        """Block-table width: worst-case blocks one sequence can hold."""
        return -(-self.max_seq_len // self.kv_block_size)

    def pool_blocks(self) -> int:
        """Resolved pool size in blocks (None = dense-equivalent)."""
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        return self.max_batch_size * self.blocks_per_seq()
