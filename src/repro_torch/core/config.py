"""Configuration dataclasses of the PyTorch port.

A copy of the parts of ``repro.core.config`` the port runs (the port
imports nothing of the JAX package): the architecture description with
its mixture-of-experts, SSM and RG-LRU blocks, M-RoPE and the
encoder-decoder fields, the speculation config, the serving config and
the training configs (optimizer, trainer).  Field names, defaults and
``reduced()`` are kept identical, so a config built here describes the
same model and the same schedule as its twin in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# the model families the port runs: all of the reference's
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int
    top_k: int
    # d_ff of each expert (may differ from the dense d_ff)
    expert_d_ff: int
    router_jitter: float = 0.0
    load_balance_weight: float = 0.01
    # the reference's sharding strategy ("tp" or "ep"); one card ignores it
    sharding: str = "tp"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    state_size: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    # number of SSD heads = expand * d_model // head_dim (derived)


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block configuration."""
    lru_width: int = 2560
    conv_width: int = 4
    # recurrent blocks per attention block: 2 is [rec, rec, attn] repeating
    blocks_per_attention: int = 2
    local_attention_window: int = 2048


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description of every family the port runs: dense,
    MoE, SSM (Mamba-2), hybrid (RG-LRU + local attention), vlm (M-RoPE
    over ``[B, T, 3]`` positions, patch embeddings from the stubbed
    vision front end) and audio (an encoder-decoder whose decoder
    cross-attends to the encoded frames of the stubbed audio front
    end)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2.5
    rope_theta: float = 10000.0
    # qwen2-vl's M-RoPE: (temporal, height, width) sections of head_dim/2
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attention_window: Optional[int] = None
    # physical KV heads in the cache replicated up to this count (exact)
    kv_head_pad: Optional[int] = None
    # query heads padded to this count (the extra heads' wo rows are zero)
    q_head_pad: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (audio): the bidirectional encoder's depth
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # modality front-end stub: its embeddings [B, S, frontend_dim] come
    # in place of token ids
    frontend_dim: Optional[int] = None
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is natively tractable."""
        return (self.family in ("ssm", "hybrid")
                or self.attention_window is not None)

    def padded_vocab(self, multiple: int = 2048) -> int:
        """Vocab padded to a multiple with at least one spare row serving
        as the reserved padding token id: ``pad_id == vocab_size``
        always embeds validly (paper §3.2)."""
        return ((self.vocab_size + multiple) // multiple) * multiple

    def reduced(self) -> "ModelConfig":
        """Small variant of the same architecture (<= 2 layers and <= 2
        encoder layers, d_model <= 256, <= 4 experts, SSM state <= 32,
        RG-LRU width d_model and window 64, M-RoPE sections re-cut to the
        reduced head dim), identical to the reference's ``reduced()``."""
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
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=min(self.moe.expert_d_ff, 256),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_size=min(self.ssm.state_size, 32),
                head_dim=32, chunk_size=32)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(
                self.rglru, lru_width=d_model, local_attention_window=64)
        if self.is_encoder_decoder:
            kw["num_encoder_layers"] = min(self.num_encoder_layers, 2)
        if self.frontend_dim is not None:
            kw["frontend_dim"] = d_model
        if self.attention_window is not None:
            kw["attention_window"] = min(self.attention_window, 64)
        if self.mrope_sections is not None:
            # three sections summing to head_dim // 2
            h = head_dim // 2
            kw["mrope_sections"] = (h - 2 * (h // 3), h // 3, h // 3)
        return dataclasses.replace(self, **kw)

    def draft(self) -> "ModelConfig":
        """The same-family draft (about 1/4 of the target's depth and
        width, same vocabulary), identical to the reference's
        ``draft()``.  The draft of an MoE target is dense; the others
        keep the family, and the M-RoPE sections and the encoder depth
        stay the target's (so qwen2-vl-2b's draft, H 3 over KV 2, cannot
        group its heads: the reference's own draft raises too)."""
        d_model = max(128, self.d_model // 4)
        num_heads = max(2, self.num_heads // 4)
        kw = dict(
            name=self.name + "-draft",
            num_layers=max(2, self.num_layers // 4),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=max(1, min(self.num_kv_heads, num_heads)),
            head_dim=max(32, d_model // num_heads),
            d_ff=max(256, self.d_ff // 4) if self.d_ff else 0,
        )
        if self.moe is not None:
            kw["moe"] = None
            kw["family"] = "dense"
            kw["d_ff"] = max(256, self.moe.expert_d_ff)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, head_dim=32)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=d_model)
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
    ``prefix_caching`` shares committed full prompt blocks between
    requests (refcounted, copy-on-write; DESIGN.md §12); the engine turns
    it on only with the paged pool and attention-only families."""
    max_batch_size: int = 64
    max_seq_len: int = 4096
    pipelined: bool = False
    paged_kv: bool = False
    kv_block_size: int = 16
    num_kv_blocks: Optional[int] = None     # None = dense-equivalent
    kv_quant: str = "none"
    prefix_caching: bool = False
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    global_batch_size: int = 256
    seq_len: int = 4096
    microbatch_size: Optional[int] = None   # for gradient accumulation
    remat: bool = True                       # activation checkpointing
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    checkpoint_every: int = 500
    checkpoint_dir: str = "/tmp/repro_ckpt"


# ---------------------------------------------------------------------------
# Distribution / mesh (the dry run, ``launch/dryrun.py``)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pod: int = 1

    @property
    def multi_pod(self) -> bool:
        return self.pod > 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod


@dataclass(frozen=True)
class ShardingConfig:
    """Logical-axis -> mesh-axis rules. None = replicated."""
    batch: Tuple[str, ...] = ("pod", "data")
    heads: Optional[str] = "model"
    mlp: Optional[str] = "model"
    vocab: Optional[str] = "model"
    embed: Optional[str] = None
    cache_seq: Optional[str] = None      # set to "data" for long_500k
    experts: Optional[str] = None        # "model" for expert-parallel variant
    seq: Optional[str] = None            # sequence/context parallel activations


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class HardwareSpec:
    """One card's peaks for the dry run's roofline.  Figures of NVIDIA's
    H100 SXM data sheet (dense rates, no sparsity, at the full 700 W):
    989 TFLOP/s in bf16, 3.35 TB/s and 80 GB of HBM3, NVLink 900 GB/s a
    GPU inside an 8-GPU node, and between nodes one 400 Gb/s adapter a
    GPU (50 GB/s), as a DGX H100 has.

    The collective term divides a collective's bytes by the rate of the
    slowest link its group crosses: ``nvlink_bandwidth`` for a mesh
    axis whose groups fit in one node (``gpus_per_node`` or fewer
    devices), ``network_bandwidth`` for one whose groups span nodes.  On
    the production mesh the ``model`` axis (16) and the ``data`` and
    ``pod`` axes all span nodes, so every collective there is charged
    at 50 GB/s."""
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12      # FLOP/s per card
    hbm_bandwidth: float = 3.35e12       # bytes/s per card
    hbm_bytes: float = 80e9              # capacity per card
    nvlink_bandwidth: float = 900e9      # bytes/s per GPU inside a node
    network_bandwidth: float = 50e9      # bytes/s per GPU between nodes
    gpus_per_node: int = 8


H100_SXM = HardwareSpec()
