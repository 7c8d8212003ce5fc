"""Mixtral-8x22B [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.core.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    attention_window=4096,     # SWA — makes long_500k natively tractable
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=16384),
    tie_embeddings=False,
    source="arXiv:2401.04088",
)
