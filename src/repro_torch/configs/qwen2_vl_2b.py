"""Qwen2-VL-2B [vlm] — M-RoPE over (temporal, height, width) positions;
the vision front end is a stub whose patch embeddings come as
``embeds``.  [arXiv:2409.12191]"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # (temporal, h, w) parts of head_dim/2
    frontend_dim=1536,             # the ViT projector's output == d_model
    tie_embeddings=True,
    source="arXiv:2409.12191",
)
