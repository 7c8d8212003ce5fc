"""Granite-3.0-3B-A800M [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.core.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
