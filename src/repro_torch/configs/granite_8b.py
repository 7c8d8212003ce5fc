"""Granite-8B [dense] — llama-arch, code. [arXiv:2405.04324]"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2405.04324",
)
