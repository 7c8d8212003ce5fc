"""Mamba2-130M [ssm] — SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.core.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,          # attention-free; SSD heads derived from SSMConfig
    num_kv_heads=1,
    d_ff=0,               # the mamba block replaces attention + MLP
    vocab_size=50280,
    ssm=SSMConfig(state_size=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
