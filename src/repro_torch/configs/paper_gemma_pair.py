"""Paper low-acceptance pair: Gemma-27B target / Gemma-2B draft
(high draft-target divergence regime, paper §4.4)."""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-gemma-pair",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256128,
    head_dim=128,
    rope_theta=10000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="paper §4.4 (Gemma-27B / Gemma-2B)",
)
