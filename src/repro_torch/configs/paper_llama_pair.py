"""Paper experiment pair: LLaMA-3.1-70B target / LLaMA-3.2-1B draft,
emulated at reduced scale for CPU experiments (see DESIGN.md §3).
The full-size config is the real 70B geometry for dry-runs."""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-llama-pair",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    tie_embeddings=False,
    source="paper §4.1 (LLaMA-3.1-70B-Instruct / LLaMA-3.2-1B-Instruct)",
)
