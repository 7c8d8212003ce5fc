"""SmolLM-135M [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    rope_theta=10000.0,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
