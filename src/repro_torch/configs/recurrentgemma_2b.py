"""RecurrentGemma-2B [hybrid] — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427]"""
from repro_torch.core.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,      # MQA for the local-attention layers
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rglru=RGLRUConfig(lru_width=2560, blocks_per_attention=2,
                      local_attention_window=2048),
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
