"""SeamlessM4T-medium [audio] — an encoder-decoder; the audio front end
(mel + conv) is a stub whose frame embeddings come as
``encoder_embeds``.  [arXiv:2308.11596]"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,              # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,            # MHA
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    is_encoder_decoder=True,
    frontend_dim=1024,
    tie_embeddings=True,
    source="arXiv:2308.11596",
)
