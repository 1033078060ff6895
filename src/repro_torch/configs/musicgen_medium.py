"""musicgen-medium — decoder-only transformer over EnCodec audio tokens.

Source: MusicGen [arXiv:2306.05284], medium (1.5B). 48 layers, d_model=1536,
24 heads (MHA, kv=24), d_ff=6144, vocab 2048 per codebook, 4 codebooks with
the delay interleaving pattern. The EnCodec tokenizer and the T5 text
conditioner are modality frontends and are stubbed, as in the reference:
the batch supplies the token streams and the conditioning embeddings.
Cross-attention to the conditioning sequence is implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    source="arXiv:2306.05284 (MusicGen-medium)",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    cross_attention=True,
    cross_attn_len=64,             # stubbed T5 conditioning length
    mlp_type="gelu",
    norm_type="layernorm",
)
