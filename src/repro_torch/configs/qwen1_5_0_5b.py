"""qwen1.5-0.5b — dense decoder with QKV bias and tied embeddings.

Source: [hf:Qwen/Qwen1.5-0.5B]. 24 layers, d_model=1024, 16 heads (kv=16),
d_ff=2816, vocab 151936, qkv bias, tied input/output embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
)
