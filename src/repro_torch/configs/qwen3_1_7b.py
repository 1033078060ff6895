"""qwen3-1.7b — dense decoder with qk-norm and GQA.

Source: Qwen3 family [hf:Qwen/Qwen3-8B model card; 1.7B variant]. 28 layers,
d_model=2048, 16 heads (GQA kv=8, head_dim=128), d_ff=6144, vocab 151936,
per-head RMS qk-norm, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B (family card; 1.7B)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
