"""phi3-mini-3.8b — dense RoPE/SwiGLU/GQA decoder.

Source: Phi-3 [arXiv:2404.14219]. 32 layers, d_model=3072, 32 heads
(kv=32, MHA), d_ff=8192, vocab 32064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    source="arXiv:2404.14219 (Phi-3-mini)",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
)
