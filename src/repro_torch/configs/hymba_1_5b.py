"""hymba-1.5b — hybrid-head model: attention and Mamba heads in parallel.

Source: NVIDIA Hymba [arXiv:2411.13676]. 32 layers, d_model=1600, 25 heads
(GQA kv=5), d_ff=5504, vocab 32001, SSM state 16; sliding-window attention
in most layers with a few global layers; 128 learnable meta tokens prepended.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676 (Hymba-1.5B)",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=1024,
    global_attn_every=16,          # layers 0, 16 (+ last) use global attn
    num_prefix_tokens=128,         # meta tokens
    hybrid_parallel=True,
    ssm=SSMConfig(state_size=16, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
)
