"""paligemma-3b — Gemma-2B decoder consuming SigLIP patch embeddings.

Source: PaliGemma [arXiv:2407.07726]. Language backbone: 18 layers,
d_model=2048, 8 heads (GQA kv=1, head_dim=256), d_ff=16384 (GeGLU),
vocab 257216. The SigLIP vision tower and projector are a stubbed
frontend, as in the reference: the batch supplies 256 precomputed patch
embeddings, attended with PaliGemma's prefix-LM mask (bidirectional over
the image prefix, causal over the text after it).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    source="arXiv:2407.07726 (PaliGemma-3B / Gemma-2B backbone)",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    mlp_type="geglu",
    tie_embeddings=True,
    num_prefix_tokens=256,        # SigLIP patch embeddings (stub frontend)
    prefix_lm_prefix=256,         # bidirectional attention over the prefix
)
