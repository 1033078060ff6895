"""mamba2-780m — pure Mamba-2 (SSD, state-space duality) language model.

Source: Dao & Gu, "Transformers are SSMs" [arXiv:2405.21060], 780m scale.
48 layers, d_model=1536, attention-free, d_state=128, vocab 50280 (GPT-NeoX).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    source="arXiv:2405.21060 (Mamba-2 780m)",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                       # attention-free, no MLP: Mamba2 block only
    vocab_size=50_280,
    tie_embeddings=True,
    norm_type="rmsnorm",
    ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
)
