"""mistral-nemo-12b — dense 128k-context GQA decoder.

Source: [hf:mistralai/Mistral-Nemo-Base-2407]. 40 layers, d_model=5120,
32 heads (GQA kv=8, head_dim=128), d_ff=14336, vocab 131072 (Tekken),
rope_theta 1e6. ``long_500k`` is served through the sliding-window variant
(``LONG_CONFIG``, window 4096) — a beyond-paper configuration documented in
DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    rope_theta=1e6,
)

# Sliding-window variant used only for the long_500k decode shape.
LONG_CONFIG = CONFIG.replace(name="mistral-nemo-12b-sw4096", sliding_window=4096)
