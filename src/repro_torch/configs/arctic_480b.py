"""arctic-480b — dense-MoE hybrid: 128-expert top-2 MoE ∥ dense residual MLP.

Source: Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]. 35 layers,
d_model=7168, 56 heads (GQA kv=8), expert d_ff=4864, vocab 32000,
128 experts top-2 with a dense residual branch in parallel.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    node_scope="pod",      # 480B params: one gossip node per pod (DESIGN §5)
    moe=MoEConfig(
        num_experts=128,
        num_experts_per_tok=2,
        moe_d_ff=4864,
        dense_residual_ff=4864,    # Arctic's parallel dense branch
        capacity_factor=1.25,
        router_type="softmax",
    ),
)
