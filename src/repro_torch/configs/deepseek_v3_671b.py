"""deepseek-v3-671b — MLA + 256-expert top-8 MoE with shared expert + MTP.

Source: DeepSeek-V3 [arXiv:2412.19437]. 61 layers (first 3 dense),
d_model=7168, 128 heads with multi-head latent attention (q_lora 1536,
kv_lora 512, nope 128 / rope 64 / v 128), routed expert d_ff=2048,
1 shared + 256 routed experts top-8 with sigmoid routing, vocab 129280,
one multi-token-prediction (MTP) depth.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437 (DeepSeek-V3)",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,              # MLA: kv heads == q heads post-expansion
    d_ff=18432,                    # dense layers' FFN width
    vocab_size=129_280,
    mtp_depth=1,
    node_scope="pod",   # 671B params: one gossip node per pod (DESIGN §5)
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        num_experts_per_tok=8,
        moe_d_ff=2048,
        num_shared_experts=1,
        first_k_dense=3,
        capacity_factor=1.25,
        router_type="sigmoid",     # aux-loss-free bias balancing
    ),
)
