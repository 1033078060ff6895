"""Config dataclasses of the IDKD framework, mirrored field for field from
the JAX package's ``configs/base.py`` so a run description means the same
thing on either side.

* :class:`ModelConfig` — one composable description of every supported
  architecture family plus the paper's ResNet20-EvoNorm classifier; this
  package runs the ResNet and the decoder stacks (PaliGemma's patch
  prefix and prefix-LM mask included) without MoE, MLA or multi-token
  prediction (see ROADMAP.md). ``reduced()`` derives the CPU
  test variant of a full config, as the reference's does.
* :class:`IDKDConfig` — the paper's Algorithm 1 hyper-parameters.
* :class:`TrainConfig` — one decentralized training run.

Plain frozen dataclasses: they hash, print and diff cleanly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard-style top-k routing)."""

    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    dense_residual_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_type: str = "softmax"
    router_aux_coef: float = 0.01
    dispatch_groups: int = 1

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer sub-config."""

    state_size: int = 0
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    ngroups: int = 1
    split_proj: bool = False

    @property
    def enabled(self) -> bool:
        return self.state_size > 0


@dataclass(frozen=True)
class ModelConfig:
    """A composable model description (decoder stacks and the CNN)."""

    name: str = "model"
    arch_type: str = "dense"            # dense|moe|ssm|hybrid|vlm|audio|cnn
    source: str = ""

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                   # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0
    global_attn_every: int = 0
    prefix_lm_prefix: int = 0
    cross_attention: bool = False
    cross_attn_len: int = 0

    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    norm_in_f32: bool = True

    tie_embeddings: bool = False
    num_codebooks: int = 0
    num_prefix_tokens: int = 0
    mtp_depth: int = 0

    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid_parallel: bool = False

    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    node_scope: str = "replica"
    use_pallas: bool = False
    attn_chunk: int = 512

    # CNN (paper-faithful ResNet) -----------------------------------------
    cnn_stages: Tuple[int, ...] = ()    # blocks per stage, e.g. (3,3,3)
    cnn_width: int = 16
    image_size: int = 32
    image_channels: int = 3
    num_classes: int = 10
    conv_backend: str = "lax"           # read by the JAX package only; the
                                        # port always convolves with cuDNN

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU test variant: ≤2 layers, d_model ≤ 256, ≤4 experts."""
        heads = min(self.num_heads, 4)
        moe = self.moe
        if moe.enabled:
            moe = dataclasses.replace(
                moe,
                num_experts=min(moe.num_experts, 4),
                num_experts_per_tok=min(moe.num_experts_per_tok, 2),
                moe_d_ff=min(moe.moe_d_ff, 128),
                num_shared_experts=min(moe.num_shared_experts, 1),
                dense_residual_ff=min(moe.dense_residual_ff, 128),
                first_k_dense=min(moe.first_k_dense, 1))
        mla = self.mla
        if mla.enabled:
            mla = dataclasses.replace(
                mla, q_lora_rank=min(mla.q_lora_rank, 64),
                kv_lora_rank=min(mla.kv_lora_rank, 32),
                qk_nope_head_dim=min(mla.qk_nope_head_dim, 32),
                qk_rope_head_dim=min(mla.qk_rope_head_dim, 16),
                v_head_dim=min(mla.v_head_dim, 32))
        ssm = self.ssm
        if ssm.enabled:
            ssm = dataclasses.replace(
                ssm, state_size=min(ssm.state_size, 16),
                head_dim=min(ssm.head_dim, 16), chunk_size=32)
        return self.replace(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=heads,
            num_kv_heads=max(1, min(self.num_kv_heads, heads)),
            head_dim=min(self.resolved_head_dim, 64),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            cross_attn_len=min(self.cross_attn_len, 8),
            mtp_depth=min(self.mtp_depth, 1),
            moe=moe, mla=mla, ssm=ssm,
            cnn_stages=tuple(min(b, 1) for b in self.cnn_stages),
            cnn_width=min(self.cnn_width, 8),
            image_size=min(self.image_size, 8),
            attn_chunk=64,
            dtype="float32",
            remat=False,
        )


@dataclass(frozen=True)
class IDKDConfig:
    """Hyper-parameters of the paper's Algorithm 1."""

    temperature: float = 10.0       # distillation temperature (paper §4.2)
    start_step: int = 0             # "local convergence" trigger
    every_k_steps: int = 100        # rounds fire at start_step + j*every_k
    num_rounds: int = 1             # homogenization rounds in the schedule
    kd_weight: float = 1.0          # weight of soft-CE on D_ID
    label_topk: int = 0             # 0 => DEFAULT_TOPK on sparse backends
    detector: str = "msp"           # "msp" | "energy"
    label_backend: str = "dense"    # "dense" | "fused" | "sparse"
    stream_labels: bool = True      # fused/sparse rounds stream the public
                                    # set through the head_select kernel
    stream_microbatch: int = 256    # public samples per streaming chunk
    select_block_rows: int = 8      # TPU kernels' row block; the CUDA
                                    # kernels size their own tiles


@dataclass(frozen=True)
class TrainConfig:
    """Decentralized training run description."""

    algorithm: str = "qg-dsgdm-n"   # dsgd|dsgdm|qg-dsgdm-n (ported so far)
    topology: str = "ring"
    num_nodes: int = 16
    alpha: float = 0.1              # Dirichlet non-IID skew parameter
    lr: float = 0.5
    momentum: float = 0.9
    weight_decay: float = 1e-4
    batch_size: int = 32            # per node
    steps: int = 300
    lr_decay_milestones: Tuple[float, float] = (0.6, 0.8)
    lr_decay_factor: float = 0.1
    seed: int = 4                   # paper seeds: 4, 34, 5
    idkd: Optional[IDKDConfig] = None

    compression: str = "none"       # only "none" is ported (ROADMAP.md)
    compression_frac: float = 0.01
    gossip: str = "sync"            # only "sync" is ported (ROADMAP.md)

    @property
    def compression_spec(self):
        """None, or the ``(kind, frac)`` pair of a compressed wire."""
        if self.compression in (None, "", "none"):
            return None
        return (self.compression, self.compression_frac)
