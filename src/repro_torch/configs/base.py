"""Config dataclasses of the IDKD framework, mirrored field for field from
the JAX package's ``configs/base.py`` so a run description means the same
thing on either side.

* :class:`ModelConfig` — one composable description of every supported
  architecture family plus the paper's ResNet20-EvoNorm classifier; this
  package runs the ResNet and every decoder stack (PaliGemma's patch
  prefix and prefix-LM mask, MoE, MLA and multi-token prediction
  included). ``reduced()`` derives the CPU test variant of a full
  config, as the reference's does.
* :class:`IDKDConfig` — the paper's Algorithm 1 hyper-parameters.
* :class:`TrainConfig` — one decentralized training run.
* :class:`ShapeConfig` and :data:`SHAPES` — the four assigned input
  shapes of the reference's registry.

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

    @property
    def supports_long_context(self) -> bool:
        """True when decode state is sub-linear in context (long_500k ok)."""
        return self.ssm.enabled or self.sliding_window > 0

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

    def param_count(self) -> int:
        """Analytic parameter count (Table 6's communication cost), the
        reference's formula, MoE and MLA terms included."""
        if self.arch_type == "cnn":
            # rough resnet count: conv stacks + fc
            n = 3 * 3 * self.image_channels * self.cnn_width
            w = self.cnn_width
            for si, blocks in enumerate(self.cnn_stages):
                wo = self.cnn_width * (2 ** si)
                for b in range(blocks):
                    wi = w if b == 0 else wo
                    n += 9 * wi * wo + 9 * wo * wo
                    if wi != wo:
                        n += wi * wo
                w = wo
            n += w * self.num_classes
            return n
        d = self.d_model
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.num_codebooks:
            n += (self.num_codebooks - 1) * self.vocab_size * d
        per_layer = 0
        hd = self.resolved_head_dim
        if self.mla.enabled:
            m = self.mla
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            if m.q_lora_rank:
                per_layer += (d * m.q_lora_rank
                              + m.q_lora_rank * self.num_heads * qd)
            else:
                per_layer += d * self.num_heads * qd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += (m.kv_lora_rank * self.num_heads
                          * (m.qk_nope_head_dim + m.v_head_dim))
            per_layer += self.num_heads * m.v_head_dim * d
        elif not self.is_attention_free:
            per_layer += d * hd * (self.num_heads + 2 * self.num_kv_heads)
            per_layer += self.num_heads * hd * d
        if self.ssm.enabled:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.ngroups * s.state_size
            per_layer += d * (2 * d_in + 2 * s.ngroups * s.state_size
                              + nheads)
            per_layer += conv_dim * s.conv_width
            per_layer += d_in * d + 2 * nheads
        glu = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        if self.moe.enabled:
            m = self.moe
            moe_layers = self.num_layers - m.first_k_dense
            n += moe_layers * (
                m.num_experts * glu * d * m.moe_d_ff
                + m.num_shared_experts * glu * d * m.moe_d_ff
                + m.dense_residual_ff * glu * d
                + d * m.num_experts)
            n += m.first_k_dense * glu * d * self.d_ff
            return n + self.num_layers * per_layer
        if self.d_ff:
            per_layer += glu * d * self.d_ff
        return n + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k only)."""
        if not self.moe.enabled:
            return self.param_count()
        m = self.moe
        glu = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        routed = (self.num_layers - m.first_k_dense) * glu \
            * self.d_model * m.moe_d_ff
        return (self.param_count() - routed * m.num_experts
                + routed * m.num_experts_per_tok)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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

    algorithm: str = "qg-dsgdm-n"   # centralized|dsgd|dsgdm|qg-dsgdm-n|d2|
                                    # gradient-tracking|relaysgd
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

    # compressed and compute-overlapped gossip (core.mixing)
    compression: str = "none"       # none | topk | randk (sparsified wire
                                    # with error feedback)
    compression_frac: float = 0.01  # kept share of each leaf's elements
    gossip: str = "sync"            # sync | delayed (one-step-stale mixing)

    @property
    def compression_spec(self):
        """None, or the ``(kind, frac)`` pair of a compressed wire."""
        if self.compression in (None, "", "none"):
            return None
        return (self.compression, self.compression_frac)
