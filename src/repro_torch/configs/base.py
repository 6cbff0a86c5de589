"""Architecture + sparsity configuration dataclasses.

A field-for-field copy of ``repro/configs/base.py`` (``ArchConfig``,
``SparsityConfig``, ``ShapeConfig``): the port keeps its own copy so it never imports the
JAX package. ``dataclasses.asdict`` of a config here equals that of its
counterpart there (``tests/test_torch_configs.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """How SRigL (or a baseline) is applied to the model's linear layers."""

    method: Literal["srigl", "rigl", "set", "dense"] = "srigl"
    sparsity: float = 0.9
    distribution: Literal["erk", "uniform"] = "erk"
    gamma_sal: float = 0.3            # 0.95 for ViT-like (paper Sec 4.3)
    ablation: bool = True
    sparse_qkv: bool = False          # paper keeps MHA input projections dense
    sparse_embeddings: bool = False   # never sparsified in the paper
    delta_t: int = 100
    alpha: float = 0.3                # initial drop fraction
    t_end_fraction: float = 0.75
    grad_accum_for_saliency: int = 1  # paper D.2 uses 8 for ResNet-50


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "vit"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # --- hybrid (Zamba2): one shared attention block every N ssm blocks ---
    hybrid_attn_every: int = 6

    # --- attention pattern ---
    qk_norm: bool = False
    sliding_window: int = 0           # 0 = full/global attention
    local_global_ratio: int = 0       # gemma3: 5 local layers per 1 global
    rope_theta: float = 10_000.0
    mrope: bool = False               # qwen2-vl multimodal RoPE (3 position axes)

    # --- modality frontend stubs ---
    frontend: Literal["none", "vlm", "audio", "vit"] = "none"
    n_codebooks: int = 0              # musicgen EnCodec codebooks
    n_classes: int = 0                # ViT classification head

    # --- distribution ---
    fsdp: bool = False   # ZeRO-3: shard the non-TP weight dim over 'data'

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    causal: bool = True               # ViT is encoder-only (False)
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"      # storage dtype (bf16 for the 100B+ archs)

    # --- perf knobs ---
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    ssd_chunk: int = 256
    moe_group_size: int = 2048
    ce_chunk: int = 512               # chunked cross-entropy (big-vocab archs)
    remat: str = "block"              # "none" | "block" — activation ckpt policy
    microbatches: int = 1             # gradient-accumulation chunks per step
    optimizer: str = "adamw"          # "adamw" | "sgdm" | "adafactor"

    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)

    # The LM-head vocab axis is padded to a multiple of this; padded logit
    # columns are masked to -inf and tokens never index padded rows.
    pad_vocab_to: int = 128

    @property
    def vocab_padded(self) -> int:
        if self.pad_vocab_to and self.vocab_size > 1:
            return -(-self.vocab_size // self.pad_vocab_to) * self.pad_vocab_to
        return self.vocab_size

    # Head padding for tensor parallelism (padded heads give exact-zero
    # output); 0 = no padding.
    pad_heads_to: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("GQA group must divide n_heads")

    @property
    def n_heads_padded(self) -> int:
        if self.pad_heads_to and self.n_heads % self.pad_heads_to:
            return -(-self.n_heads // self.pad_heads_to) * self.pad_heads_to
        return self.n_heads

    @property
    def n_kv_heads_padded(self) -> int:
        if self.n_kv_heads == self.n_heads:  # MHA: kv pads with q
            return self.n_heads_padded
        return self.n_kv_heads

    @property
    def head_to_kv(self) -> tuple:
        """Static map q-head -> kv-head (padded heads point at kv 0)."""
        g = self.n_heads // self.n_kv_heads
        base = [h // g for h in range(self.n_heads)]
        if self.n_kv_heads == self.n_heads:
            base += list(range(self.n_heads, self.n_heads_padded))
        else:
            base += [0] * (self.n_heads_padded - self.n_heads)
        return tuple(base)

    @property
    def q_dim(self) -> int:
        return self.n_heads_padded * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads_padded * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def window_for_layer(self, layer: int) -> int:
        """Per-layer attention window (gemma3 local:global interleave)."""
        if self.local_global_ratio and self.sliding_window:
            return 0 if (layer % (self.local_global_ratio + 1) == self.local_global_ratio) \
                else self.sliding_window
        return self.sliding_window

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the evaluation grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
