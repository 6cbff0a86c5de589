"""zamba2-7b — Mamba2 blocks + shared attention block [arXiv:2411.15242].

81 Mamba2 layers; one *shared-weight* attention+MLP block is applied after
every 6th Mamba2 layer (13 applications), matching the Zamba2 shared-block
pattern. ssm_state=64.
"""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14_336, vocab_size=32_000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
        hybrid_attn_every=6,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        hybrid_attn_every=2, ssd_chunk=16,
        ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16, dtype="float32",
    )
