"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].

param_dtype bf16 + adafactor: at 1T params the optimizer state must be
factored and the weights stored in bf16 to fit the reference's 512 x 16 GiB
mesh.
"""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
        d_ff=2048, vocab_size=163_840,
        n_experts=384, top_k_experts=8,
        param_dtype="bfloat16", optimizer="adafactor",
        fsdp=True,
        moe_group_size=4096,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256, n_experts=8, top_k_experts=2,
        moe_group_size=64, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32", param_dtype="float32",
    )
