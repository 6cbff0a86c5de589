"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49_155,
        n_experts=32, top_k_experts=8,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256, n_experts=4, top_k_experts=2,
        moe_group_size=64, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32",
    )
