"""qwen3-1.7b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab_size=151_936, qk_norm=True,
        rope_theta=1_000_000.0, tie_embeddings=True,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32",
    )
