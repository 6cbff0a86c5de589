"""gemma3-1b — 5:1 local:global sliding-window attention [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab_size=262_144,
        sliding_window=512, local_global_ratio=5,
        rope_theta=1_000_000.0, tie_embeddings=True, pad_heads_to=16,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16, local_global_ratio=2,
        ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16, dtype="float32",
    )
