"""ViT-B/16 — the paper's own transformer architecture (Table 4).

Encoder-only; patch frontend stubbed (precomputed patch embeddings, 197
tokens for 224x224/16 + CLS). Paper recipe: uniform sparsity distribution,
gamma_sal = 0.95, dense QKV input projections.
"""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="vit-b16", family="vit", causal=False,
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=1, n_classes=1000, frontend="vit", pad_heads_to=16,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.95,
                                distribution="uniform"),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, n_classes=10,
        ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16, dtype="float32",
    )
