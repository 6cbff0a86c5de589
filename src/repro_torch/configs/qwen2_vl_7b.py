"""qwen2-vl-7b — M-RoPE, dynamic-resolution VLM backbone [arXiv:2409.12191].

The vision frontend is a stub: a batch may carry precomputed patch
embeddings (``frontend_embeds``), added to the token embeddings, and the
three M-RoPE position streams (t, h, w) (``mrope_positions``).
"""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18_944, vocab_size=152_064, mrope=True, pad_heads_to=16,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32",
    )
