"""musicgen-medium — decoder-only over EnCodec tokens (4 codebooks) [arXiv:2306.05284].

EnCodec frontend is a STUB: inputs are the 4 parallel codebook token streams
(delay-pattern preprocessing assumed done upstream); embeddings are summed and
4 separate heads predict the next token of each codebook.
"""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048, n_codebooks=4, pad_heads_to=16,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, n_codebooks=2,
        ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16, dtype="float32",
    )
