"""mamba2-130m — SSD (state-space duality), attn-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=1, n_kv_heads=1, head_dim=64,
        d_ff=0, vocab_size=50_280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
        # small SSD chunks shrink the intra-chunk quadratic (B, Q, Q, H)
        # tensors
        ssd_chunk=64,
        tie_embeddings=True,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        ssd_chunk=16, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32",
    )
