"""internlm2-20b — dense GQA transformer [arXiv:2403.17297]."""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16_384, vocab_size=92_544,
        fsdp=True, param_dtype="bfloat16", optimizer="adafactor",
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32",
    )
