"""mistral-large-123b — dense GQA transformer [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ArchConfig, SparsityConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=28_672, vocab_size=32_768,
        param_dtype="bfloat16", optimizer="adafactor",
        fsdp=True,
        # larger chunks: fewer trips through the chunked attention and loss
        ce_chunk=2048, attn_q_chunk=2048, attn_kv_chunk=2048,
        sparsity=SparsityConfig(method="srigl", sparsity=0.9, gamma_sal=0.3),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, ce_chunk=16, attn_q_chunk=16, attn_kv_chunk=16,
        dtype="float32", param_dtype="float32",
    )
