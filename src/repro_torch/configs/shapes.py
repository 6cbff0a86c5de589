"""The input-shape suite: 4 cells per LM architecture (a copy of
``repro/configs/shapes.py``)."""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}

# long_500k requires sub-quadratic attention: run only for SSM / hybrid /
# sliding-window archs; pure full-attention archs skip it.
LONG_OK_FAMILIES = ("ssm", "hybrid")
LONG_OK_ARCHS = ("mamba2-130m", "zamba2-7b", "gemma3-1b")


def shapes_for(arch_name: str, family: str, causal: bool = True):
    out = [TRAIN_4K]
    if causal:  # encoder-only archs (ViT) have no decode/prefill cells
        out += [PREFILL_32K, DECODE_32K]
        if arch_name in LONG_OK_ARCHS or family in LONG_OK_FAMILIES:
            out.append(LONG_500K)
    return out
