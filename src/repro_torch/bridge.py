"""Trees of arrays between the JAX reference's layout and the port's tensors.

The reference keys its params and masks as nested dicts whose flattened
paths are ``"/"``-joined (``repro/train/checkpoint.py:_flatten``); a format
leaf flattens to its array fields (``…/values``, ``…/indices``). The port
keeps the same paths and the same stacked layout, so a tree converts leaf
for leaf. This module imports no JAX: the caller turns JAX arrays into
numpy arrays (``np.asarray``) before handing them over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse import formats as F


def flatten(tree, prefix: tuple = ()) -> dict:
    """Nested dict -> {"a/b/c": leaf}; a format leaf gives its arrays
    (``…/values``, ``…/indices``, ``…/out_index``, ``…/active_index``…)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
    elif isinstance(tree, F.SparseFormat):
        for name, arr in tree.arrays().items():
            out["/".join(prefix + (name,))] = arr
    else:
        out["/".join(prefix)] = tree
    return out


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    out: dict = {}
    for key, leaf in flat.items():
        *parents, last = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


# the float types numpy lacks, with the unsigned numpy type of their width:
# an ml_dtypes array of one (by the same name) or a raw-bytes array of that
# width (npz's |V2, |V1) holds its bits
RAW_BITS = {torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in RAW_BITS}


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy (JAX hands out read-only views)
    if arr.dtype.name in _BY_NAME:  # ml_dtypes' bf16 / fp8: reinterpret the bits
        dtype = _BY_NAME[arr.dtype.name]
        return torch.from_numpy(arr.view(RAW_BITS[dtype])).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def from_jax_numpy(tree: dict, device="cpu") -> dict:
    """The reference's params or masks (numpy leaves, nested or "/"-keyed)
    as the port's nested tree of tensors on ``device``, same layout."""
    return unflatten({k: _to_tensor(v, device) for k, v in flatten(tree).items()})


def to_jax_numpy(tree: dict) -> dict:
    """The port's tree as nested numpy arrays under the reference's paths.

    bfloat16 and float8_e4m3fn tensors come back as float32 (exact);
    numpy has neither type.
    """
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype in RAW_BITS else t).numpy()
    return unflatten({k: arr(v) for k, v in flatten(tree).items()})
