"""Trees of arrays between the JAX reference's layout and the port's tensors.

The reference keys its params and masks as nested dicts whose flattened
paths are ``"/"``-joined (``repro/train/checkpoint.py:_flatten``); a format
leaf flattens to its array fields (``…/values``, ``…/indices``). The port
keeps the same paths and the same stacked layout, so a tree converts leaf
for leaf. This module imports no JAX: the caller turns JAX arrays into
numpy arrays (``np.asarray``) before handing them over.

Every leaf crosses at its own dtype, so a block's params need nothing of
their own here: the SSM mixer's ``a_log``, ``d_skip`` and ``dt_bias`` stay
float32 in a bf16 model, as the reference keeps them.
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


def _tensors(tree, device):
    """Nested numpy -> tensors: 0-dim counters on the CPU, the rest on ``device``."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return _to_tensor(tree, "cpu" if np.ndim(tree) == 0 else device)


def train_state_from_jax_numpy(state, device="cpu"):
    """The reference's ``TrainState`` (numpy leaves, e.g. after
    ``jax.tree.map(np.asarray, state)``) as the port's, tensors on
    ``device``; ``step``, ``opt_state/count`` and ``mask_versions`` as CPU
    int32 tensors and the ``rng`` key as a uint32 numpy array."""
    from repro_torch.train.state import TrainState
    d = state._asdict() if hasattr(state, "_asdict") else dict(state)
    trees = {k: from_jax_numpy(d[k], device) if d[k] else {}
             for k in ("params", "masks", "neuron_active", "grad_accum")}
    return TrainState(step=_to_tensor(d["step"], "cpu"), opt_state=_tensors(d["opt_state"], device),
                      mask_versions={k: _to_tensor(v, "cpu") for k, v in d["mask_versions"].items()},
                      rng=np.array(d["rng"], dtype=np.uint32), **trees)


def train_state_to_jax_numpy(state) -> dict:
    """The port's ``TrainState`` as the reference's fields, nested numpy
    (``TrainState(**jax.tree.map(jnp.asarray, out))`` on that side)."""
    def arr(t):
        if isinstance(t, dict):
            return {k: arr(v) for k, v in t.items()}
        if isinstance(t, np.ndarray):
            return t.copy()
        t = t.detach().cpu()
        return (t.float() if t.dtype in RAW_BITS else t).numpy()
    return {k: arr(v) for k, v in state._asdict().items()}
