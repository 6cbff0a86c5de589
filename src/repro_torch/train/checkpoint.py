"""Step-tagged atomic checkpoints (port of ``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, N zero-padded to
ten digits. ``<dir>/step_<N>.tmp`` is written first and renamed, so a crash
mid-save never leaves a half-written checkpoint; ``keep`` bounds how many
stay. Arrays are keyed by the ``"/"``-joined paths of the state (a format
leaf's arrays under their field names, ``…/values``, ``…/scales``…), the
layout the JAX package writes, so each side restores the other's files,
a whole ``train.state.TrainState`` included (``opt_state/mu/…``,
``opt_state/count``, ``mask_versions/…`` and the uint32 ``rng`` key, which
restores as a numpy array where the template holds one).

numpy has no bfloat16 or float8: the reference's ``np.savez`` writes those
arrays as raw bytes (``|V2``, ``|V1``), and so does ``save`` here. ``restore``
takes every array's dtype from the template leaf; a raw-bytes array is
reinterpreted through ``uint16`` (bf16) or ``uint8`` (fp8), never converted.
Where a format's archive and template differ in quantized versus float
storage, the array keeps the archive's dtype and the format's
``restore_finalize`` quantizes or dequantizes it, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.bridge import RAW_BITS
from repro_torch.sparse import formats as F

# a raw-bytes array's width -> the torch dtype it holds
_BY_WIDTH = {np.dtype(bits).itemsize: dtype for dtype, bits in RAW_BITS.items()}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree, prefix=()) -> dict:
    """{"a/b/c": leaf} of a state (dicts, NamedTuples, lists, format leaves)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (f"#{i}",)))
    elif isinstance(tree, F.SparseFormat):
        # array fields under their names; None fields are not saved, and the
        # static geometry comes from the restore template
        for k in tree._array_fields:
            out.update(_flatten(getattr(tree, k), prefix + (str(k),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype in RAW_BITS:  # raw bytes, as np.savez writes ml_dtypes arrays
        raw = t.reshape(-1).view(torch.uint8).numpy().view(f"V{t.element_size()}")
        return raw.reshape(t.shape)
    return t.numpy()


def save(ckpt_dir: str, state, keep: int = 3) -> str:
    """Write ``state`` (with a ``step``) as step_<N>; keep the newest ``keep``."""
    step = int(state.step)
    flat = _flatten(state._asdict() if _is_namedtuple(state) else state)
    arrays = {k: _to_numpy(v) for k, v in flat.items() if v is not None}
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _archive_tensor(arr: np.ndarray) -> torch.Tensor:
    """An archived array as a tensor of the dtype it holds."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize not in _BY_WIDTH:
            raise TypeError(f"no dtype is stored as {arr.dtype.str}")
        dtype = _BY_WIDTH[arr.dtype.itemsize]
        return torch.from_numpy(np.ascontiguousarray(arr).view(RAW_BITS[dtype])).view(dtype)
    return torch.from_numpy(np.array(arr))


def _like(t: torch.Tensor, template, *, keep_dtype: bool = False):
    """``t`` on the template leaf's device, at its dtype unless ``keep_dtype``;
    a numpy template leaf (a ``TrainState``'s ``rng`` key) gets a numpy array."""
    if isinstance(template, np.ndarray):
        return t.numpy().astype(template.dtype)
    if not isinstance(template, torch.Tensor):
        return t
    return t.to(device=template.device, dtype=None if keep_dtype else template.dtype)


def restore(ckpt_dir: str, step: int, template):
    """The checkpoint of ``step`` in the structure of ``template`` (a
    NamedTuple state or a nested dict): each array at its template leaf's
    dtype and on its device. Keys the archive lacks keep the template's
    leaf; a format's statics come from the template."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}

    def leaf(key, tmpl):
        if key not in data:
            return tmpl  # a field the archive predates keeps its template value
        return _like(_archive_tensor(data[key]), tmpl)

    def build_format(fmt: F.SparseFormat, prefix):
        device = next(iter(fmt.arrays().values())).device
        missing, fields = set(), {}
        for name in fmt._array_fields:
            key, tmpl = "/".join(prefix + (name,)), getattr(fmt, name)
            if key not in data:
                missing.add(name)
            elif tmpl is None:
                # a field the template does not carry (a float template's
                # scales): adopt the archive's, for restore_finalize
                fields[name] = _archive_tensor(data[key]).to(device)
            else:
                arr = _archive_tensor(data[key])
                # quantized vs float storage: keep the archive's dtype, which
                # restore_finalize reconciles (a cast would corrupt the codes)
                mismatch = F.is_quantized_storage(arr) != F.is_quantized_storage(tmpl)
                fields[name] = _like(arr, tmpl, keep_dtype=mismatch)
        out = dataclasses.replace(fmt, **fields)
        if missing:
            out = out.rebuild_missing(frozenset(missing))
        return out.restore_finalize()

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if _is_namedtuple(tree):
            return type(tree)(**{k: build(getattr(tree, k), prefix + (str(k),))
                                 for k in tree._fields})
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (f"#{i}",)) for i, v in enumerate(tree))
        if isinstance(tree, F.SparseFormat):
            return build_format(tree, prefix)
        return leaf("/".join(prefix), tree)

    return build(template)
