"""Condensed constant fan-in matmul: wrapper of the Hopper kernel K1.

``y[b, n] = sum_k f32(x[b, indices[n, k]]) * f32(values[n, k])``, cast to
``x.dtype``: the function of ``repro/kernels/condensed_matmul.py::_fwd_kernel``.
The CUDA kernel is ``csrc/condensed_matmul.cu`` (its header note gives its
byte bound and design); ``ref.condensed_matmul_ref`` is its plain version.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises — there is no fallback. As in the reference,
``B <= SMALL_BATCH_MAX`` takes the decode launch (the whole batch in one
block row) and larger batches the tiled launch (8-row batch tiles); a
caller-given ``block_b`` forces the tiled launch. The two are bitwise equal.

``condensed_matmul.launches`` counts kernel launches (never plain-version
calls), so a run can show that its sparse linears went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

SMALL_BATCH_MAX = 8
BLOCK_ROWS = (1, 2, 4, 8)
# dynamic shared memory a Hopper block may opt into (227 KB)
SMEM_BYTES = 232_448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS_PER_BLOCK = 8  # kWarps in csrc/condensed_matmul.cu


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("condensed_matmul")
    fn = lib.condensed_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.condensed_matmul_error_string.argtypes = [ctypes.c_int]
    lib.condensed_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor) -> None:
    if x.ndim != 2 or values.ndim != 2 or indices.shape != values.shape:
        raise ValueError(f"need x (B, d_in) and values/indices (n_out, k); got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}, "
                         f"{tuple(indices.shape)}")
    if x.dtype not in _DTYPE_CODES or values.dtype != x.dtype:
        raise TypeError(f"x and values must both be float32 or bfloat16; got "
                        f"{x.dtype}, {values.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (x.device == values.device == indices.device):
        raise ValueError("x, values and indices must be on one device")
    if not (x.is_contiguous() and values.is_contiguous() and indices.is_contiguous()):
        raise ValueError("x, values and indices must be contiguous")


def _fit_rows(rows: int, d_in: int, itemsize: int) -> int:
    """Largest block row count <= ``rows`` whose x tile fits shared memory."""
    for r in reversed(BLOCK_ROWS):
        if r <= rows and r * d_in * itemsize <= SMEM_BYTES:
            return r
    raise ValueError(f"d_in={d_in} is too wide to stage one row of x in "
                     f"shared memory ({SMEM_BYTES} bytes)")


def _launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
            block_rows: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the condensed_matmul kernel runs on CUDA tensors, "
                         f"not {x.device}")
    b, d_in = x.shape
    n_out, k = values.shape
    y = torch.empty((b, n_out), dtype=x.dtype, device=x.device)
    if b == 0 or n_out == 0:
        return y
    grid_rows = -(-b // block_rows)
    # neurons per warp: enough blocks for two waves over the SMs, more
    # neurons per block (fewer x tiles staged) when there are blocks to spare
    per_warp = max(1, min(8, n_out * grid_rows
                          // (_WARPS_PER_BLOCK * 2 * _sm_count(x.device.index or 0))))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.condensed_matmul_fwd(
            x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
            b, d_in, n_out, k, _DTYPE_CODES[x.dtype], block_rows, per_warp,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("condensed_matmul kernel launch failed: "
                           + lib.condensed_matmul_error_string(err).decode())
    condensed_matmul.launches += 1
    return y


def condensed_matmul(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                     *, block_b: int | None = None) -> torch.Tensor:
    """Forward condensed matmul. x (B, d_in); values, indices (n_out, k) -> (B, n_out).

    Every index must lie in [0, d_in); the kernel does not check it (the
    condensed export guarantees it).

    ``block_b=None``: B <= SMALL_BATCH_MAX goes to the decode launch, larger
    batches to the tiled launch with 8-row tiles. An explicit ``block_b``
    (1, 2, 4 or 8) forces the tiled launch at that tile (shrunk where the
    x tile would not fit shared memory).
    """
    _check(x, values, indices)
    if block_b is not None and block_b not in BLOCK_ROWS:
        raise ValueError(f"block_b must be one of {BLOCK_ROWS}, got {block_b}")
    if x.device.type == "cpu":
        return ref.condensed_matmul_ref(x, values, indices)
    if block_b is None and x.shape[0] <= SMALL_BATCH_MAX:
        return condensed_matmul_decode(x, values, indices)
    rows = SMALL_BATCH_MAX if block_b is None else block_b
    return _launch(x, values, indices, _fit_rows(rows, x.shape[1], x.element_size()))


condensed_matmul.launches = 0


def condensed_matmul_decode(x: torch.Tensor, values: torch.Tensor,
                            indices: torch.Tensor) -> torch.Tensor:
    """Decode launch: the whole batch (rounded up to a power of two, at most
    8 rows) in one block row, the grid over neuron tiles only. Bitwise equal
    to the tiled launch: each row's reduction order is independent of the
    batch tiling."""
    _check(x, values, indices)
    if x.device.type == "cpu":
        return ref.condensed_matmul_ref(x, values, indices)
    b = x.shape[0]
    rows = next(r for r in BLOCK_ROWS if r >= min(max(b, 1), SMALL_BATCH_MAX))
    return _launch(x, values, indices, _fit_rows(rows, x.shape[1], x.element_size()))
