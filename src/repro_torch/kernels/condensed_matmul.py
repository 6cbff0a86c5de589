"""Condensed constant fan-in matmul: wrappers of the Hopper kernels K1, K2 and K3.

K1: ``y[b, n] = sum_k f32(x[b, indices[n, k]]) * f32(values[n, k])``, cast to
``x.dtype``: the function of ``repro/kernels/condensed_matmul.py::_fwd_kernel``.
K2 (``scales=`` given): ``values`` are int8 or float8_e4m3fn codes and the
per-neuron float32 scale multiplies each neuron's k-sum before the cast, the
function of ``_fwd_scaled_kernel``. The CUDA source is
``csrc/condensed_matmul.cu`` over the body ``csrc/condensed_rows.cuh`` (its
header note gives the byte bound and the design): in bfloat16 the slots
are densified into bf16 panels in shared memory and multiplied on the
tensor cores, one chain per d_in split added in split order
(``gather_geometry``) -- a cluster of the splits' blocks at the tiled
launch (past d_in about 36k with each split's panel built in passes, so
any d_in runs), every split of 16 or 8 neurons in one block at decode up
to d_in 6656; in float32 a warp per neuron gathers on the CUDA cores.
``ref.condensed_matmul_ref`` and ``ref.condensed_matmul_scaled_ref`` are
the plain versions.
K1-moe / K2-moe (``condensed_matmul_grouped``): K1 / K2 over an MoE
layer's E experts in one launch, x (E, M, d_in) and values, indices (E,
n_out, k) (scales (E, n_out)), the function of the reference's ``jax.vmap``
of ``_fwd_kernel`` / ``_fwd_scaled_kernel`` over the experts. The expert is
a grid axis of its own and each expert runs the one-expert launch's chains,
so the grouped launch equals E launches of K1 (K2) bitwise; its source is
``csrc/condensed_matmul_grouped.cu`` (the grouped instantiations of the same
bodies) and ``ref.condensed_matmul_grouped_ref`` is the plain version.
K3 (``condensed_matmul_dw``): the values gradient,
``dw[n, k] = sum_b f32(dy[b, n]) * f32(x[b, indices[n, k]])`` in float32,
the function of ``_dw_kernel``; its source is ``csrc/condensed_dw.cu`` and
``ref.condensed_matmul_dw_ref`` its plain version. K3-moe
(``condensed_matmul_dw_grouped``): K3 over an MoE layer's E experts in
one launch, dy (E, B, n_out), x (E, B, d_in), indices (E, n_out, k), the
reference's ``jax.vmap`` of ``_dw_kernel``; each expert's tiles and
workspace slice are the one-expert launch's, so it equals E launches of K3
bitwise (``ref.condensed_matmul_dw_grouped_ref`` is the plain version).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises — there is no fallback. A tensor on the meta
device (the dry run's, ``launch/dryrun.py``) runs nothing: the wrapper
returns the kernel's output, and allocates the workspace it would, as meta
tensors, never through the plain version, whose intermediates are not the
kernel's. As in the reference,
``B <= SMALL_BATCH_MAX`` takes the decode launch (the whole batch in one
block row) and larger batches the tiled launch; a caller-given ``block_b``
(the batch rows of a block, one of ``GATHER_ROWS[dtype]``) forces the tiled
launch. The tiled launch takes ``TILED_ROWS[dtype]`` rows a block: 128 in
bfloat16 (the slots read once per call up to B = 128), 8 in float32.
``block_n`` sets the neurons of a block (``neuron_tiles``). Every launch of
one shape is bitwise equal to every other, so the launch is a knob that
``sparse.autotune`` searches over ``gather_candidates``.

``condensed_matmul.launches`` counts K1's launches,
``condensed_matmul.scaled_launches`` K2's, ``condensed_matmul_grouped.launches``
and ``.scaled_launches`` K1-moe's and K2-moe's and
``condensed_matmul_dw.launches`` K3's and ``condensed_matmul_dw_grouped.launches``
K3-moe's (never plain-version calls), so a run can show that its sparse linears
went through the kernel it expects; ``counters`` counts a launch captured in
a CUDA graph once for each replay.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import counters
from repro_torch.kernels import ref

SMALL_BATCH_MAX = 8
# the decode launch's batch tiles (B rounded up to a power of two)
BLOCK_ROWS = (1, 2, 4, 8)
# the batch rows of a block each dtype takes (``block_b``), and those of the
# tiled launch: bfloat16 any power of two up to 128 (one or sixteen n8
# tiles of the tensor-core kernel), float32 the CUDA-core kernel's x tiles
GATHER_ROWS = {torch.bfloat16: (1, 2, 4, 8, 16, 32, 64, 128), torch.float32: BLOCK_ROWS}
TILED_ROWS = {torch.bfloat16: 128, torch.float32: 8}
# dynamic shared memory a Hopper block may opt into (227 KB)
SMEM_BYTES = 232_448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the stored-code types K2 reads (1-byte), with a float32 scale per row
_VALUE_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
# The bfloat16 kernels' layout constants (csrc/condensed_rows.cuh, whose
# mma_smem and decode_smem the two formulas below equal; chip_smoke.py
# checks them against condensed_matmul_smem_bytes): blocks of _THREADS; d_in
# splits of a multiple of CHUNK_ROWS inputs, at most MAX_SPLITS (one cluster
# adds them); x through a ring of RING_STAGES chunks, X_ROW_BYTES a batch
# row; an outbox of OUTBOX_ENTRIES slots (_THREADS x kBatch loads); a
# gather_mma block holds one of NEURON_TILES neurons, a decode block
# DECODE_NEURONS (or 8)
_WARPS_PER_BLOCK = 8
_THREADS = 32 * _WARPS_PER_BLOCK
CHUNK_ROWS = 64
MAX_SPLITS = 8
RING_STAGES = 3
X_ROW_BYTES = CHUNK_ROWS * 2 + 16
NEURON_TILES = (64, 32, 16)
DECODE_LOADS = 20  # kBatch: slot loads a thread keeps in flight
OUTBOX_ENTRIES = _THREADS * DECODE_LOADS
DECODE_NEURONS = 16
# dynamic shared memory three blocks may hold together on an SM (228 KB an
# SM, 1 KB of it reserved a block)
THREE_BLOCKS_SMEM = 233_472 - 3 * 1024
# float32's neurons a block (``block_n``): 8 warps of 1 to 8 neurons each;
# the search times the powers of two among them
F32_NEURONS = tuple(range(8, 65, 8))
F32_SEARCHED = tuple(n for n in F32_NEURONS if n & (n - 1) == 0)
# an H100 SXM's SMs: the card a search run on the CPU lists its launches for
DEFAULT_SM_COUNT = 132


class GatherGeometry(NamedTuple):
    """How K1, K2, K4 and K2-coa cut one shape, from d_in and the dtype only.

    bfloat16: d_in in ``splits`` splits of ``split_rows`` inputs (a multiple
    of 64, at most 8: each output sums its splits' tensor-core chains in
    split order). gather_mma (the tiled launch) takes ``block_neurons``
    neurons a block, a cluster of the splits' blocks, and ``smem_bytes`` of
    dynamic shared memory at 128 batch rows; its panel holds ``pass_rows``
    inputs of a split, in ``passes`` passes where that is less than the
    split. ``decode_smem_bytes`` is that of the decode kernel, which runs
    every split of 16 neurons in one block with ``decode_loads`` slot loads
    a thread in flight (both None where it does not fit: the decode launch
    then runs gather_mma too). float32: one chain over the row's slots
    (``split_rows`` = d_in, one split), the neurons a block set per launch
    (``block_neurons`` None), ``smem_bytes`` the tiled launch's x tile and
    no decode kernel of its own."""
    split_rows: int
    splits: int
    block_neurons: int | None
    smem_bytes: int
    pass_rows: int | None = None
    passes: int = 1
    decode_smem_bytes: int | None = None
    decode_loads: int | None = None


def mma_smem_bytes(tile_rows: int, block_neurons: int, pass_rows: int, passes: int = 1) -> int:
    """Dynamic shared memory of a block of the bfloat16 tiled kernel
    (``mma_smem`` in csrc/condensed_rows.cuh): the x ring, the bf16 panel of
    ``pass_rows`` inputs (rows padded by 16 bytes), the outbox of slots
    bucketed by split (OUTBOX_ENTRIES of 4 bytes, each bucket 16-byte
    aligned), a duplicate bitmap a panel row, two flags a neuron, the bucket
    counts and places (4 x 8 ints, then 8 ints and 2 packed counts a warp),
    and where ``passes`` > 1 a stash of each thread's block_neurons / 2
    accumulators."""
    rows = -(-tile_rows // 8) * 8
    stash = _THREADS * (block_neurons // 2) * 4 if passes > 1 else 0
    return (RING_STAGES * rows * X_ROW_BYTES + block_neurons * (2 * pass_rows + 16)
            + (OUTBOX_ENTRIES + 4 * MAX_SPLITS) * 4
            + block_neurons * -(-pass_rows // 32) * 4 + block_neurons * 8
            + 4 * MAX_SPLITS * 4 + _WARPS_PER_BLOCK * (MAX_SPLITS * 4 + 2 * 8) + stash)


def decode_smem_bytes(split_rows: int, splits: int) -> int:
    """Dynamic shared memory of the bfloat16 decode kernel (``decode_smem``
    in csrc/condensed_rows.cuh): a panel of DECODE_NEURONS rows over every
    split, a scratch that holds in turn the duplicate bitmaps, each warp's
    x buffer (8 rows of a 64-input chunk) and the splits' partial tiles (8
    batch rows), and a flag a neuron."""
    width = split_rows * splits
    scratch = max(DECODE_NEURONS * width // 32 * 4, 8 * 8 * CHUNK_ROWS * 2,
                  MAX_SPLITS * 8 * DECODE_NEURONS * 4)
    return DECODE_NEURONS * (2 * width + 16) + scratch + DECODE_NEURONS * 4


def _outbox_fits(neurons: int, splits: int, pass_rows: int) -> bool:
    """An outbox entry holds a block's local row (ceil(neurons / splits)
    rows) in the 16 bits the value leaves beside the input in the pass."""
    return -(-neurons // splits) <= 1 << (16 - (pass_rows - 1).bit_length())


@functools.cache
def gather_geometry(d_in: int, dtype: torch.dtype) -> GatherGeometry:
    """The geometry of K1/K2/K4/K2-coa at ``d_in`` in ``dtype``. It depends
    on nothing else (never the batch, the rows or the launch), which keeps
    every launch of one shape bitwise equal. bfloat16: ``64 * ceil(d_in /
    512)`` inputs a split, so at most 8 splits; gather_mma takes the most
    neurons a block (64, 32 or 16) whose panel holds the whole split within
    227 KB at 128 batch rows (64 at d_in 2048, two blocks an SM, and at
    6144), else 16 neurons and the split in the fewest passes that fit
    (past d_in about 36k; any d_in runs); the decode kernel holds every
    split in one block up to d_in 6656, three blocks an SM up to 2048."""
    if dtype == torch.float32:
        return GatherGeometry(d_in, 1, None, _fit_rows(TILED_ROWS[dtype], d_in, 4) * d_in * 4)
    if dtype != torch.bfloat16:
        raise TypeError(f"the condensed kernels take float32 or bfloat16, not {dtype}")
    split_rows = -(-d_in // (MAX_SPLITS * CHUNK_ROWS)) * CHUNK_ROWS
    splits = -(-d_in // split_rows)
    tile = TILED_ROWS[dtype]

    def fits(neurons: int, pass_rows: int, passes: int) -> bool:
        return (mma_smem_bytes(tile, neurons, pass_rows, passes) <= SMEM_BYTES
                and _outbox_fits(neurons, splits, pass_rows))

    one_pass = [n for n in NEURON_TILES if fits(n, split_rows, 1)]
    neurons, pass_rows = (one_pass[0], split_rows) if one_pass else (NEURON_TILES[-1], None)
    ask = 2
    while pass_rows is None:  # 16 neurons, the split in passes of a multiple of 64 inputs
        rows = -(-split_rows // (ask * CHUNK_ROWS)) * CHUNK_ROWS
        if fits(neurons, rows, -(-split_rows // rows)):
            pass_rows = rows
        ask += 1
    passes = -(-split_rows // pass_rows)
    decode = decode_smem_bytes(split_rows, splits)
    return GatherGeometry(split_rows, splits, neurons,
                          mma_smem_bytes(tile, neurons, pass_rows, passes), pass_rows, passes,
                          decode if decode <= SMEM_BYTES else None,
                          (DECODE_LOADS if 3 * decode <= THREE_BLOCKS_SMEM else 2 * DECODE_LOADS)
                          if decode <= SMEM_BYTES else None)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("condensed_matmul")
    fn = lib.condensed_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.condensed_matmul_scaled_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.condensed_matmul_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.condensed_matmul_smem_bytes.restype = ctypes.c_longlong
    lib.condensed_matmul_error_string.argtypes = [ctypes.c_int]
    lib.condensed_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _grouped_lib() -> ctypes.CDLL:
    lib = _build.load("condensed_matmul_grouped")
    fn = lib.condensed_matmul_grouped_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.coa_matmul_grouped_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.condensed_matmul_grouped_error_string.argtypes = [ctypes.c_int]
    lib.condensed_matmul_grouped_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           scales: torch.Tensor | None = None) -> None:
    if x.ndim != 2 or values.ndim != 2 or indices.shape != values.shape:
        raise ValueError(f"need x (B, d_in) and values/indices (n_out, k); got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}, "
                         f"{tuple(indices.shape)}")
    if scales is None:
        if x.dtype not in _DTYPE_CODES or values.dtype != x.dtype:
            raise TypeError(f"x and values must both be float32 or bfloat16; got "
                            f"{x.dtype}, {values.dtype}")
    else:
        if x.dtype not in _DTYPE_CODES or values.dtype not in _VALUE_CODES:
            raise TypeError(f"with scales, x must be float32 or bfloat16 and values int8 "
                            f"or float8_e4m3fn codes; got {x.dtype}, {values.dtype}")
        if scales.dtype != torch.float32 or scales.shape != values.shape[:1]:
            raise TypeError(f"scales must be float32 of shape {tuple(values.shape[:1])}; got "
                            f"{scales.dtype} {tuple(scales.shape)}")
        if scales.device != x.device or not scales.is_contiguous():
            raise ValueError("scales must be contiguous and on x's device")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (x.device == values.device == indices.device):
        raise ValueError("x, values and indices must be on one device")
    if not (x.is_contiguous() and values.is_contiguous() and indices.is_contiguous()):
        raise ValueError("x, values and indices must be contiguous")


def _fit_rows(rows: int, d_in: int, itemsize: int) -> int:
    """Largest float32 block row count <= ``rows`` whose x tile fits shared
    memory."""
    for r in reversed(BLOCK_ROWS):
        if r <= rows and r * d_in * itemsize <= SMEM_BYTES:
            return r
    raise ValueError(f"d_in={d_in} is too wide to stage one row of x in "
                     f"shared memory ({SMEM_BYTES} bytes)")


def _plain(x, values, indices, scales):
    if scales is None:
        return ref.condensed_matmul_ref(x, values, indices)
    return ref.condensed_matmul_scaled_ref(x, values, indices, scales)


def _mma_fits(geo: GatherGeometry, tile_rows: int, neurons: int) -> bool:
    """Whether gather_mma takes ``neurons`` a block at ``tile_rows`` batch
    rows with the geometry's own passes: within SMEM_BYTES, an outbox
    entry holding the local row, 16 neurons when the split takes passes."""
    return ((geo.passes == 1 or neurons == NEURON_TILES[-1])
            and mma_smem_bytes(tile_rows, neurons, geo.pass_rows, geo.passes) <= SMEM_BYTES
            and _outbox_fits(neurons, geo.splits, geo.pass_rows))


def neuron_tiles(tile_rows: int, d_in: int, dtype: torch.dtype) -> tuple[int, ...]:
    """The neurons a block (``block_n``) a launch at ``tile_rows`` batch
    rows takes: bfloat16's decode kernel (a tile of at most 8 rows where it
    fits) 16 or 8, gather_mma each of ``NEURON_TILES`` that fits; float32
    ``F32_NEURONS``. None of them moves the reduction order."""
    if dtype != torch.bfloat16:
        return F32_NEURONS
    geo = gather_geometry(d_in, dtype)
    if tile_rows <= SMALL_BATCH_MAX and geo.decode_loads:
        return (DECODE_NEURONS, 8)
    return tuple(n for n in NEURON_TILES if _mma_fits(geo, tile_rows, n))


def check_block_n(block_n: int | None, tile_rows: int, d_in: int, dtype: torch.dtype) -> None:
    """Raise unless ``block_n`` is None or a block of the launch at
    ``tile_rows`` takes it: a launch that does not fit is never clamped."""
    if block_n is not None and block_n not in neuron_tiles(tile_rows, d_in, dtype):
        raise ValueError(f"block_n must be one of {neuron_tiles(tile_rows, d_in, dtype)} "
                         f"for {dtype} at d_in={d_in} and {tile_rows} batch rows a block, "
                         f"got {block_n}")


def launch_args(x: torch.Tensor, n_rows: int, block_rows: int, sm_count: int,
                block_n: int | None = None) -> tuple[int, int, int, int, int, int]:
    """(block_rows, rows_per_warp, split_rows, pass_rows, block_neurons,
    decode_loads): one launch of the shared body (csrc/condensed_rows.cuh)
    on x (B, d_in) over ``n_rows`` neurons, on a card of ``sm_count`` SMs;
    the C side makes no choice of its own. bfloat16, from
    ``gather_geometry``: a batch tile of at most 8 rows runs the decode
    kernel where it fits (``decode_loads`` > 0; its grid covers B in
    tiles), ``block_n`` neurons a block or by default 8 (the m16 tile's
    other rows zero) where the grid then still holds at most a block an
    SM, so more SMs pull from HBM at once, else 16; any other tile runs
    gather_mma (``decode_loads`` 0), ``block_n`` neurons a block or the
    geometry's. float32: the x tile shrunk to fit shared memory and
    ``block_n`` / 8 neurons a warp, or by default enough blocks for two
    waves over the SMs, more neurons a block (fewer x tiles staged) when
    there are blocks to spare. ``block_n`` must be one of
    ``neuron_tiles(block_rows, ...)``."""
    b, d_in = x.shape
    check_block_n(block_n, block_rows, d_in, x.dtype)
    if x.dtype == torch.bfloat16:
        geo = gather_geometry(d_in, x.dtype)
        if block_rows <= SMALL_BATCH_MAX and geo.decode_loads:
            neurons = block_n or (8 if -(-n_rows // 8) <= sm_count else DECODE_NEURONS)
            return block_rows, 0, geo.split_rows, 0, neurons, geo.decode_loads
        return block_rows, 0, geo.split_rows, geo.pass_rows, block_n or geo.block_neurons, 0
    rows = _fit_rows(block_rows, d_in, x.element_size())
    if block_n is None:
        per_warp = max(1, min(8, n_rows * -(-b // rows) // (_WARPS_PER_BLOCK * 2 * sm_count)))
    else:
        per_warp = block_n // _WARPS_PER_BLOCK
    return rows, per_warp, 0, 0, 0, 0


def _pow2_at_least(b: int) -> int:
    return 1 << max(int(b) - 1, 0).bit_length()


def _search_tiles(top: int, rows: tuple[int, ...]) -> list[int]:
    """The batch tiles a search times at a bucket whose rows round up to
    ``top``: from ``top`` down to a sixteenth of it (smaller tiles only
    read the weights more often)."""
    return [t for t in rows if top // 16 <= t <= top]


def gather_candidates(b: int, d_in: int, n_rows: int, dtype: torch.dtype, *,
                      sm_count: int) -> list[tuple[int | None, int]]:
    """The launches of K1, K2, K4 and K2-coa that the search times at batch
    ``b`` (a bucket) over ``n_rows`` neurons on a card of ``sm_count`` SMs
    (which the default launch depends on): ``(block_b, block_n)`` pairs,
    ``block_b`` None for the decode launch (``condensed_matmul_decode``,
    B <= SMALL_BATCH_MAX). The first is the launch the wrapper picks today,
    the baseline; then each neuron tile of the decode kernel (bfloat16, at
    batch tiles of at most 8 rows, covering B in tiles) and of gather_mma
    at each larger tile, or float32's tiles and ``F32_SEARCHED`` neurons a
    block. No tile exceeds ``b`` rounded up to a power of two, and none of
    them moves ``gather_geometry`` (``split_rows``, ``splits``,
    ``pass_rows``), so every candidate is bitwise the baseline."""
    top = min(_pow2_at_least(b), max(GATHER_ROWS[dtype]))
    small = b <= SMALL_BATCH_MAX

    def entry(tile: int, neurons: int) -> tuple[int | None, int]:
        return (None if small and tile == decode_rows(b) else tile), neurons

    base_tile = decode_rows(b) if small else TILED_ROWS[dtype]
    args = launch_args(torch.empty((b, d_in), dtype=dtype, device="meta"), n_rows,
                       base_tile, sm_count)
    cands = [entry(base_tile, args[4] if dtype == torch.bfloat16
                   else args[1] * _WARPS_PER_BLOCK)]
    if dtype == torch.bfloat16:
        tiles = _search_tiles(top, GATHER_ROWS[dtype])
        decode = gather_geometry(d_in, dtype).decode_loads
        cands += [entry(t, n) for t in tiles if t > SMALL_BATCH_MAX or not decode
                  for n in neuron_tiles(t, d_in, dtype)]
        if decode:
            cands += [entry(t, n) for t in tiles if t <= SMALL_BATCH_MAX
                      for n in neuron_tiles(t, d_in, dtype)]
    else:
        cands += [entry(t, n) for t in _search_tiles(top, BLOCK_ROWS) for n in F32_SEARCHED]
    return list(dict.fromkeys(cands))


def _launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
            scales: torch.Tensor | None, block_rows: int,
            block_n: int | None = None) -> torch.Tensor:
    b, d_in = x.shape
    n_out, k = values.shape
    if x.device.type == "meta":
        return x.new_empty((b, n_out))
    if x.device.type != "cuda":
        raise ValueError(f"the condensed_matmul kernel runs on CUDA tensors, "
                         f"not {x.device}")
    y = torch.empty((b, n_out), dtype=x.dtype, device=x.device)
    if b == 0 or n_out == 0:
        return y
    args = launch_args(x, n_out, block_rows, _sm_count(x.device.index or 0), block_n)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if scales is None:
            err = lib.condensed_matmul_fwd(
                x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
                b, d_in, n_out, k, _DTYPE_CODES[x.dtype], *args, stream)
        else:
            err = lib.condensed_matmul_scaled_fwd(
                x.data_ptr(), values.data_ptr(), indices.data_ptr(), scales.data_ptr(),
                y.data_ptr(), b, d_in, n_out, k, _DTYPE_CODES[x.dtype],
                _VALUE_CODES[values.dtype], *args, stream)
    if err:
        raise RuntimeError("condensed_matmul kernel launch failed: "
                           + lib.condensed_matmul_error_string(err).decode())
    counters.add(condensed_matmul, "launches" if scales is None else "scaled_launches")
    return y


def check_block_b(block_b: int | None, dtype: torch.dtype) -> None:
    if block_b is not None and block_b not in GATHER_ROWS[dtype]:
        raise ValueError(f"block_b must be one of {GATHER_ROWS[dtype]} for {dtype}, "
                         f"got {block_b}")


def decode_rows(b: int) -> int:
    """The decode launch's batch tile: B rounded up to a power of two."""
    return next(r for r in BLOCK_ROWS if r >= min(max(b, 1), SMALL_BATCH_MAX))


def condensed_matmul(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                     *, scales: torch.Tensor | None = None,
                     block_b: int | None = None,
                     block_n: int | None = None) -> torch.Tensor:
    """Forward condensed matmul. x (B, d_in); values, indices (n_out, k) -> (B, n_out).

    Every index must lie in [0, d_in); the kernel does not check it (the
    condensed export guarantees it). ``scales`` (n_out,) float32 marks
    ``values`` as int8/fp8 codes and runs K2.

    ``block_b=None``: B <= SMALL_BATCH_MAX goes to the decode launch, larger
    batches to the tiled launch with ``TILED_ROWS[dtype]`` batch rows a
    block (128 in bfloat16, 8 in float32). An explicit ``block_b`` (one of
    ``GATHER_ROWS[dtype]``: a power of two up to 128 in bfloat16, up to 8
    in float32, where the x tile shrinks to fit shared memory) forces the
    tiled launch at that tile; in bfloat16 a tile of at most 8 rows runs
    the decode kernel over B in tiles. ``block_n``, the neurons of a block,
    is one of ``neuron_tiles`` at that tile (None: ``launch_args``'
    default); one that does not fit raises, on the CPU too.
    """
    _check(x, values, indices, scales)
    check_block_b(block_b, x.dtype)
    if block_b is None and x.shape[0] <= SMALL_BATCH_MAX:
        return condensed_matmul_decode(x, values, indices, scales=scales, block_n=block_n)
    tile = TILED_ROWS[x.dtype] if block_b is None else block_b
    check_block_n(block_n, tile, x.shape[1], x.dtype)
    if x.device.type == "cpu":
        return _plain(x, values, indices, scales)
    return _launch(x, values, indices, scales, tile, block_n)


condensed_matmul.launches = 0
condensed_matmul.scaled_launches = 0


def condensed_matmul_decode(x: torch.Tensor, values: torch.Tensor,
                            indices: torch.Tensor, *,
                            scales: torch.Tensor | None = None,
                            block_n: int | None = None) -> torch.Tensor:
    """Decode launch: the whole batch (rounded up to a power of two, at most
    8 rows) in one block row, the grid over neuron tiles (and, in bfloat16,
    d_in splits) only. Bitwise equal to the tiled launch: each output's
    reduction order depends on d_in and the dtype alone. ``scales`` runs
    K2's decode launch; ``block_n`` as in ``condensed_matmul``."""
    _check(x, values, indices, scales)
    tile = decode_rows(x.shape[0])
    check_block_n(block_n, tile, x.shape[1], x.dtype)
    if x.device.type == "cpu":
        return _plain(x, values, indices, scales)
    return _launch(x, values, indices, scales, tile, block_n)


def grouped_tile(m: int, block_b: int | None, tiled: int) -> int:
    """The batch tile of an expert-grouped launch over M rows an expert:
    the caller's ``block_b``, else the decode launch's (M rounded up to a
    power of two) for M <= SMALL_BATCH_MAX, else ``tiled``."""
    if block_b is not None:
        return block_b
    return decode_rows(m) if m <= SMALL_BATCH_MAX else tiled


def _check_grouped(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                   scales: torch.Tensor | None) -> None:
    if x.ndim != 3 or values.ndim != 3 or indices.shape != values.shape or (
            x.shape[0] != values.shape[0]) or x.shape[0] == 0:
        raise ValueError(f"need x (E, M, d_in) and values/indices (E, n_out, k), E >= 1; got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}, {tuple(indices.shape)}")
    if scales is not None and scales.shape != values.shape[:2]:
        raise TypeError(f"scales must be float32 of shape {tuple(values.shape[:2])}; got "
                        f"{scales.dtype} {tuple(scales.shape)}")
    # one expert's slices pass the one-expert checks (dtypes, devices,
    # contiguity of the whole tensors)
    _check(x[0], values[0], indices[0], None if scales is None else scales[0])
    if not (x.is_contiguous() and values.is_contiguous() and indices.is_contiguous()
            and (scales is None or scales.is_contiguous())):
        raise ValueError("x, values, indices and scales must be contiguous")


def condensed_matmul_grouped(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                             *, scales: torch.Tensor | None = None,
                             block_b: int | None = None,
                             block_n: int | None = None) -> torch.Tensor:
    """Expert-grouped condensed matmul (K1-moe; K2-moe with ``scales``).
    x (E, M, d_in); values, indices (E, n_out, k); scales (E, n_out)
    float32 -> y (E, M, n_out), y[e] == ``condensed_matmul(x[e], values[e],
    indices[e], scales=scales[e])``, bitwise on the card.

    One launch for every expert: the launch of one expert's shape
    (``gather_geometry`` of d_in), the expert a grid axis of its own.
    ``block_b`` and ``block_n`` are ``condensed_matmul``'s and apply to
    every expert alike: ``block_b=None`` is the decode launch for M <=
    SMALL_BATCH_MAX (past d_in 6656 gather_mma at M's tile), else the tiled
    launch at ``TILED_ROWS``. The default neurons a block count every
    expert's rows. No choice moves a reduction order, so every launch of
    one shape is bitwise every other.
    """
    _check_grouped(x, values, indices, scales)
    check_block_b(block_b, x.dtype)
    e, m, d_in = x.shape
    tile = grouped_tile(m, block_b, TILED_ROWS[x.dtype])
    check_block_n(block_n, tile, d_in, x.dtype)
    if x.device.type == "cpu":
        return ref.condensed_matmul_grouped_ref(x, values, indices, scales)
    if x.device.type == "meta":
        return x.new_empty((e, m, values.shape[1]))
    if x.device.type != "cuda":
        raise ValueError(f"the condensed_matmul kernel runs on CUDA tensors, not {x.device}")
    n_out, k = values.shape[1:]
    y = torch.empty((e, m, n_out), dtype=x.dtype, device=x.device)
    if m == 0 or n_out == 0:
        return y
    args = launch_args(x[0], e * n_out, tile, _sm_count(x.device.index or 0), block_n)
    lib = _grouped_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.condensed_matmul_grouped_fwd(
            x.data_ptr(), values.data_ptr(), indices.data_ptr(),
            None if scales is None else scales.data_ptr(), y.data_ptr(), e, m, d_in, n_out, k,
            _DTYPE_CODES[x.dtype], 0 if scales is None else _VALUE_CODES[values.dtype], *args,
            stream)
    if err:
        raise RuntimeError("condensed_matmul_grouped kernel launch failed: "
                           + lib.condensed_matmul_grouped_error_string(err).decode())
    counters.add(condensed_matmul_grouped, "launches" if scales is None else "scaled_launches")
    return y


condensed_matmul_grouped.launches = 0
condensed_matmul_grouped.scaled_launches = 0


@functools.cache
def _dw_lib() -> ctypes.CDLL:
    lib = _build.load("condensed_dw")
    lib.condensed_matmul_dw.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.condensed_matmul_dw.restype = ctypes.c_int
    lib.condensed_matmul_dw_grouped.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                                                + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.condensed_matmul_dw_grouped.restype = ctypes.c_int
    lib.condensed_matmul_dw_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.condensed_matmul_dw_limits.restype = None
    lib.condensed_dw_error_string.argtypes = [ctypes.c_int]
    lib.condensed_dw_error_string.restype = ctypes.c_char_p
    return lib


_DW_TILE = 128  # K3's tiles: 128 d_in inputs by 128 neurons, a block each


@functools.cache
def dw_limits() -> tuple[int, int]:
    """(most slots a row, most d_in inputs) that one launch of K3 takes, as
    its source states them (``condensed_matmul_dw_limits``)."""
    slots, inputs = ctypes.c_int(), ctypes.c_int()
    _dw_lib().condensed_matmul_dw_limits(ctypes.byref(slots), ctypes.byref(inputs))
    return slots.value, inputs.value


class DwPieces(NamedTuple):
    """The launches of K3 that one ``condensed_matmul_dw`` call makes: one
    per (slot slice, d_in chunk), as [start, stop) ranges."""
    slots: tuple[tuple[int, int], ...]
    inputs: tuple[tuple[int, int], ...]


def dw_pieces(d_in: int, k: int, limits: tuple[int, int]) -> DwPieces:
    """Cut K3's work into launches it takes: slices of at most ``limits[0]``
    slots and d_in chunks of at most ``limits[1]`` inputs, each chunk on a
    multiple of the 128-input tile. A slot's value comes from the tile that
    holds its index, which a chunk keeps whole, so the pieces together are
    bitwise one launch over the whole shape."""
    max_slots, max_inputs = limits
    step = max(_DW_TILE, max_inputs // _DW_TILE * _DW_TILE)
    slots = tuple((s, min(k, s + max_slots)) for s in range(0, max(k, 1), max(max_slots, 1)))
    inputs = tuple((c, min(d_in, c + step)) for c in range(0, max(d_in, 1), step))
    return DwPieces(slots, inputs)


class DwPlan(NamedTuple):
    """How ``condensed_matmul_dw`` launches K3 at one shape: ``grid`` =
    (neuron tiles, d_in tiles), a block per 128 x 128 tile in either route
    (``"mma"`` for bfloat16, ``"f32"`` for float32); bfloat16 brings the
    batch through a ring of ``stages`` chunks (None for float32)."""
    route: str
    grid: tuple[int, int]
    stages: int | None = None


def dw_plan(d_in: int, n_out: int, dtype: torch.dtype, sm_count: int) -> DwPlan:
    """K3's launch at these shapes on a card with ``sm_count`` SMs."""
    grid = (-(-n_out // _DW_TILE), -(-d_in // _DW_TILE))
    if dtype != torch.bfloat16:
        return DwPlan("f32", grid)
    # a tile per block: the card's scheduler balances the tiles over the
    # SMs, and no tile waits for another's epilogue. Two blocks share an SM
    # through rings of 3 stages; where the tiles leave each SM one block at
    # most, a ring of 4 loads two chunks ahead instead of one
    return DwPlan("mma", grid, stages=4 if grid[0] * grid[1] <= sm_count else 3)


def condensed_matmul_dw(dy: torch.Tensor, x: torch.Tensor, indices: torch.Tensor, *,
                        limits: tuple[int, int] | None = None) -> torch.Tensor:
    """Values gradient (K3). dy (B, n_out), x (B, d_in), indices (n_out, k)
    int32 -> dw (n_out, k) float32.

    dy and x are both float32 or both bfloat16. Every index must lie in
    [0, d_in); the kernel does not check it. A first kernel groups each
    row's slots by the 128-input tile of their index; then a block per 128 x
    128 tile of (inputs, neurons) computes the slots whose index it holds:
    bfloat16 as a tensor-core tile product read at those slots, float32 on
    the CUDA cores, each slot adding the batch rows in order (``dw_plan``
    picks the launch). Either way two launches are bitwise equal and
    duplicate indices give equal columns; ``launches`` counts one per call.
    A shape past what one launch takes (``dw_limits()``, or ``limits``)
    runs in pieces (``dw_pieces``), bitwise as one launch.
    """
    _check_dw(dy, x, indices, 0)
    if x.device.type == "cpu":
        return ref.condensed_matmul_dw_ref(dy, x, indices)
    if x.device.type == "meta":
        return _dw_meta(x, indices)
    if x.device.type != "cuda":
        raise ValueError(f"the condensed_matmul_dw kernel runs on CUDA tensors, not {x.device}")
    b, d_in = x.shape
    n_out, k = indices.shape
    if b == 0:
        return torch.zeros((n_out, k), dtype=torch.float32, device=x.device)
    if n_out == 0 or k == 0:
        return torch.empty((n_out, k), dtype=torch.float32, device=x.device)
    dw = _dw_in_pieces(dy, x, indices, dw_pieces(d_in, k, limits or dw_limits()), _dw_launch)
    counters.add(condensed_matmul_dw)
    return dw


def dw_workspace_ints(d_in: int, n_out: int, k: int) -> int:
    """int32 elements of one K3 launch's workspace: a group of 16 neurons
    keeps its 16 * k slots, a start per 128-input tile and row, and an end.
    The CUDA launches refuse a smaller workspace (and a shape past
    ``dw_limits()``)."""
    tiles = -(-d_in // 128)
    return -(-n_out // 16) * (16 * k + tiles * 16 + 1)


def _dw_meta(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """K3's (K3-moe's) meta branch: the float32 gradient of ``indices``'
    shape, after the int32 workspace one launch (one a grouped launch's
    expert) allocates."""
    lead = indices.shape[:-2]
    n_out, k = indices.shape[-2:]
    ws = x.new_empty((math.prod(lead) * dw_workspace_ints(x.shape[-1], n_out, k),),
                     dtype=torch.int32)
    del ws
    return x.new_empty(indices.shape, dtype=torch.float32)


def _dw_in_pieces(dy: torch.Tensor, x: torch.Tensor, indices: torch.Tensor,
                  pieces: DwPieces, launch) -> torch.Tensor:
    """``launch(dy, x, indices)`` (K3, or its plain version) over each
    piece, every slot kept from the one d_in chunk that holds its index."""
    if len(pieces.slots) == len(pieces.inputs) == 1:
        return launch(dy, x, indices)
    dw = torch.empty(indices.shape, dtype=torch.float32, device=x.device)
    for s0, s1 in pieces.slots:
        idx = indices[:, s0:s1]
        part = None
        for c0, c1 in pieces.inputs:
            # slots whose index lies elsewhere read input 0 of the chunk and
            # are not kept
            inside = (idx >= c0) & (idx < c1)
            got = launch(dy, x[:, c0:c1].contiguous(),
                         torch.where(inside, idx - c0, 0).to(torch.int32).contiguous())
            part = got if part is None else torch.where(inside, got, part)
        dw[:, s0:s1] = part
    return dw


def _dw_launch(dy: torch.Tensor, x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """One launch of K3 (the bucket kernel, then the tile kernel)."""
    b, d_in = x.shape
    n_out, k = indices.shape
    dw = torch.empty((n_out, k), dtype=torch.float32, device=x.device)
    plan = dw_plan(d_in, n_out, x.dtype, _sm_count(x.device.index or 0))
    lib = _dw_lib()
    ws_ints = dw_workspace_ints(d_in, n_out, k)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.condensed_matmul_dw(dy.data_ptr(), x.data_ptr(), indices.data_ptr(),
                                      dw.data_ptr(), ws.data_ptr(), ws_ints, b, d_in, n_out, k,
                                      _DTYPE_CODES[x.dtype], plan.stages or 0, stream)
    if err:
        raise RuntimeError("condensed_matmul_dw kernel launch failed: "
                           + lib.condensed_dw_error_string(err).decode())
    return dw


condensed_matmul_dw.launches = 0


def _check_dw(dy: torch.Tensor, x: torch.Tensor, indices: torch.Tensor, lead: int) -> None:
    """K3's operand checks; ``lead`` 1 for the expert-grouped launch, whose
    operands carry the experts first."""
    nd = 2 + lead
    if dy.ndim != nd or x.ndim != nd or indices.ndim != nd or dy.shape != (
            *x.shape[:-1], indices.shape[-2]) or x.shape[:lead] != indices.shape[:lead]:
        what = "dy (E, B, n_out), x (E, B, d_in), indices (E, n_out, k)" if lead else (
            "dy (B, n_out), x (B, d_in), indices (n_out, k)")
        raise ValueError(f"need {what}; got {tuple(dy.shape)}, {tuple(x.shape)}, "
                         f"{tuple(indices.shape)}")
    if dy.dtype not in _DTYPE_CODES or x.dtype != dy.dtype:
        raise TypeError(f"dy and x must both be float32 or bfloat16; got {dy.dtype}, {x.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (dy.device == x.device == indices.device):
        raise ValueError("dy, x and indices must be on one device")
    if not (dy.is_contiguous() and x.is_contiguous() and indices.is_contiguous()):
        raise ValueError("dy, x and indices must be contiguous")


def condensed_matmul_dw_grouped(dy: torch.Tensor, x: torch.Tensor,
                                indices: torch.Tensor) -> torch.Tensor:
    """Expert-grouped values gradient (K3-moe). dy (E, B, n_out), x (E, B,
    d_in), indices (E, n_out, k) int32 -> dw (E, n_out, k) float32, dw[e]
    == ``condensed_matmul_dw(dy[e], x[e], indices[e])``, bitwise on the card.

    One bucket kernel and one tile kernel for every expert, the expert a
    grid axis of its own, each with its own workspace slice (E x
    ``dw_workspace_ints``); the launch is one expert's
    (``dw_plan``). A shape past what one launch takes (``dw_limits()``)
    raises: no MoE config reaches it."""
    _check_dw(dy, x, indices, 1)
    if x.device.type == "cpu":
        return ref.condensed_matmul_dw_grouped_ref(dy, x, indices)
    if x.device.type == "meta":
        return _dw_meta(x, indices)
    if x.device.type != "cuda":
        raise ValueError(f"the condensed_matmul_dw kernel runs on CUDA tensors, not {x.device}")
    e, b, d_in = x.shape
    n_out, k = indices.shape[1:]
    if e == 0 or b == 0:
        return torch.zeros((e, n_out, k), dtype=torch.float32, device=x.device)
    if n_out == 0 or k == 0:
        return torch.empty((e, n_out, k), dtype=torch.float32, device=x.device)
    pieces = dw_pieces(d_in, k, dw_limits())
    if len(pieces.slots) != 1 or len(pieces.inputs) != 1:
        raise ValueError(f"d_in={d_in}, k={k}: past what one condensed_matmul_dw_grouped "
                         f"launch takes {dw_limits()}")
    dw = torch.empty((e, n_out, k), dtype=torch.float32, device=x.device)
    plan = dw_plan(d_in, n_out, x.dtype, _sm_count(x.device.index or 0))
    lib = _dw_lib()
    ws_ints = e * dw_workspace_ints(d_in, n_out, k)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.condensed_matmul_dw_grouped(dy.data_ptr(), x.data_ptr(), indices.data_ptr(),
                                              dw.data_ptr(), ws.data_ptr(), ws_ints, e, b, d_in,
                                              n_out, k, _DTYPE_CODES[x.dtype], plan.stages or 0,
                                              stream)
    if err:
        raise RuntimeError("condensed_matmul_dw_grouped kernel launch failed: "
                           + lib.condensed_dw_error_string(err).decode())
    counters.add(condensed_matmul_dw_grouped)
    return dw


condensed_matmul_dw_grouped.launches = 0
