"""Ablation-aware matmuls: wrappers of the Hopper kernels K4, K2-coa, K5 and
K6 (port of ``repro/kernels/structured_matmul.py``).

* K4, ``condensed_over_active_matmul(_decode)``: K1's condensed gather over
  the ``a <= d_out`` surviving rows, each row stored at its dense column
  ``out_index[r]`` (the reference's ``_coa_kernel``).
* K2-coa, ``condensed_over_active_matmul(..., scales=)``:
  int8/fp8 codes and a float32 scale per row, applied after the k-sum
  (``_coa_kernel`` with ``scaled=True``).
* K5, ``structured_matmul(_decode)`` and ``structured_matmul_pregathered``:
  ``x @ panel`` over the gathered surviving columns, each stored at
  ``active_index[j]`` (``_structured_kernel``). The panel comes from
  ``_gather_columns``, an ``index_select`` per call: the reference's XLA
  ``take``, which its decode scan hoists out of the token loop and eager
  PyTorch does not.
* K6, ``structured_matmul_prefetch``: K5 reading the dense weight through
  ``active_index`` inside the kernel, so no panel is gathered
  (``_structured_prefetch_kernel``); decode shapes only.

The CUDA source is ``csrc/structured_matmul.cu`` (its header note gives the
bounds and the design) over K5/K6's bodies in ``csrc/structured_rows.cuh``;
``ref.condensed_over_active_matmul_ref``,
``ref.condensed_over_active_matmul_scaled_ref`` and
``ref.structured_matmul_ref`` are the plain versions.

The expert-grouped launches run one of these over an MoE layer's E experts
in one launch, the reference's ``jax.vmap`` over the experts, each expert
bitwise its one-expert launch (the expert a grid axis of its own):

* K4-moe / K2-coa-moe, ``condensed_over_active_matmul_grouped`` (K1-moe's
  body with ``out_index``, ``csrc/condensed_matmul_grouped.cu``);
* K5-moe, ``structured_matmul_grouped`` and
  ``structured_matmul_grouped_pregathered`` (panels (E, d_in, a_pad)), and
  K6-moe, ``structured_matmul_prefetch_grouped`` (``csrc/structured_matmul_grouped.cu``).

Their plain versions are ``ref.condensed_over_active_matmul_grouped_ref``
and ``ref.structured_matmul_grouped_ref``. An expert stack's rows are the
largest expert's surviving count; another expert's padding rows (columns)
carry the sentinel ``d_out`` and write nothing.

Ablated columns are exact zeros: the kernels' C entry points clear the
output with ``cudaMemsetAsync`` before the launch, so the wrappers allocate
it with ``torch.empty``, and one call is one memset plus one kernel launch
(the float32 K5/K6 keep their tickets right after the output, in the same
buffer). Sentinel slots (``out_index`` or ``active_index`` equal to
``d_out``) are dropped.

Dispatch is as for K1 (``condensed_matmul``): a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises; a meta tensor runs
nothing and gets the kernel's output buffer and workspace as meta tensors
(``_buffers``, which sizes them for the CUDA launch too). ``B <= SMALL_BATCH_MAX``
takes the decode launch (the batch in one block row, padded to a power of
two), larger batches the tiled launch (``TILED_ROWS`` batch rows a block);
the two are bitwise equal, and K6 is bitwise equal to K5's decode launch,
because the d_in splits (``split_geometry``; K4's ``cm.gather_geometry``)
depend on d_in and the dtype only. K4 runs K1's body
(``cm.launch_args``); K5/K6 bring the weight and x through shared memory a
split at a time, so ``prefetch_gather`` (``REPRO_PREFETCH_GATHER=1`` when
None, as in the reference) has no memory budget to check.

``<kernel function>.launches`` counts kernel launches (never plain-version
calls): ``condensed_over_active_matmul.launches`` (K4),
``condensed_over_active_matmul.scaled_launches`` (K2-coa),
``structured_matmul.launches`` (K5) and ``structured_matmul_prefetch.launches``
(K6), and ``condensed_over_active_matmul_grouped.launches`` /
``.scaled_launches`` (K4-moe / K2-coa-moe), ``structured_matmul_grouped.launches``
(K5-moe) and ``structured_matmul_prefetch_grouped.launches`` (K6-moe),
through ``counters`` (a launch captured in a CUDA graph counts once for each
replay).
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import condensed_matmul as cm
from repro_torch.kernels import counters
from repro_torch.kernels import ref

SMALL_BATCH_MAX = cm.SMALL_BATCH_MAX
# the reference pads active_index to its 128-lane tile; the port keeps that
# padding so that its exports equal the reference's exactly
LANE = 128
# K5/K6's d_in splits (csrc/structured_matmul.cu): bfloat16 at most
# MAX_SPLITS of them (one cluster of blocks adds them), each a multiple of
# CHUNK_ROWS rows; float32 F32_SPLIT_ROWS rows each (kSplitRows)
MAX_SPLITS = 8
CHUNK_ROWS = 64
F32_SPLIT_ROWS = 256
# the batch rows of a block K5 takes (``block_b``) and those of its tiled
# launch: bfloat16 any power of two up to 128 (the panel read once per 128
# rows); float32 the decode tiles or the 32-row tiled kernel
STRUCTURED_ROWS = {torch.bfloat16: (1, 2, 4, 8, 16, 32, 64, 128),
                   torch.float32: (1, 2, 4, 8, 32)}
TILED_ROWS = {torch.bfloat16: 128, torch.float32: 32}


def split_geometry(d_in: int, dtype: torch.dtype) -> tuple[int, int]:
    """(rows per split, splits) of K5/K6's d_in reduction. It depends on
    d_in and the dtype only, never on the batch or the launch, which is what
    keeps every launch bitwise equal: bfloat16 ``64 * ceil(d_in / 512)``
    rows, so at most 8 splits; float32 256 rows."""
    if dtype == torch.bfloat16:
        rows = -(-d_in // (MAX_SPLITS * CHUNK_ROWS)) * CHUNK_ROWS
    else:
        rows = F32_SPLIT_ROWS
    return rows, -(-d_in // rows)


def workspace_floats(b: int, d_in: int, a_pad: int, dtype: torch.dtype) -> int:
    """float32 elements of K5/K6's split partials: none in bfloat16 (the
    cluster adds them in shared memory), one (B, a_pad) slab per split in
    float32."""
    if dtype == torch.bfloat16:
        return 0
    return split_geometry(d_in, dtype)[1] * b * a_pad


def padded_active_count(a, d_out: int) -> int:
    """Exported ``active_index`` length: the realized active-column count
    rounded up to the 128-lane tile, capped at the padded dense width.
    Accepts a float ``a`` (the cost model prices fractional row counts)."""
    def ceil_to(n: int) -> int:
        return -(-n // LANE) * LANE
    return min(ceil_to(int(max(a, 1))), ceil_to(int(max(d_out, 1))))


def structured_candidates(b: int, d_in: int, a_pad: int,
                          dtype: torch.dtype) -> list[tuple[int | None, None]]:
    """The launches of K5 that the search times at batch ``b`` (a bucket):
    ``(block_b, None)`` pairs, ``block_b`` None for the decode launch (B <=
    SMALL_BATCH_MAX). K5's block holds a fixed number of columns, so only
    the batch tile is searched. The first is the launch the wrapper picks
    today, the baseline; then each tile of ``STRUCTURED_ROWS`` from ``b``
    rounded up to a power of two down to a sixteenth of it. None moves
    ``split_geometry``, so every candidate is bitwise the baseline."""
    small = b <= SMALL_BATCH_MAX
    base = _decode_rows(b) if small else TILED_ROWS[dtype]
    tiles = [base] + cm._search_tiles(cm._pow2_at_least(b), STRUCTURED_ROWS[dtype])
    return list(dict.fromkeys(
        (None if small and t == _decode_rows(b) else t, None) for t in tiles))


def _prefetch_default() -> bool:
    return os.environ.get("REPRO_PREFETCH_GATHER", "0") != "0"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("structured_matmul")
    fn = lib.coa_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.coa_matmul_scaled_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.structured_matmul_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                            ctypes.c_longlong] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.structured_matmul_error_string.argtypes = [ctypes.c_int]
    lib.structured_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _grouped_lib() -> ctypes.CDLL:
    lib = _build.load("structured_matmul_grouped")
    fn = lib.structured_matmul_grouped_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                            ctypes.c_longlong] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().structured_matmul_error_string(err).decode())


def _check_index(index: torch.Tensor, x: torch.Tensor, name: str) -> None:
    if index.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {index.dtype}")
    if index.device != x.device or not index.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on x's device")


def _check_structured(x: torch.Tensor, w: torch.Tensor,
                      active_index: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or active_index.ndim != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"need x (B, d_in), a weight (d_in, n) and active_index (a,); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(active_index.shape)}")
    if x.dtype not in cm._DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and the weight must both be float32 or bfloat16; got "
                        f"{x.dtype}, {w.dtype}")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and the weight must be contiguous and on one device")
    _check_index(active_index, x, "active_index")


def _on_cuda(x: torch.Tensor, what: str) -> None:
    """Refuse any device but CUDA and meta (whose launch branch allocates
    and runs nothing)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the {what} kernel runs on CUDA tensors, not {x.device}")


def _out_bytes(experts: int, b: int, d_out: int, a_pad: int, dtype: torch.dtype,
               block_rows: int) -> int:
    """Bytes of the output region K5/K6 (their grouped launch over
    ``experts``) take: the outputs, then in float32 a ticket (int32) per
    32-column tile and batch tile, after the outputs rounded up to 16 bytes.
    The CUDA launches refuse a smaller region."""
    if dtype == torch.bfloat16:
        return experts * b * d_out * 2
    tickets = -(-a_pad // 32) * -(-b // block_rows)
    return (experts * b * d_out * 4 + 15) // 16 * 16 + experts * tickets * 4


def _buffers(x: torch.Tensor, experts: int, b: int, d_in: int, a_pad: int, d_out: int,
             block_rows: int, out_shape: tuple):
    """A K5/K6 launch's buffers on x's device (meta included): the output
    region (the outputs and, after them, the float32 kernels' tickets: one
    buffer, one memset), the output view of it, and the float32 workspace."""
    region = x.new_empty((_out_bytes(experts, b, d_out, a_pad, x.dtype, block_rows),),
                         dtype=torch.uint8)
    out = region[:experts * b * d_out * x.element_size()].view(x.dtype).view(out_shape)
    ws = x.new_empty((experts * workspace_floats(b, d_in, a_pad, x.dtype),),
                     dtype=torch.float32)
    return region, out, ws


_decode_rows = cm.decode_rows


# ---------------------------------------------------------------------------
# K5 / K6: structured
# ---------------------------------------------------------------------------

def _gather_columns(w: torch.Tensor, active_index: torch.Tensor) -> torch.Tensor:
    """(d_in, a) panel of surviving columns. Padding entries clip to the
    last column; their (finite) products are dropped at the store."""
    return w.index_select(1, active_index.clamp(max=w.shape[-1] - 1))


def _structured_launch(x: torch.Tensor, w: torch.Tensor, active_index: torch.Tensor,
                       d_out: int, block_rows: int, gather: bool) -> torch.Tensor:
    b, d_in = x.shape
    a_pad = active_index.shape[0]
    if b == 0 or a_pad == 0:
        return torch.zeros((b, d_out), dtype=x.dtype, device=x.device)
    region, out, ws = _buffers(x, 1, b, d_in, a_pad, d_out, block_rows, (b, d_out))
    if x.device.type == "meta":
        return out
    lib, dtype = _lib(), cm._DTYPE_CODES[x.dtype]
    split_rows = split_geometry(d_in, x.dtype)[0]
    with torch.cuda.device(x.device):
        err = lib.structured_matmul_fwd(
            x.data_ptr(), w.data_ptr(), active_index.data_ptr(), region.data_ptr(),
            region.numel(), ws.data_ptr(), ws.numel(), b, d_in, a_pad, d_out, w.shape[1],
            int(gather), dtype, block_rows, split_rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "structured_matmul")
    counters.add(structured_matmul_prefetch if gather else structured_matmul)
    return out


def _panel_matmul(x: torch.Tensor, panel: torch.Tensor, active_index: torch.Tensor,
                  d_out: int, block_b: int | None) -> torch.Tensor:
    """K5 on a gathered (d_in, a_pad) panel: the plain version on the CPU,
    else the decode launch (B <= 8, ``block_b`` None) or the tiled one."""
    if block_b is not None and block_b not in STRUCTURED_ROWS[x.dtype]:
        raise ValueError(f"block_b must be one of {STRUCTURED_ROWS[x.dtype]} for {x.dtype}, "
                         f"got {block_b}")
    if x.device.type == "cpu":
        return ref.structured_matmul_ref(x, panel, active_index, d_out)
    _on_cuda(x, "structured_matmul")
    if block_b is None:
        block_b = (_decode_rows(x.shape[0]) if x.shape[0] <= SMALL_BATCH_MAX
                   else TILED_ROWS[x.dtype])
    return _structured_launch(x, panel, active_index, d_out, block_b, gather=False)


def structured_matmul(x: torch.Tensor, w: torch.Tensor, active_index: torch.Tensor, *,
                      block_b: int | None = None,
                      prefetch_gather: bool | None = None) -> torch.Tensor:
    """Column-gathered structured matmul. x (B, d_in), w (d_in, d_out),
    active_index (a,) int32 surviving-column ids (``d_out`` = padding).
    Returns (B, d_out) with ablated columns exact zeros.

    ``block_b=None`` routes decode shapes (B <= SMALL_BATCH_MAX) to
    ``structured_matmul_decode``; otherwise the tiled launch runs with
    ``block_b`` batch rows per block (``TILED_ROWS`` by default: 128 in
    bfloat16, 32 in float32; ``STRUCTURED_ROWS`` lists what each takes).
    """
    _check_structured(x, w, active_index)
    if block_b is None and x.shape[0] <= SMALL_BATCH_MAX:
        return structured_matmul_decode(x, w, active_index, prefetch_gather=prefetch_gather)
    return _panel_matmul(x, _gather_columns(w, active_index), active_index, w.shape[1],
                         block_b)


structured_matmul.launches = 0


def structured_matmul_decode(x: torch.Tensor, w: torch.Tensor, active_index: torch.Tensor, *,
                             prefetch_gather: bool | None = None) -> torch.Tensor:
    """Decode launch (the batch in one block row). Bitwise equal to the
    tiled launch. ``prefetch_gather=True`` runs K6, which reads ``w``
    through ``active_index`` instead of a gathered panel; None reads
    ``REPRO_PREFETCH_GATHER``."""
    _check_structured(x, w, active_index)
    use_prefetch = _prefetch_default() if prefetch_gather is None else prefetch_gather
    if use_prefetch:
        return structured_matmul_prefetch(x, w, active_index)
    panel = _gather_columns(w, active_index)
    if x.device.type == "cpu":
        return ref.structured_matmul_ref(x, panel, active_index, w.shape[1])
    _on_cuda(x, "structured_matmul")
    return _structured_launch(x, panel, active_index, w.shape[1],
                              _decode_rows(x.shape[0]), gather=False)


def structured_matmul_prefetch(x: torch.Tensor, w: torch.Tensor,
                               active_index: torch.Tensor) -> torch.Tensor:
    """K6: the decode launch of K5 with the column gather inside the kernel,
    reading the dense (d_in, d_out) ``w`` at ``active_index`` (B <= 8).
    Bitwise equal to ``structured_matmul_decode`` without prefetch."""
    _check_structured(x, w, active_index)
    if x.device.type == "cpu":
        return ref.structured_matmul_ref(x, _gather_columns(w, active_index), active_index,
                                         w.shape[1])
    _on_cuda(x, "structured_matmul_prefetch")
    if x.shape[0] > SMALL_BATCH_MAX:
        raise ValueError(f"the prefetch kernel takes decode batches (B <= "
                         f"{SMALL_BATCH_MAX}), got B={x.shape[0]}")
    return _structured_launch(x, w, active_index, w.shape[1], _decode_rows(x.shape[0]),
                              gather=True)


structured_matmul_prefetch.launches = 0


def structured_matmul_pregathered(x: torch.Tensor, panel: torch.Tensor,
                                  active_index: torch.Tensor, d_out: int, *,
                                  block_b: int | None = None) -> torch.Tensor:
    """Structured matmul over a caller-supplied (d_in, a) panel of already
    gathered columns; the same kernel as ``structured_matmul``, no gather."""
    _check_structured(x, panel, active_index)
    if panel.shape[1] != active_index.shape[0]:
        raise ValueError(f"panel has {panel.shape[1]} columns for "
                         f"{active_index.shape[0]} active_index entries")
    return _panel_matmul(x, panel, active_index, d_out, block_b)


# ---------------------------------------------------------------------------
# K4: condensed over active rows
# ---------------------------------------------------------------------------

def _coa_launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                out_index: torch.Tensor, d_out: int, block_rows: int,
                scales: torch.Tensor | None = None,
                block_n: int | None = None) -> torch.Tensor:
    _on_cuda(x, "condensed_over_active_matmul")
    b, d_in = x.shape
    a, k = values.shape
    out = torch.empty((b, d_out), dtype=x.dtype, device=x.device)
    if b == 0 or x.device.type == "meta":
        return out
    if a == 0:
        return out.zero_()
    args = cm.launch_args(x, a, block_rows, cm._sm_count(x.device.index or 0), block_n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if scales is None:
            err = _lib().coa_matmul_fwd(
                x.data_ptr(), values.data_ptr(), indices.data_ptr(), out_index.data_ptr(),
                out.data_ptr(), b, d_in, a, k, d_out, cm._DTYPE_CODES[x.dtype], *args, stream)
        else:
            err = _lib().coa_matmul_scaled_fwd(
                x.data_ptr(), values.data_ptr(), indices.data_ptr(), out_index.data_ptr(),
                scales.data_ptr(), out.data_ptr(), b, d_in, a, k, d_out,
                cm._DTYPE_CODES[x.dtype], cm._VALUE_CODES[values.dtype], *args, stream)
    _raise_on(err, "condensed_over_active_matmul")
    counters.add(condensed_over_active_matmul,
                 "launches" if scales is None else "scaled_launches")
    return out


def _check_coa(x, values, indices, out_index, scales=None) -> None:
    cm._check(x, values, indices, scales)
    if out_index.shape != values.shape[:1]:
        raise ValueError(f"out_index must be (a,) = {tuple(values.shape[:1])}, got "
                         f"{tuple(out_index.shape)}")
    _check_index(out_index, x, "out_index")


def _coa_plain(x, values, indices, out_index, d_out, scales):
    if scales is None:
        return ref.condensed_over_active_matmul_ref(x, values, indices, out_index, d_out)
    return ref.condensed_over_active_matmul_scaled_ref(x, values, indices, out_index, scales,
                                                       d_out)


def condensed_over_active_matmul(x: torch.Tensor, values: torch.Tensor,
                                 indices: torch.Tensor, out_index: torch.Tensor,
                                 d_out: int, *, scales: torch.Tensor | None = None,
                                 block_b: int | None = None,
                                 block_n: int | None = None) -> torch.Tensor:
    """Condensed gather over the surviving rows, written through
    ``out_index`` into a (B, d_out) output. x (B, d_in); values, indices
    (a, k); out_index (a,) int32, ``d_out`` marking padding rows. ``scales``
    (a,) float32 marks ``values`` as int8/fp8 codes and runs K2-coa.

    ``block_b=None``: B <= SMALL_BATCH_MAX goes to the decode launch, larger
    batches to the tiled launch with ``cm.TILED_ROWS[dtype]`` batch rows a
    block (128 in bfloat16, 8 in float32); an explicit ``block_b`` (one of
    ``cm.GATHER_ROWS[dtype]``) forces the tiled launch at that tile and
    ``block_n`` sets the neurons of a block, as for K1
    (``condensed_matmul``).
    """
    _check_coa(x, values, indices, out_index, scales)
    cm.check_block_b(block_b, x.dtype)
    if block_b is None and x.shape[0] <= SMALL_BATCH_MAX:
        return condensed_over_active_matmul_decode(x, values, indices, out_index, d_out,
                                                   scales=scales, block_n=block_n)
    tile = cm.TILED_ROWS[x.dtype] if block_b is None else block_b
    cm.check_block_n(block_n, tile, x.shape[1], x.dtype)
    if x.device.type == "cpu":
        return _coa_plain(x, values, indices, out_index, d_out, scales)
    return _coa_launch(x, values, indices, out_index, d_out, tile, scales, block_n)


condensed_over_active_matmul.launches = 0
condensed_over_active_matmul.scaled_launches = 0


def condensed_over_active_matmul_decode(x: torch.Tensor, values: torch.Tensor,
                                        indices: torch.Tensor, out_index: torch.Tensor,
                                        d_out: int, *,
                                        scales: torch.Tensor | None = None,
                                        block_n: int | None = None) -> torch.Tensor:
    """Decode launch of K4 (K2-coa with ``scales``), the batch in one block
    row; bitwise equal to the tiled launch. ``block_n`` as for K1."""
    _check_coa(x, values, indices, out_index, scales)
    tile = _decode_rows(x.shape[0])
    cm.check_block_n(block_n, tile, x.shape[1], x.dtype)
    if x.device.type == "cpu":
        return _coa_plain(x, values, indices, out_index, d_out, scales)
    return _coa_launch(x, values, indices, out_index, d_out, tile, scales, block_n)


# ---------------------------------------------------------------------------
# the expert-grouped launches: K4-moe / K2-coa-moe, K5-moe, K6-moe
# ---------------------------------------------------------------------------

def _check_index_grouped(index: torch.Tensor, x: torch.Tensor, shape: tuple,
                         name: str) -> None:
    if tuple(index.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(index.shape)}")
    _check_index(index, x, name)


def condensed_over_active_matmul_grouped(x: torch.Tensor, values: torch.Tensor,
                                         indices: torch.Tensor, out_index: torch.Tensor,
                                         d_out: int, *, scales: torch.Tensor | None = None,
                                         block_b: int | None = None,
                                         block_n: int | None = None) -> torch.Tensor:
    """Expert-grouped condensed gather over surviving rows (K4-moe;
    K2-coa-moe with ``scales``). x (E, M, d_in); values, indices (E, a, k);
    out_index (E, a) int32 (``d_out`` a padding row); scales (E, a) float32
    -> y (E, M, d_out), y[e] == ``condensed_over_active_matmul(x[e], ...)``,
    bitwise on the card. One launch (and one memset) for every expert, the
    launch of one expert's shape; ``block_b`` and ``block_n`` as
    ``condensed_matmul.condensed_matmul_grouped``'s."""
    cm._check_grouped(x, values, indices, scales)
    _check_index_grouped(out_index, x, values.shape[:2], "out_index")
    cm.check_block_b(block_b, x.dtype)
    e, m, d_in = x.shape
    tile = cm.grouped_tile(m, block_b, cm.TILED_ROWS[x.dtype])
    cm.check_block_n(block_n, tile, d_in, x.dtype)
    if x.device.type == "cpu":
        return ref.condensed_over_active_matmul_grouped_ref(x, values, indices, out_index, d_out,
                                                            scales)
    _on_cuda(x, "condensed_over_active_matmul_grouped")
    a, k = values.shape[1:]
    y = torch.empty((e, m, d_out), dtype=x.dtype, device=x.device)
    if m == 0 or x.device.type == "meta":
        return y
    if a == 0:
        return y.zero_()
    args = cm.launch_args(x[0], e * a, tile, cm._sm_count(x.device.index or 0), block_n)
    lib = cm._grouped_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.coa_matmul_grouped_fwd(
            x.data_ptr(), values.data_ptr(), indices.data_ptr(), out_index.data_ptr(),
            None if scales is None else scales.data_ptr(), y.data_ptr(), e, m, d_in, a, k, d_out,
            cm._DTYPE_CODES[x.dtype], 0 if scales is None else cm._VALUE_CODES[values.dtype],
            *args, stream)
    if err:
        raise RuntimeError("condensed_over_active_matmul_grouped kernel launch failed: "
                           + lib.condensed_matmul_grouped_error_string(err).decode())
    counters.add(condensed_over_active_matmul_grouped,
                 "launches" if scales is None else "scaled_launches")
    return y


condensed_over_active_matmul_grouped.launches = 0
condensed_over_active_matmul_grouped.scaled_launches = 0


def _check_structured_grouped(x: torch.Tensor, w: torch.Tensor,
                              active_index: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3 or active_index.ndim != 2 or x.shape[0] == 0 or not (
            x.shape[0] == w.shape[0] == active_index.shape[0]) or w.shape[1] != x.shape[2]:
        raise ValueError(f"need x (E, M, d_in), weights (E, d_in, n) and active_index (E, a), "
                         f"E >= 1; got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(active_index.shape)}")
    # one expert's slices pass the one-expert checks (dtypes, devices,
    # contiguity of the whole tensors)
    _check_structured(x[0], w[0], active_index[0])
    if not (x.is_contiguous() and w.is_contiguous() and active_index.is_contiguous()):
        raise ValueError("x, the weights and active_index must be contiguous")


def _gather_columns_grouped(w: torch.Tensor, active_index: torch.Tensor) -> torch.Tensor:
    """(E, d_in, a) panels of each expert's surviving columns, as
    ``_gather_columns`` per expert (padding entries clip to the last
    column; their products are dropped at the store)."""
    cols = active_index.clamp(max=w.shape[-1] - 1).long()
    return torch.gather(w, 2, cols[:, None, :].expand(-1, w.shape[1], -1))


def _structured_grouped_launch(x: torch.Tensor, w: torch.Tensor, active_index: torch.Tensor,
                               d_out: int, block_rows: int, gather: bool) -> torch.Tensor:
    e, m, d_in = x.shape
    a_pad = active_index.shape[1]
    if m == 0 or a_pad == 0:
        return torch.zeros((e, m, d_out), dtype=x.dtype, device=x.device)
    region, out, ws = _buffers(x, e, m, d_in, a_pad, d_out, block_rows, (e, m, d_out))
    if x.device.type == "meta":
        return out
    lib, dtype = _grouped_lib(), cm._DTYPE_CODES[x.dtype]
    split_rows = split_geometry(d_in, x.dtype)[0]
    with torch.cuda.device(x.device):
        err = lib.structured_matmul_grouped_fwd(
            x.data_ptr(), w.data_ptr(), active_index.data_ptr(), region.data_ptr(),
            region.numel(), ws.data_ptr(), ws.numel(), e, m, d_in, a_pad, d_out, w.shape[2],
            int(gather), dtype, block_rows, split_rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "structured_matmul_grouped")
    counters.add(structured_matmul_prefetch_grouped if gather else structured_matmul_grouped)
    return out


def _panel_matmul_grouped(x: torch.Tensor, panel: torch.Tensor, active_index: torch.Tensor,
                          d_out: int, block_b: int | None) -> torch.Tensor:
    """K5-moe on gathered (E, d_in, a_pad) panels: the plain version on the
    CPU, else the launch at ``cm.grouped_tile``'s batch tile."""
    if block_b is not None and block_b not in STRUCTURED_ROWS[x.dtype]:
        raise ValueError(f"block_b must be one of {STRUCTURED_ROWS[x.dtype]} for {x.dtype}, "
                         f"got {block_b}")
    if x.device.type == "cpu":
        return ref.structured_matmul_grouped_ref(x, panel, active_index, d_out)
    _on_cuda(x, "structured_matmul_grouped")
    return _structured_grouped_launch(
        x, panel, active_index, d_out, cm.grouped_tile(x.shape[1], block_b, TILED_ROWS[x.dtype]),
        gather=False)


def structured_matmul_grouped(x: torch.Tensor, w: torch.Tensor, active_index: torch.Tensor, *,
                              block_b: int | None = None,
                              prefetch_gather: bool | None = None) -> torch.Tensor:
    """Expert-grouped structured matmul (K5-moe). x (E, M, d_in), w (E, d_in,
    d_out), active_index (E, a_pad) -> (E, M, d_out), out[e] ==
    ``structured_matmul(x[e], w[e], active_index[e])``, bitwise on the card.
    ``block_b`` as ``structured_matmul``'s, for every expert. At decode
    shapes (M <= SMALL_BATCH_MAX, ``block_b`` None) ``prefetch_gather``
    (None reads ``REPRO_PREFETCH_GATHER``) runs K6-moe instead, which reads
    ``w`` through ``active_index`` and gathers no panel."""
    _check_structured_grouped(x, w, active_index)
    if block_b is None and x.shape[1] <= SMALL_BATCH_MAX and (
            _prefetch_default() if prefetch_gather is None else prefetch_gather):
        return structured_matmul_prefetch_grouped(x, w, active_index)
    return _panel_matmul_grouped(x, _gather_columns_grouped(w, active_index), active_index,
                                 w.shape[2], block_b)


structured_matmul_grouped.launches = 0


def structured_matmul_prefetch_grouped(x: torch.Tensor, w: torch.Tensor,
                                       active_index: torch.Tensor) -> torch.Tensor:
    """K6-moe: K6 over the experts' dense (E, d_in, d_out) weights, each read
    at its ``active_index`` inside the kernel (M <= SMALL_BATCH_MAX).
    Bitwise equal to ``structured_matmul_grouped`` without prefetch."""
    _check_structured_grouped(x, w, active_index)
    if x.device.type == "cpu":
        return ref.structured_matmul_grouped_ref(x, _gather_columns_grouped(w, active_index),
                                                 active_index, w.shape[2])
    _on_cuda(x, "structured_matmul_prefetch_grouped")
    if x.shape[1] > SMALL_BATCH_MAX:
        raise ValueError(f"the prefetch kernel takes decode batches (M <= "
                         f"{SMALL_BATCH_MAX}), got M={x.shape[1]}")
    return _structured_grouped_launch(x, w, active_index, w.shape[2], _decode_rows(x.shape[1]),
                                      gather=True)


structured_matmul_prefetch_grouped.launches = 0


def structured_matmul_grouped_pregathered(x: torch.Tensor, panel: torch.Tensor,
                                          active_index: torch.Tensor, d_out: int, *,
                                          block_b: int | None = None) -> torch.Tensor:
    """K5-moe over caller-supplied (E, d_in, a_pad) panels of already
    gathered columns (a quantized expert leaf's dequantized panels)."""
    _check_structured_grouped(x, panel, active_index)
    if panel.shape[2] != active_index.shape[1]:
        raise ValueError(f"panels have {panel.shape[2]} columns for "
                         f"{active_index.shape[1]} active_index entries")
    return _panel_matmul_grouped(x, panel, active_index, d_out, block_b)
