// Ablation-aware matmuls for Hopper (sm_90a), forward only: K4 (with its
// dequant-fused form K2-coa), K5 and K6.
//
// K4, condensed over active rows (replaces the TPU kernel
// repro/kernels/structured_matmul.py::_coa_kernel, launched by _coa_tiled
// and _coa_decode):
//
//   out[b, out_index[r]] = sum_k f32(x[b, idx[r, k]]) * f32(values[r, k])
//
// over the a <= d_out surviving rows r, cast once to the dtype of x. Rows
// whose out_index is the sentinel d_out are padding: their slots are never
// stored and they are dropped. Bound: bytes (values + indices + out_index +
// x + out over HBM). It is K1's body (condensed_rows.cuh) with the store
// addressed through out_index: in bfloat16 one chain a row, fixed by d_in,
// of mma.sync products over a dense bf16 panel of the slots, one chain per
// d_in split, the splits added in order -- a cluster of the splits' blocks
// at the tiled launch, one block for every split at decode (the cluster
// past d_in 6656); in float32 a
// warp per row gathering on the CUDA cores. So its output at column
// out_index[r] is bitwise K1's output for row r, and the decode launch is
// bitwise the tiled launch at any batch tile. Duplicates, non-finite x and
// the geometry are as that note gives them.
//
// K2-coa (replaces _coa_kernel with scaled=True): K4 over int8 or
// float8_e4m3 codes with one float32 scale per surviving row, multiplied
// after the k-sum, before the cast and the store (codes widen to bf16
// exactly for the tensor cores): its output at column out_index[r] is
// bitwise K2's output for row r.
//
// K5, structured (replaces _structured_kernel, launched by
// _structured_tiled and _structured_decode):
//
//   out[b, active_index[j]] = sum_i f32(x[b, i]) * f32(panel[i, j])
//
// over the a_pad gathered columns j of the (d_in, a_pad) panel, f32
// accumulate, cast once; sentinel slots (active_index[j] == d_out) are
// dropped.
//
// K6, structured with the gather inside (replaces
// _structured_prefetch_kernel, launched by _structured_prefetch_decode): K5
// reading W[i, active_index[j]] of the full dense (d_in, d_out) weight in
// place of panel[i, j] (a sentinel reads the clamped column d_out - 1 and
// is dropped), so no panel is gathered first.
//
// In all three, ablated columns of out are exact zeros: the C entry points
// clear out with cudaMemsetAsync on the caller's stream before the launch,
// so one call is one memset and one kernel launch (the float32 K5/K6 keep
// their tickets right after the output, in the same memset). The TPU
// kernels' one-hot MXU scatter has no counterpart: each result is stored
// straight to its column (the exports guarantee unique columns).
//
// K5/K6 bound: bytes in bfloat16 at every batch the serving path gives
// (the panel, or the gathered columns of W, d_in * a_pad elements for 2 * B
// * d_in * a_pad operations: at B = 128 that is 128 operations a byte,
// below the card's 295), bytes at decode and CUDA-core operations at
// prefill in float32. Every output's float32 value is the same at every
// batch tile and in every launch (decode or tiled, K5 or K6): the d_in
// splits and the order of the products within a split depend only on d_in
// and the dtype, and the splits are added in order. So the decode launch
// is bitwise the tiled launch at any tile, and K6 is bitwise K5's decode
// launch on the panel that K5's wrapper gathers.
//
// bfloat16 -- structured_mma, on the tensor cores, swap-AB: out^T[j, b] =
// sum_i panel[i, j] x[b, i], the panel's columns as the M side (A, read
// MN-major with ldmatrix.trans) and the batch as the narrow N side (B = x,
// K-major, ldmatrix). The instruction is mma.sync.m16n8k16 (bf16 in, f32
// sums) in every launch: one fixed shape gives each output the same chain
// of products whether its batch row shares an n8 tile with 3 or with 7
// others, and a 16 x 8 tile wastes little at decode (B <= 8), where wgmma's
// 64-row M would need a warpgroup per 64 columns and gains nothing against
// the bytes. A block owns 64 columns (four m16 tiles), one split of d_in,
// and up to 128 batch rows (16 n8 tiles): warp w takes m16 tile w % 4 and
// every second n8 tile, each an f32 accumulator chain over the split's
// rows in order, so the panel is read once per call at B <= 128 (at B =
// 256 the product reaches the card's operations-to-bytes balance, so a
// second read costs little). The split has split_rows rows, a multiple of
// 64, with at most 8 splits (split_rows = 64 * ceil(d_in / 512)): a cluster
// of the splits' blocks adds their partial tiles in split order through
// distributed shared memory, each block a share of the tile, with no
// global workspace and no ticket. A ring of four stages of 64 rows brings
// the panel tile (128-byte rows, 16-byte chunk c of row r at c ^ (r % 8),
// so ldmatrix.trans is free of bank conflicts) and the batch rows of x
// (144-byte rows) through cp.async, three chunks ahead. The decode launch
// (B <= 8) instantiates one n8 tile a block, so four blocks share an SM.
// K6 fills the same tile from W through active_index, then runs K5's
// instructions. A tile whose 64 active columns lie in order in W from a
// multiple of 8 (an export's, where none of them is ablated) is copied as
// K5's panel is; any other tile (neurons ablated at random) takes the
// element path: a column a lane, so a warp reads 32 neighbouring active
// columns of one row with 2-byte loads, issued three chunks ahead into
// registers and stored to the tile after the chunk before is computed
// (deeper register pipelines cost blocks an SM and ran slower). A panel
// K5 cannot copy 16 bytes at a time (a_pad % 8 != 0, or unaligned) takes
// the element path too. Ragged B, d_in and a_pad are zero-filled in shared
// memory; the wrapper pads nothing.
//
// float32 -- CUDA cores, full float32 (TF32 would change the result beyond
// the float32 tolerance). Each output sums its split's 256 rows in eight
// chains (rows r, r + 8, ... in order), the chains in order, then the
// splits in order, through a float32 workspace of split partials (splits
// x B x a_pad floats). Decode (and K6): structured_kernel, 32 columns a
// block, a lane each, each warp one chain with all its 32 rows loaded
// before the first FMA; a ticket taken after __threadfence elects the last
// block of a tile, which adds the splits. Tiled: structured_f32_tiled, 64
// columns by 32 batch rows a block, two blocks an SM, x and the panel tile
// brought into shared memory by cp.async, each lane 8 columns by 8 batch
// rows, the warps the chains; the batch tiles of a panel tile run side by
// side, so HBM sees the panel about once and L2 serves the rest. Both
// share f32_split_epilogue: no block waits for another.
//
// K5's and K6's bodies and launches are in structured_rows.cuh, shared with
// their expert-grouped launches (structured_matmul_grouped.cu); this file
// holds the one-expert entry points.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "structured_rows.cuh"

extern "C" {

// K4. dtype: 0 = float32, 1 = bfloat16 (x, values and out). block_rows,
// rows_per_warp, split_rows, pass_rows, block_neurons, decode_loads: the
// launch, as condensed_matmul_fwd's. Returns the cudaError_t (0 = success).
int coa_matmul_fwd(const void* x, const void* values, const void* indices, const void* out_index,
                   void* out, int batch, int d_in, int a, int k, int d_out, int dtype,
                   int block_rows, int rows_per_warp, int split_rows, int pass_rows,
                   int block_neurons, int decode_loads, void* stream) {
  if (batch <= 0 || a <= 0 || d_in <= 0 || d_out <= 0 || k < 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * dtype_size(dtype), s);
  if (err != cudaSuccess) return err;
  return condensed_rows::dispatch(dtype, 0, block_rows, rows_per_warp, split_rows, pass_rows,
                                  block_neurons, decode_loads, x, values, indices, nullptr,
                                  out_index, out, batch, d_in, a, k, d_out, s);
}

// K2-coa. As coa_matmul_fwd, with int8 (vtype 1) or float8_e4m3 (vtype 2)
// codes and a float32 scale per row (scales: a floats).
int coa_matmul_scaled_fwd(const void* x, const void* codes, const void* indices,
                          const void* out_index, const void* scales, void* out, int batch,
                          int d_in, int a, int k, int d_out, int dtype, int vtype, int block_rows,
                          int rows_per_warp, int split_rows, int pass_rows, int block_neurons,
                          int decode_loads, void* stream) {
  if (batch <= 0 || a <= 0 || d_in <= 0 || d_out <= 0 || k < 0 || (dtype != 0 && dtype != 1) ||
      (vtype != 1 && vtype != 2) || scales == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * dtype_size(dtype), s);
  if (err != cudaSuccess) return err;
  return condensed_rows::dispatch(dtype, vtype, block_rows, rows_per_warp, split_rows, pass_rows,
                                  block_neurons, decode_loads, x, codes, indices,
                                  static_cast<const float*>(scales), out_index, out, batch, d_in,
                                  a, k, d_out, s);
}

// K5 (gather = 0: w is the (d_in, a_pad) panel, ld_w = a_pad) and K6
// (gather = 1: w is the dense (d_in, d_out) weight, ld_w = d_out).
// out: out_bytes bytes, at least the (batch, d_out) output, then (float32)
// the tickets, after the output rounded up to 16 bytes: one int32 per
// 32-column tile and block of batch rows. block_rows: the batch
// rows of a block. split_rows: the rows of d_in of a split.
//   bfloat16 (dtype 1): block_rows a power of two up to 128; split_rows a
//   multiple of 64 with at most 8 splits; no workspace.
//   float32 (dtype 0): block_rows 1, 2, 4 or 8 (decode, K6) or 32 (tiled,
//   K5 only); split_rows 256; workspace: ws_floats float32 elements, at
//   least ceil(d_in / 256) * batch * a_pad, for the split partials.
// Returns the cudaError_t (0 = success).
int structured_matmul_fwd(const void* x, const void* w, const void* active_index, void* out,
                          long long out_bytes, void* workspace, long long ws_floats, int batch,
                          int d_in, int a_pad, int d_out, int ld_w, int gather, int dtype,
                          int block_rows, int split_rows, void* stream) {
  if (!structured_args_ok(batch, d_in, a_pad, d_out, ld_w, gather, dtype, block_rows,
                          split_rows))
    return cudaErrorInvalidValue;
  const long long splits = (d_in + split_rows - 1) / split_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t zeroed = dtype == 1 ? static_cast<size_t>(batch) * d_out * 2
                                   : tickets_offset(batch, d_out, 4) +
                                         f32_tickets(batch, a_pad, block_rows) * sizeof(int);
  if (out_bytes < static_cast<long long>(zeroed) ||
      (dtype == 0 && ws_floats < splits * batch * a_pad))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, zeroed, s);
  if (err != cudaSuccess) return err;
  int* tickets = reinterpret_cast<int*>(static_cast<char*>(out) + tickets_offset(batch, d_out, 4));
  return structured_launch<false>(x, w, active_index, out, static_cast<float*>(workspace),
                                  tickets, batch, d_in, a_pad, d_out, ld_w, gather, dtype,
                                  block_rows, split_rows, kSOne, s);
}

const char* structured_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
