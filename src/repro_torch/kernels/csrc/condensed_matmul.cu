// Condensed constant fan-in matmul for Hopper (sm_90a), forward only: K1
// and its dequant-fused form K2.
//
//   K1: y[b, n] = sum_k f32(x[b, idx[n, k]]) * f32(values[n, k])   (f32 accumulator)
//   K2: y[b, n] = (sum_k f32(x[b, idx[n, k]]) * f32(q[n, k])) * scales[n]
//
// cast to the dtype of x. x: (B, d_in); values or codes q, idx: (n_out, k),
// idx int32; q int8 or float8_e4m3 with one float32 scale per neuron;
// y: (B, n_out).
//
// K1 replaces the TPU kernel repro/kernels/condensed_matmul.py::_fwd_kernel
// and K2 its quantized variant _fwd_scaled_kernel, each in both launches:
// _fwd_decode (B <= 8, batch staged whole, grid over neuron tiles) and
// _fwd_tiled (grid over batch tiles x neuron tiles). K1-moe and K2-moe, the
// same kernels over an MoE layer's experts in one launch, are built from
// condensed_matmul_grouped.cu.
//
// Bound: the bytes of the slots (values or codes, and indices) at decode
// and at B = 128 alike: 25.2 MB for a qwen3-1.7b layer in bf16 (9.7 us at
// 3.35 TB/s at B = 128), where the dense layer the library multiplies reads
// 84 MB.
//
// The body is condensed_rows.cuh, which K4 and K2-coa (structured_matmul.cu)
// share. In bfloat16 every output is one chain fixed by d_in: a chain of
// mma.sync products per d_in split over a dense bf16 panel of the slots
// (the batch as the n8 side, as K5 does), the splits added in order; K2's
// codes widen to bf16 exactly and its scale multiplies the float32 sum
// before the cast. The tiled launch (gather_mma: 64 neurons a block at the
// main-path widths, a cluster of the splits' blocks that read the slots once
// per call, bucket them by split and add the partials through distributed
// shared memory; past d_in about 36k, 16 neurons and the split's panel in
// passes) and the decode launch (gather_mma_decode: 16 or 8 neurons and
// every split in one block, up to d_in 6656; gather_mma past it) compute
// that chain alike, so decode == tiled bitwise at any tile. The wrapper
// (condensed_matmul.launch_args) chooses each launch; this side checks that
// it fits and launches it. Rows with duplicate indices take an exact CUDA-core
// chain over their slots. In float32 (gather_rows_kernel) one warp per
// neuron gathers from the block's BT <= 8 rows of x staged in shared memory,
// on the CUDA cores; there K2 is K1's code with the value load widened from
// a 1-byte code, so K2 == K1(f32(q)) * scales bitwise. The source note of
// condensed_rows.cuh gives both designs in full, with duplicates, non-finite
// x, the geometry and the shared-memory budget.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "condensed_rows.cuh"

extern "C" {

// K1. dtype: 0 = float32, 1 = bfloat16 (x, values and y). The launch
// (condensed_matmul.launch_args): block_rows, the batch rows of a block
// (float32: 1, 2, 4 or 8; bfloat16: a power of two up to 128);
// rows_per_warp, float32's neurons a warp; split_rows, pass_rows,
// block_neurons and decode_loads, bfloat16's (condensed_rows::dispatch).
// Returns the cudaError_t of the launch (0 = success).
int condensed_matmul_fwd(const void* x, const void* values, const void* indices, void* y,
                         int batch, int d_in, int n_out, int k, int dtype, int block_rows,
                         int rows_per_warp, int split_rows, int pass_rows, int block_neurons,
                         int decode_loads, void* stream) {
  return condensed_rows::dispatch(dtype, 0, block_rows, rows_per_warp, split_rows, pass_rows,
                                  block_neurons, decode_loads, x, values, indices, nullptr,
                                  nullptr, y, batch, d_in, n_out, k, n_out,
                                  static_cast<cudaStream_t>(stream));
}

// K2. As condensed_matmul_fwd, with vtype 1 = int8 codes or 2 =
// float8_e4m3 codes, and scales: n_out float32.
int condensed_matmul_scaled_fwd(const void* x, const void* codes, const void* indices,
                                const void* scales, void* y, int batch, int d_in, int n_out,
                                int k, int dtype, int vtype, int block_rows, int rows_per_warp,
                                int split_rows, int pass_rows, int block_neurons,
                                int decode_loads, void* stream) {
  if ((vtype != 1 && vtype != 2) || scales == nullptr) return cudaErrorInvalidValue;
  return condensed_rows::dispatch(dtype, vtype, block_rows, rows_per_warp, split_rows, pass_rows,
                                  block_neurons, decode_loads, x, codes, indices,
                                  static_cast<const float*>(scales), nullptr, y, batch, d_in,
                                  n_out, k, n_out, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory (bytes) the bfloat16 kernels size a block with:
// decode = 0, gather_mma at tile_rows batch rows, neurons a block, a panel
// of pass_rows inputs and passes passes (condensed_matmul.mma_smem_bytes);
// decode = 1, gather_mma_decode over splits splits of pass_rows inputs
// (condensed_matmul.decode_smem_bytes). No launch; for the check that the
// wrapper's formulas are these.
long long condensed_matmul_smem_bytes(int decode, int tile_rows, int neurons, int pass_rows,
                                      int passes_or_splits) {
  return decode ? condensed_rows::decode_smem(pass_rows, passes_or_splits)
                : condensed_rows::mma_smem(tile_rows, neurons, pass_rows, passes_or_splits);
}

const char* condensed_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
