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
// _fwd_tiled (grid over batch tiles x neuron tiles). K2 is K1's code with
// the value load widened from a 1-byte code and the scale multiplied after
// the k-sum (condensed_rows.cuh), so in float32 K2 == K1(f32(q)) * scales
// bitwise, and K2's decode launch == its tiled launch bitwise.
//
// The body, its byte bound and its design are in condensed_rows.cuh, which
// K4 (structured_matmul.cu) shares: one warp per output neuron, the BT rows
// of x staged transposed in shared memory, a per-row reduction order that
// does not depend on BT, so the decode launch (BT = B rounded up to a power
// of two) is bitwise equal to the tiled launch (BT = 8), the promise of
// condensed_matmul_decode in the reference.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "condensed_rows.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, values and y). block_rows: 1, 2, 4 or 8
// rows of x per block. Returns the cudaError_t of the launch (0 = success).
int condensed_matmul_fwd(const void* x, const void* values, const void* indices, void* y,
                         int batch, int d_in, int n_out, int k, int dtype,
                         int block_rows, int rows_per_warp, void* stream) {
  if (batch <= 0 || n_out <= 0 || d_in <= 0 || k < 0 || rows_per_warp <= 0)
    return cudaErrorInvalidValue;
  return condensed_rows::dispatch(dtype, 0, block_rows, x, values, indices, nullptr, nullptr, y,
                                  batch, d_in, n_out, k, n_out, rows_per_warp,
                                  static_cast<cudaStream_t>(stream));
}

// K2. dtype: 0 = float32, 1 = bfloat16 (x and y). vtype: 1 = int8 codes,
// 2 = float8_e4m3 codes. scales: n_out float32. block_rows: 1, 2, 4 or 8.
// Returns the cudaError_t of the launch (0 = success).
int condensed_matmul_scaled_fwd(const void* x, const void* codes, const void* indices,
                                const void* scales, void* y, int batch, int d_in, int n_out,
                                int k, int dtype, int vtype, int block_rows, int rows_per_warp,
                                void* stream) {
  if (batch <= 0 || n_out <= 0 || d_in <= 0 || k < 0 || rows_per_warp <= 0 ||
      (vtype != 1 && vtype != 2) || scales == nullptr)
    return cudaErrorInvalidValue;
  return condensed_rows::dispatch(dtype, vtype, block_rows, x, codes, indices,
                                  static_cast<const float*>(scales), nullptr, y, batch, d_in,
                                  n_out, k, n_out, rows_per_warp,
                                  static_cast<cudaStream_t>(stream));
}

const char* condensed_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
