// Expert-grouped condensed matmuls for Hopper (sm_90a), forward only: K1-moe
// and K2-moe, K1 and K2 (condensed_matmul.cu) over an MoE layer's expert
// stack in one launch, and K4-moe and K2-coa-moe, K4 and K2-coa
// (structured_matmul.cu) the same way.
//
//   y[e, b, n] = sum_k f32(x[e, b, idx[e, n, k]]) * f32(values[e, n, k])        (K1-moe)
//   y[e, b, n] = (sum_k f32(x[e, b, idx[e, n, k]]) * f32(q[e, n, k])) * scales[e, n]  (K2-moe)
//   y[e, b, out_index[e, r]] = K1-moe's (K2-moe's) row r of expert e, every
//   other column exactly 0, rows at the sentinel d_out dropped   (K4-moe, K2-coa-moe)
//
// They replace the reference's jax.vmap of Condensed.apply (and
// CondensedOverActive.apply) over the experts, which turns
// repro/kernels/condensed_matmul.py::_fwd_kernel (_fwd_scaled_kernel) and
// repro/kernels/structured_matmul.py::_coa_kernel (scaled or not) into one
// pallas_call with an expert grid axis.
//
// The bodies are condensed_rows.cuh's, instantiated with kGrouped = true:
// each block moves its pointers to its expert's problem and then runs the
// one-expert body, so expert e equals condensed_matmul_fwd
// (condensed_matmul_scaled_fwd, coa_matmul_fwd, coa_matmul_scaled_fwd) on
// its slices bitwise. Ragged experts: the stack's rows are a_max, the
// largest expert's surviving count, and an expert's padding rows carry the
// sentinel d_out, which the body drops. This translation unit holds only
// the grouped instantiations, so the plain launches (condensed_matmul.cu,
// structured_matmul.cu) compile without the expert offset and the sources
// build in parallel.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "condensed_rows.cuh"

extern "C" {

// vtype 0 (scales null): K1-moe; vtype 1 = int8 or 2 = float8_e4m3 codes
// (scales: experts x n_out float32): K2-moe. `experts` problems stored one
// after another: x (experts, batch, d_in), values or codes and indices
// (experts, n_out, k), y (experts, batch, n_out). dtype and the launch
// arguments are condensed_matmul_fwd's, one expert's
// (condensed_matmul.launch_args). Returns the cudaError_t of the launch.
int condensed_matmul_grouped_fwd(const void* x, const void* values, const void* indices,
                                 const void* scales, void* y, int experts, int batch, int d_in,
                                 int n_out, int k, int dtype, int vtype, int block_rows,
                                 int rows_per_warp, int split_rows, int pass_rows,
                                 int block_neurons, int decode_loads, void* stream) {
  const condensed_rows::Group grp = {experts, static_cast<long long>(batch) * d_in,
                                     static_cast<long long>(n_out) * k, n_out,
                                     static_cast<long long>(batch) * n_out, 0};
  return condensed_rows::dispatch<true>(dtype, vtype, block_rows, rows_per_warp, split_rows,
                                        pass_rows, block_neurons, decode_loads, x, values,
                                        indices, static_cast<const float*>(scales), nullptr, y,
                                        batch, d_in, n_out, k, n_out,
                                        static_cast<cudaStream_t>(stream), grp);
}

// vtype 0 (scales null): K4-moe; vtype 1 = int8 or 2 = float8_e4m3 codes
// (scales: experts x a float32): K2-coa-moe. As condensed_matmul_grouped_fwd
// over a surviving rows an expert, each stored at its column out_index[e, r]
// (experts x a int32, d_out = a padding row) of y (experts, batch, d_out),
// which is cleared first on the stream: one memset and one kernel launch.
// The launch arguments are coa_matmul_fwd's, one expert's.
int coa_matmul_grouped_fwd(const void* x, const void* values, const void* indices,
                           const void* out_index, const void* scales, void* y, int experts,
                           int batch, int d_in, int a, int k, int d_out, int dtype, int vtype,
                           int block_rows, int rows_per_warp, int split_rows, int pass_rows,
                           int block_neurons, int decode_loads, void* stream) {
  if (experts <= 0 || batch <= 0 || a <= 0 || d_out <= 0 || out_index == nullptr ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per = static_cast<long long>(batch) * d_out;
  cudaError_t err = cudaMemsetAsync(y, 0, static_cast<size_t>(experts) * per * (dtype ? 2 : 4), s);
  if (err != cudaSuccess) return err;
  const condensed_rows::Group grp = {experts, static_cast<long long>(batch) * d_in,
                                     static_cast<long long>(a) * k, a, per, a};
  return condensed_rows::dispatch<true>(dtype, vtype, block_rows, rows_per_warp, split_rows,
                                        pass_rows, block_neurons, decode_loads, x, values,
                                        indices, static_cast<const float*>(scales), out_index, y,
                                        batch, d_in, a, k, d_out, s, grp);
}

const char* condensed_matmul_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
