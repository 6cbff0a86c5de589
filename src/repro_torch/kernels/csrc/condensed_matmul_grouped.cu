// Expert-grouped condensed matmul for Hopper (sm_90a), forward only: K1-moe
// and K2-moe, K1 and K2 (condensed_matmul.cu) over an MoE layer's expert
// stack in one launch.
//
//   y[e, b, n] = sum_k f32(x[e, b, idx[e, n, k]]) * f32(values[e, n, k])        (K1-moe)
//   y[e, b, n] = (sum_k f32(x[e, b, idx[e, n, k]]) * f32(q[e, n, k])) * scales[e, n]  (K2-moe)
//
// They replace the reference's jax.vmap of Condensed.apply over the experts,
// which turns repro/kernels/condensed_matmul.py::_fwd_kernel
// (_fwd_scaled_kernel) into one pallas_call with an expert grid axis.
//
// The bodies are condensed_rows.cuh's, instantiated with kGrouped = true:
// each block moves its pointers to its expert's problem and then runs the
// one-expert body, so expert e equals condensed_matmul_fwd
// (condensed_matmul_scaled_fwd) on its slices bitwise. This translation unit
// holds only the grouped instantiations, so the plain launches
// (condensed_matmul.cu, structured_matmul.cu) compile without the expert
// offset and both sources build in parallel.
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
                                     static_cast<long long>(batch) * n_out};
  return condensed_rows::dispatch<true>(dtype, vtype, block_rows, rows_per_warp, split_rows,
                                        pass_rows, block_neurons, decode_loads, x, values,
                                        indices, static_cast<const float*>(scales), nullptr, y,
                                        batch, d_in, n_out, k, n_out,
                                        static_cast<cudaStream_t>(stream), grp);
}

const char* condensed_matmul_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
