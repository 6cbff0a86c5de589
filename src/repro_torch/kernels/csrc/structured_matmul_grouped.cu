// Expert-grouped structured matmul for Hopper (sm_90a), forward only: K5-moe
// and K6-moe, K5 and K6 (structured_matmul.cu) over an MoE layer's expert
// stack in one launch.
//
//   out[e, b, active_index[e, j]] = sum_i f32(x[e, b, i]) * f32(w[e, i, j])       (K5-moe)
//   out[e, b, active_index[e, j]] = sum_i f32(x[e, b, i]) * f32(w[e, i, c(e, j)])  (K6-moe)
//
// with c(e, j) = active_index[e, j] (the dense weight read in place), f32
// accumulate, cast once; sentinel slots (active_index == d_out) are
// dropped and every other column is exactly 0. They replace the reference's
// jax.vmap of StructuredFanIn.apply over the experts, which turns
// repro/kernels/structured_matmul.py::_structured_kernel
// (_structured_prefetch_kernel) into one pallas_call with an expert grid
// axis.
//
// The bodies are structured_rows.cuh's, instantiated with kGrouped = true:
// each block moves its pointers to its expert's problem and then runs the
// one-expert body, so expert e equals structured_matmul_fwd on its slices
// bitwise. Ragged experts: the stack's a_pad is the largest expert's padded
// surviving count, and an expert's padding slots carry the sentinel d_out.
// This translation unit holds only the grouped instantiations, so the plain
// launches compile without the expert offset and both sources build in
// parallel.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "structured_rows.cuh"

extern "C" {

// K5-moe (gather = 0: w is the experts' (d_in, a_pad) panels, ld_w = a_pad)
// and K6-moe (gather = 1: w is the experts' dense (d_in, d_out) weights,
// ld_w = d_out), `experts` problems stored one after another: x (experts,
// batch, d_in), w (experts, d_in, ld_w), active_index (experts, a_pad), out
// (experts, batch, d_out). out: out_bytes bytes, at least the outputs, then
// (float32) every expert's tickets, as structured_matmul_fwd's. workspace
// (float32): ws_floats, at least experts * ceil(d_in / 256) * batch * a_pad.
// The launch arguments are structured_matmul_fwd's, one expert's. Returns the cudaError_t (0 = success).
int structured_matmul_grouped_fwd(const void* x, const void* w, const void* active_index,
                                  void* out, long long out_bytes, void* workspace,
                                  long long ws_floats, int experts, int batch, int d_in,
                                  int a_pad, int d_out, int ld_w, int gather, int dtype,
                                  int block_rows, int split_rows, void* stream) {
  if (experts <= 0 ||
      !structured_args_ok(batch, d_in, a_pad, d_out, ld_w, gather, dtype, block_rows,
                          split_rows))
    return cudaErrorInvalidValue;
  // the expert shares grid z with the batch tiles (structured_mma,
  // structured_kernel)
  if (static_cast<long long>(experts) * ((batch + block_rows - 1) / block_rows) > 65535)
    return cudaErrorInvalidValue;
  const long long splits = (d_in + split_rows - 1) / split_rows;
  const long long ws_per = dtype == 0 ? splits * batch * a_pad : 0;
  const long long tickets_per =
      dtype == 0 ? static_cast<long long>(f32_tickets(batch, a_pad, block_rows)) : 0;
  const size_t outs = static_cast<size_t>(experts) * batch * d_out * dtype_size(dtype);
  const size_t zeroed = dtype == 1 ? outs
                                   : tickets_offset(experts * batch, d_out, 4) +
                                         static_cast<size_t>(experts * tickets_per) * sizeof(int);
  if (out_bytes < static_cast<long long>(zeroed) || ws_floats < experts * ws_per)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, zeroed, s);
  if (err != cudaSuccess) return err;
  int* tickets = dtype == 1 ? nullptr
                            : reinterpret_cast<int*>(static_cast<char*>(out) +
                                                     tickets_offset(experts * batch, d_out, 4));
  const SGroup grp = {experts,
                      static_cast<long long>(batch) * d_in,
                      static_cast<long long>(d_in) * ld_w,
                      a_pad,
                      static_cast<long long>(batch) * d_out,
                      ws_per,
                      tickets_per};
  return structured_launch<true>(x, w, active_index, out, static_cast<float*>(workspace),
                                 tickets, batch, d_in, a_pad, d_out, ld_w, gather, dtype,
                                 block_rows, split_rows, grp, s);
}

const char* structured_matmul_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
