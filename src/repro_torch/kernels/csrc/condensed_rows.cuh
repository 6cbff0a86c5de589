// The condensed gather-reduce body shared by K1 and K2 (condensed_matmul.cu)
// and K4 and K2-coa (structured_matmul.cu), for Hopper (sm_90a):
//
//   y[b, col(n)] = (sum_k f32(x[b, idx[n, k]]) * f32(values[n, k])) * s(n)   (f32)
//
// cast to the dtype of x. x: (B, d_in); values, idx: (n_rows, k), idx int32;
// y: (B, ld_y). x is float32 or bfloat16 (T); values are stored as V: T
// itself (K1, K4), or int8 / float8_e4m3 codes (K2, K2-coa), each with a
// float32 scale per row, s(n) = scales[n], multiplied into the row's sum
// after the k-reduction and before the one cast. With no scales (null)
// nothing is multiplied, so K1's bits are K1's. Every index
// must lie in [0, d_in): the kernel does not check (an export's indices come
// from a sort of the rows, so they always do). Padding slots have value 0
// and index an inactive row, so they add exact zeros.
//
// col(n) = n when out_index is null (K1: ld_y = n_rows). Otherwise row n is
// stored at column out_index[n] and dropped when that is not in [0, ld_y)
// (K4: the d_out sentinel marks padding rows). Row n's arithmetic is the
// same either way, so K4's output at column out_index[n] is bitwise K1's
// output for row n.
//
// Bound: bytes. Every (value, index) pair is used once per batch row, so at
// decode batch sizes the kernel does ~2*B flops per 5 (int8/fp8 codes), 6
// (bf16) or 8 (f32) bytes streamed: values + indices (+ scales) + x + y over
// the 3.35 TB/s of HBM is the least time. Design against that bound:
//   * One warp per row; the lanes stride k, so each warp streams its row's
//     values and indices with coalesced loads, and the lanes' partial sums
//     meet in a shuffle tree.
//   * The block's BT rows of x sit in shared memory (idx may address any
//     input feature, so the whole d_in row is staged, as the TPU kernel
//     stages it in VMEM), transposed so that the BT values of one feature
//     are adjacent: each gather is one vector load for all BT rows, and HBM
//     sees each weight byte once per batch tile. BT * d_in * sizeof(T) must
//     fit the 227 KB a block may opt into: the wrappers shrink BT for wide
//     d_in (at d_in = 6144, 8 bf16 rows take 96 KB).
//   * Each row's reduction order (lane-strided k, then the same shuffle
//     tree) does not depend on BT or on the grid, so the decode launch
//     (BT = B rounded up to a power of two) is bitwise equal to the tiled
//     launch (BT = 8). It does not depend on V either: a code converts to
//     float32 exactly (int8 sign-extends; E4M3 widens), so in float32
//     K2(x, q, idx, s) is bitwise K1(x, f32(q), idx) * s.
//   * Codes are 1-byte loads strided by lane, one beside each 4-byte index
//     (no vectorisation across lanes).
//   * The kernel allocates nothing and launches on the caller's stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: K1 and K4 are two shared libraries loaded into one
// process, and a template's function-local static (the shared-memory opt-in
// below) or host stub with external linkage would be one object for both.
namespace condensed_rows {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The BT rows of x at one input feature, side by side, so that one gather
// is one vector load from shared memory.
template <typename T, int BT>
struct alignas(sizeof(T) * BT < 16 ? sizeof(T) * BT : 16) Column {
  T v[BT];
};

// grid: (ceil(n_rows / (kWarps * rows_per_warp)), ceil(B / BT)); block: kThreads.
// Dynamic shared memory: d_in Columns (BT * d_in elements of T).
template <typename T, typename V, int BT>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ x, const V* __restrict__ values,
                   const int32_t* __restrict__ idx, const float* __restrict__ scales,
                   const int32_t* __restrict__ out_index, T* __restrict__ y, int batch,
                   int d_in, int n_rows, int k, int ld_y, int rows_per_warp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Column<T, BT>* cols = reinterpret_cast<Column<T, BT>*>(smem_raw);

  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, batch - b0);

  // Stage rows b0 .. b0 + nb - 1 of x, transposed to one Column per input
  // feature; rows past the batch are zero. Neighbouring threads read
  // neighbouring features of a row, so the global reads coalesce.
  const T* xsrc = x + static_cast<size_t>(b0) * d_in;
  for (int i = threadIdx.x; i < d_in; i += kThreads) {
    Column<T, BT> c;
#pragma unroll
    for (int b = 0; b < BT; ++b)
      c.v[b] = b < nb ? xsrc[static_cast<size_t>(b) * d_in + i] : from_f32<T>(0.f);
    cols[i] = c;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_first = (blockIdx.x * kWarps + warp) * rows_per_warp;
  for (int r = 0; r < rows_per_warp; ++r) {
    const int n = n_first + r;
    if (n >= n_rows) break;  // uniform across the warp
    const int col = out_index == nullptr ? n : out_index[n];
    if (static_cast<unsigned>(col) >= static_cast<unsigned>(ld_y)) continue;  // dropped row
    const V* vrow = values + static_cast<size_t>(n) * k;
    const int32_t* irow = idx + static_cast<size_t>(n) * k;

    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;

#pragma unroll 4
    for (int j = lane; j < k; j += 32) {
      const int i = __ldg(irow + j);
      const float w = to_f32(vrow[j]);
      const Column<T, BT> c = cols[i];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = fmaf(to_f32(c.v[b]), w, acc[b]);
    }

#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[b] = v;  // every lane now holds the same row sum
    }
    if (scales != nullptr) {  // dequantize: one multiply per output, after the sum
      const float s = __ldg(scales + n);
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] *= s;
    }
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (lane == b && b < nb) y[static_cast<size_t>(b0 + b) * ld_y + col] = from_f32<T>(acc[b]);
  }
}

template <typename T, typename V, int BT>
cudaError_t launch(const void* x, const void* values, const void* idx, const float* scales,
                   const void* out_index, void* y, int batch, int d_in, int n_rows, int k,
                   int ld_y, int rows_per_warp, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BT) * d_in * sizeof(T);
  auto kernel = gather_rows_kernel<T, V, BT>;
  // Opt in above the 48 KB default once per instantiation and size.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int per_block = kWarps * rows_per_warp;
  const dim3 grid((n_rows + per_block - 1) / per_block, (batch + BT - 1) / BT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const V*>(values),
      static_cast<const int32_t*>(idx), scales, static_cast<const int32_t*>(out_index),
      static_cast<T*>(y), batch, d_in, n_rows, k, ld_y, rows_per_warp);
  return cudaGetLastError();
}

template <typename T, typename V>
cudaError_t dispatch_rows(int block_rows, const void* x, const void* values, const void* idx,
                          const float* scales, const void* out_index, void* y, int batch,
                          int d_in, int n_rows, int k, int ld_y, int rows_per_warp,
                          cudaStream_t stream) {
  switch (block_rows) {
    case 1: return launch<T, V, 1>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                   k, ld_y, rows_per_warp, stream);
    case 2: return launch<T, V, 2>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                   k, ld_y, rows_per_warp, stream);
    case 4: return launch<T, V, 4>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                   k, ld_y, rows_per_warp, stream);
    case 8: return launch<T, V, 8>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                   k, ld_y, rows_per_warp, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_values(int vtype, int block_rows, const void* x, const void* values,
                            const void* idx, const float* scales, const void* out_index,
                            void* y, int batch, int d_in, int n_rows, int k, int ld_y,
                            int rows_per_warp, cudaStream_t stream) {
  switch (vtype) {
    case 0: return dispatch_rows<T, T>(block_rows, x, values, idx, scales, out_index, y, batch,
                                       d_in, n_rows, k, ld_y, rows_per_warp, stream);
    case 1: return dispatch_rows<T, int8_t>(block_rows, x, values, idx, scales, out_index, y,
                                            batch, d_in, n_rows, k, ld_y, rows_per_warp,
                                            stream);
    case 2: return dispatch_rows<T, __nv_fp8_e4m3>(block_rows, x, values, idx, scales,
                                                   out_index, y, batch, d_in, n_rows, k, ld_y,
                                                   rows_per_warp, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (x and y). vtype: 0 = values of x's
// dtype (scales null), 1 = int8 codes, 2 = float8_e4m3 codes (scales: one
// float32 per row, required).
cudaError_t dispatch(int dtype, int vtype, int block_rows, const void* x, const void* values,
                     const void* idx, const float* scales, const void* out_index, void* y,
                     int batch, int d_in, int n_rows, int k, int ld_y, int rows_per_warp,
                     cudaStream_t stream) {
  if ((vtype == 0) != (scales == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_values<float>(vtype, block_rows, x, values, idx, scales, out_index, y,
                                  batch, d_in, n_rows, k, ld_y, rows_per_warp, stream);
  if (dtype == 1)
    return dispatch_values<__nv_bfloat16>(vtype, block_rows, x, values, idx, scales, out_index,
                                          y, batch, d_in, n_rows, k, ld_y, rows_per_warp,
                                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace condensed_rows
