// Condensed constant fan-in matmul for Hopper (sm_90a), forward only.
//
//   y[b, n] = sum_k f32(x[b, idx[n, k]]) * f32(values[n, k])   (f32 accumulator)
//
// cast to the dtype of x. x: (B, d_in); values, idx: (n_out, k), idx int32;
// y: (B, n_out). x and values are both float32 or both bfloat16. Every
// index must lie in [0, d_in): the kernel does not check (an export's
// indices come from a sort of the rows, so they always do). Padding slots
// have value 0 and index an inactive row, so they add exact zeros.
//
// Replaces the TPU kernel repro/kernels/condensed_matmul.py::_fwd_kernel,
// in both its launches: _fwd_decode (B <= 8, batch staged whole, grid over
// neuron tiles) and _fwd_tiled (grid over batch tiles x neuron tiles).
//
// Bound: bytes. Every (value, index) pair is used once per batch row, so at
// decode batch sizes the kernel does ~2*B flops per 6 (bf16) or 8 (f32)
// bytes streamed: values + indices + x + y over the 3.35 TB/s of HBM is the
// least time. Design against that bound:
//   * One warp per output neuron; the lanes stride k, so each warp streams
//     its neuron's values and indices with coalesced loads, and the lanes'
//     partial sums meet in a shuffle tree.
//   * The block's BT rows of x sit in shared memory (idx may address any
//     input feature, so the whole d_in row is staged, as the TPU kernel
//     stages it in VMEM), transposed so that the BT values of one feature
//     are adjacent: each gather is one vector load for all BT rows, and HBM
//     sees each weight byte once per batch tile. BT * d_in * sizeof(T) must
//     fit the 227 KB a block may opt into: the wrapper shrinks BT for wide
//     d_in (at d_in = 6144, 8 bf16 rows take 96 KB).
//   * Each row's reduction order (lane-strided k, then the same shuffle
//     tree) does not depend on BT or on the grid, so the decode launch
//     (BT = B rounded up to a power of two) is bitwise equal to the tiled
//     launch (BT = 8), the promise of condensed_matmul_decode in the
//     reference.
//   * The kernel allocates nothing and launches on the caller's stream.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// grid: (ceil(n_out / (kWarps * rows_per_warp)), ceil(B / BT)); block: kThreads.
// Dynamic shared memory: d_in Columns (BT * d_in elements of T).
template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
condensed_fwd_kernel(const T* __restrict__ x, const T* __restrict__ values,
                     const int32_t* __restrict__ idx, T* __restrict__ y,
                     int batch, int d_in, int n_out, int k, int rows_per_warp) {
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
    if (n >= n_out) break;  // uniform across the warp
    const T* vrow = values + static_cast<size_t>(n) * k;
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
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (lane == b && b < nb) y[static_cast<size_t>(b0 + b) * n_out + n] = from_f32<T>(acc[b]);
  }
}

template <typename T, int BT>
cudaError_t launch(const void* x, const void* values, const void* idx, void* y,
                   int batch, int d_in, int n_out, int k, int rows_per_warp,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BT) * d_in * sizeof(T);
  auto kernel = condensed_fwd_kernel<T, BT>;
  // Opt in above the 48 KB default once per instantiation and size.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int per_block = kWarps * rows_per_warp;
  const dim3 grid((n_out + per_block - 1) / per_block, (batch + BT - 1) / BT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(values),
      static_cast<const int32_t*>(idx), static_cast<T*>(y),
      batch, d_in, n_out, k, rows_per_warp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int block_rows, const void* x, const void* values, const void* idx,
                          void* y, int batch, int d_in, int n_out, int k,
                          int rows_per_warp, cudaStream_t stream) {
  switch (block_rows) {
    case 1: return launch<T, 1>(x, values, idx, y, batch, d_in, n_out, k, rows_per_warp, stream);
    case 2: return launch<T, 2>(x, values, idx, y, batch, d_in, n_out, k, rows_per_warp, stream);
    case 4: return launch<T, 4>(x, values, idx, y, batch, d_in, n_out, k, rows_per_warp, stream);
    case 8: return launch<T, 8>(x, values, idx, y, batch, d_in, n_out, k, rows_per_warp, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, values and y). block_rows: 1, 2, 4 or 8
// rows of x per block. Returns the cudaError_t of the launch (0 = success).
int condensed_matmul_fwd(const void* x, const void* values, const void* indices, void* y,
                         int batch, int d_in, int n_out, int k, int dtype,
                         int block_rows, int rows_per_warp, void* stream) {
  if (batch <= 0 || n_out <= 0 || d_in <= 0 || k < 0 || rows_per_warp <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_rows<float>(block_rows, x, values, indices, y, batch, d_in, n_out, k,
                                rows_per_warp, s);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(block_rows, x, values, indices, y, batch, d_in,
                                        n_out, k, rows_per_warp, s);
  return cudaErrorInvalidValue;
}

const char* condensed_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
