// Values gradient of the condensed constant fan-in matmul for Hopper
// (sm_90a): K3.
//
//   dw[n, k] = sum_b f32(dy[b, n]) * f32(x[b, idx[n, k]])   (f32 accumulator, f32 out)
//
// dy: (B, n_out), x: (B, d_in), both float32 or both bfloat16; idx:
// (n_out, k) int32; dw: (n_out, k) float32. A duplicate index gets its own
// entry (the kernel gathers and never scatters). Every index must lie in
// [0, d_in): the kernel does not check (an export's indices always do).
//
// Replaces the TPU kernel repro/kernels/condensed_matmul.py::_dw_kernel
// (launched by _dw_tiled through condensed_matmul_dw), the values gradient
// of the condensed linears' custom VJPs in repro/kernels/ops.py.
//
// Bound: dy, x, idx and dw each once is (B * (n_out + d_in)) * sizeof(T) +
// 8 * n_out * k bytes; the work is 2 * B * n_out * k operations on inputs of
// type T, at the card's peak for T (989 TFLOP/s for bfloat16 with float32
// accumulation, 67 TFLOP/s for float32). At the training shapes of
// qwen3-1.7b (B*T = 512, k = 195..585) that is about 68 flops per byte in
// bfloat16, below the ~295 at which its rate meets HBM's 3.35 TB/s, so the
// bytes bound it; in float32 about 46, above the ~20 of the float32 rate,
// so the operations do. What this simple kernel pays beyond either is
// staging and its serial batch loop: every block reads the whole of x once
// (idx may address any input feature), so x crosses L2 n_out / kWarps
// times, and the CUDA cores do every multiply-add in float32.
// Design:
//   * One warp per neuron row, kWarps rows per block; lane l holds the k
//     slots l, l + 32, ... of its row (up to kSlots = 20 per lane, so a
//     640-wide chunk of k; wider k takes more chunks on grid.y) with their
//     indices and float32 accumulators in registers.
//   * The block loops over ALL batch tiles in order. A tile of BT rows of x
//     is staged in shared memory transposed, the BT values of one feature
//     side by side (as K1 stages it, condensed_rows.cuh), so one gather is
//     one vector load that feeds BT multiply-adds. BT * d_in * sizeof(T)
//     fits the 227 KB a block may opt into: the wrapper picks the largest
//     BT of 8, 4, 2, 1 that does.
//   * Each accumulator adds its batch rows strictly in order b = 0, 1, ...,
//     B - 1 (one fmaf each), whatever BT: no atomics and no split of the
//     batch, so the result is deterministic and bitwise independent of the
//     tiling.
//   * The kernel allocates nothing and launches on the caller's stream.
// wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace condensed_dw {
namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 20;           // k slots per lane
constexpr int kChunk = 32 * kSlots;  // k columns per block (grid.y chunks)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int BT>
struct alignas(sizeof(T) * BT < 16 ? sizeof(T) * BT : 16) Column {
  T v[BT];
};

// grid: (ceil(n_out / kWarps), ceil(k / kChunk)); block: kThreads.
// Dynamic shared memory: d_in Columns (BT * d_in elements of T).
template <typename T, int BT>
__global__ void __launch_bounds__(kThreads, 1)
dw_kernel(const T* __restrict__ dy, const T* __restrict__ x, const int32_t* __restrict__ idx,
          float* __restrict__ dw, int batch, int d_in, int n_out, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Column<T, BT>* cols = reinterpret_cast<Column<T, BT>*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int k0 = blockIdx.y * kChunk;
  // slots of this warp's row in this chunk (0 for a row past n_out)
  const int kc = n < n_out ? min(kChunk, k - k0) : 0;

  int ii[kSlots];
  float acc[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = lane + 32 * j;
    ii[j] = s < kc ? __ldg(idx + static_cast<size_t>(n) * k + k0 + s) : 0;
    acc[j] = 0.f;
  }

  for (int b0 = 0; b0 < batch; b0 += BT) {
    const int nb = min(BT, batch - b0);
    __syncthreads();  // every warp is done with the previous tile
    // Stage rows b0 .. b0 + nb - 1 of x, one Column per input feature;
    // neighbouring threads read neighbouring features (coalesced).
    const T* xsrc = x + static_cast<size_t>(b0) * d_in;
    for (int i = threadIdx.x; i < d_in; i += kThreads) {
      Column<T, BT> c;
#pragma unroll
      for (int b = 0; b < BT; ++b)
        c.v[b] = b < nb ? xsrc[static_cast<size_t>(b) * d_in + i] : xsrc[i];
      cols[i] = c;
    }
    __syncthreads();
    if (kc == 0) continue;  // uniform across the warp

    float d[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b)  // one address per warp: a broadcast load
      d[b] = b < nb ? to_f32(dy[static_cast<size_t>(b0 + b) * n_out + n]) : 0.f;

#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (32 * j >= kc) break;  // uniform across the warp
      if (lane + 32 * j < kc) {
        const Column<T, BT> c = cols[ii[j]];
        float a = acc[j];
        if (nb == BT) {
#pragma unroll
          for (int b = 0; b < BT; ++b) a = fmaf(d[b], to_f32(c.v[b]), a);
        } else {  // the last, partial tile: rows past the batch add nothing
#pragma unroll
          for (int b = 0; b < BT; ++b)
            if (b < nb) a = fmaf(d[b], to_f32(c.v[b]), a);
        }
        acc[j] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = lane + 32 * j;
    if (s < kc) dw[static_cast<size_t>(n) * k + k0 + s] = acc[j];
  }
}

template <typename T, int BT>
cudaError_t launch(const void* dy, const void* x, const void* idx, float* dw, int batch,
                   int d_in, int n_out, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BT) * d_in * sizeof(T);
  auto kernel = dw_kernel<T, BT>;
  // Opt in above the 48 KB default once per instantiation and size.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((n_out + kWarps - 1) / kWarps, (k + kChunk - 1) / kChunk);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(dy), static_cast<const T*>(x),
                                           static_cast<const int32_t*>(idx), dw, batch, d_in,
                                           n_out, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int block_rows, const void* dy, const void* x, const void* idx,
                          float* dw, int batch, int d_in, int n_out, int k,
                          cudaStream_t stream) {
  switch (block_rows) {
    case 1: return launch<T, 1>(dy, x, idx, dw, batch, d_in, n_out, k, stream);
    case 2: return launch<T, 2>(dy, x, idx, dw, batch, d_in, n_out, k, stream);
    case 4: return launch<T, 4>(dy, x, idx, dw, batch, d_in, n_out, k, stream);
    case 8: return launch<T, 8>(dy, x, idx, dw, batch, d_in, n_out, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace condensed_dw

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dy and x). block_rows: 1, 2, 4 or 8 rows
// of x per staged tile. dw: n_out * k float32. Returns the cudaError_t of
// the launch (0 = success).
int condensed_matmul_dw(const void* dy, const void* x, const void* indices, void* dw,
                        int batch, int d_in, int n_out, int k, int dtype, int block_rows,
                        void* stream) {
  if (batch <= 0 || n_out <= 0 || d_in <= 0 || k <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto out = static_cast<float*>(dw);
  if (dtype == 0)
    return condensed_dw::dispatch_rows<float>(block_rows, dy, x, indices, out, batch, d_in,
                                              n_out, k, s);
  if (dtype == 1)
    return condensed_dw::dispatch_rows<__nv_bfloat16>(block_rows, dy, x, indices, out, batch,
                                                      d_in, n_out, k, s);
  return cudaErrorInvalidValue;
}

const char* condensed_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
