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
// whose out_index is the sentinel d_out are padding and are dropped. It is
// K1's gather-reduce (condensed_rows.cuh) with the store addressed through
// out_index, so its output at column out_index[r] is bitwise K1's output
// for row r. Bound: bytes (values + indices + out_index + x + out over HBM).
//
// K2-coa (replaces _coa_kernel with scaled=True): K4 over int8 or
// float8_e4m3 codes with one float32 scale per surviving row, multiplied
// after the k-sum, before the cast and the store (condensed_rows.cuh): its
// output at column out_index[r] is bitwise K2's output for row r.
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
// so one call is one memset and one kernel launch (K5/K6 keep their tickets
// right after the output, in the same memset). The TPU kernels' one-hot MXU scatter has no
// counterpart: each result is stored straight to its column (the exports
// guarantee unique columns).
//
// K5/K6 bound: bytes at decode (the panel, or the gathered columns of W,
// dominate: d_in * a_pad elements for 2 * B * d_in * a_pad flops), CUDA-core
// operations at prefill in float32. Design:
//   * A block owns 32 compact columns (one per lane, so a warp reads 32
//     neighbouring elements of one weight row: coalesced for K5, and for K6
//     mostly so, because active_index is sorted ascending) and one split of
//     kSplitRows rows of d_in; its 8 warps take every 8th row of the split.
//     At decode (BT <= 8) each thread loads all 32 of its rows before its
//     first FMA, so that many loads are in flight; the tiled launch streams
//     them in the same order. Splitting d_in over blocks is what gives a
//     wo-sized panel (1024 columns) enough blocks to fill 132 SMs.
//   * The split's BT rows of x sit in shared memory, transposed (one vector
//     load gives all BT rows of one input feature). Only kSplitRows features
//     are staged, so any d_in fits.
//   * Each block sums its warps in order and writes its split's partial sums
//     to a float32 workspace; the last block of a column tile to finish
//     (a ticket taken with atomicAdd after __threadfence) adds the splits in
//     order and stores. So every output's reduction order is fixed (rows of
//     a warp in order, warps 0..7, splits 0..S-1) and depends on neither BT
//     nor the grid: the decode launch (BT = B rounded up to a power of two)
//     is bitwise equal to the tiled launch (BT = 16), and K6 is bitwise
//     equal to K5 on the panel that K5's wrapper gathers.
//   * No wgmma or TMA yet: a plain CUDA-core kernel, simple and right first.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "condensed_rows.cuh"

namespace {

using condensed_rows::Column;
using condensed_rows::from_f32;
using condensed_rows::to_f32;

constexpr int kSplitRows = 256;  // rows of d_in per block; fixes the reduction order
constexpr int kCols = 32;        // compact columns per block, one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kSplitRows / kWarps;

// The output and then, 16-byte aligned, the tickets: one region, cleared by
// one memset.
size_t tickets_offset(int batch, int d_out, size_t elem) {
  return (static_cast<size_t>(batch) * d_out * elem + 15) / 16 * 16;
}

// grid: (ceil(a_pad / kCols), ceil(d_in / kSplitRows), ceil(B / BT)); block: kThreads.
// ws: (splits, B, a_pad) float32 partial sums; tickets: one zeroed int per
// (column tile, batch tile).
template <typename T, int BT, bool kGather>
__global__ void __launch_bounds__(kThreads)
structured_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int32_t* __restrict__ active_index, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int batch, int d_in,
                  int a_pad, int d_out, int ld_w) {
  __shared__ __align__(16) unsigned char xs_raw[kSplitRows * sizeof(Column<T, BT>)];
  __shared__ float red[kWarps][BT][kCols];
  Column<T, BT>* xs = reinterpret_cast<Column<T, BT>*>(xs_raw);
  __shared__ bool last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int i0 = split * kSplitRows;
  const int ni = min(kSplitRows, d_in - i0);
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, batch - b0);

  for (int r = threadIdx.x; r < ni; r += kThreads) {
    Column<T, BT> c;
#pragma unroll
    for (int b = 0; b < BT; ++b)
      c.v[b] = b < nb ? x[static_cast<size_t>(b0 + b) * d_in + i0 + r] : from_f32<T>(0.f);
    xs[r] = c;
  }
  __syncthreads();

  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
  const int j = j0 + lane;
  if (j < a_pad) {
    const int col = kGather ? min(__ldg(active_index + j), d_out - 1) : j;
    const T* wcol = w + static_cast<size_t>(i0) * ld_w + col;
    if constexpr (BT <= 8) {
      // Decode: all of this warp's rows of the split (warp, warp + 8, ...)
      // are loaded before the first FMA, so 32 loads per thread are in
      // flight at once.
      T wv[kRowsPerWarp];
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int r = warp + m * kWarps;
        wv[m] = r < ni ? wcol[static_cast<size_t>(r) * ld_w] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int r = warp + m * kWarps;
        if (r < ni) {
          const Column<T, BT> c = xs[r];
          const float wf = to_f32(wv[m]);
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = fmaf(to_f32(c.v[b]), wf, acc[b]);
        }
      }
    } else {
      // Tiled: the same rows in the same order, streamed (the preloaded
      // registers would cost the 16-row tile its occupancy).
#pragma unroll 8
      for (int r = warp; r < ni; r += kWarps) {
        const float wf = to_f32(wcol[static_cast<size_t>(r) * ld_w]);
        const Column<T, BT> c = xs[r];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(to_f32(c.v[b]), wf, acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();

  // This split's partial sums, warps added in order.
  float* part = ws + (static_cast<size_t>(split) * batch + b0) * a_pad;
  for (int e = threadIdx.x; e < BT * kCols; e += kThreads) {
    const int b = e / kCols, c = e % kCols;
    if (b >= nb || j0 + c >= a_pad) continue;
    float v = red[0][b][c];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) v += red[wi][b][c];
    part[static_cast<size_t>(b) * a_pad + j0 + c] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.z * gridDim.x + blockIdx.x, 1) ==
           static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block of this column tile: add the splits in order and store.
  const size_t split_stride = static_cast<size_t>(batch) * a_pad;
  for (int e = threadIdx.x; e < BT * kCols; e += kThreads) {
    const int b = e / kCols, c = e % kCols;
    if (b >= nb || j0 + c >= a_pad) continue;
    const int dst = __ldg(active_index + j0 + c);
    if (static_cast<unsigned>(dst) >= static_cast<unsigned>(d_out)) continue;  // sentinel
    const float* p = ws + static_cast<size_t>(b0 + b) * a_pad + j0 + c;
    float v = __ldcg(p);
    for (int s = 1; s < static_cast<int>(gridDim.y); ++s) v += __ldcg(p + s * split_stride);
    out[static_cast<size_t>(b0 + b) * d_out + dst] = from_f32<T>(v);
  }
}

template <typename T, int BT, bool kGather>
cudaError_t launch_structured(const void* x, const void* w, const void* active_index, void* out,
                              float* ws, int* tickets, int batch, int d_in, int a_pad, int d_out,
                              int ld_w, cudaStream_t stream) {
  const dim3 grid((a_pad + kCols - 1) / kCols, (d_in + kSplitRows - 1) / kSplitRows,
                  (batch + BT - 1) / BT);
  structured_kernel<T, BT, kGather><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int32_t*>(active_index), static_cast<T*>(out), ws, tickets, batch, d_in,
      a_pad, d_out, ld_w);
  return cudaGetLastError();
}

template <typename T, bool kGather>
cudaError_t dispatch_structured(int block_rows, const void* x, const void* w,
                                const void* active_index, void* out, float* ws, int* tickets,
                                int batch, int d_in, int a_pad, int d_out, int ld_w,
                                cudaStream_t s) {
  switch (block_rows) {
    case 1: return launch_structured<T, 1, kGather>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, s);
    case 2: return launch_structured<T, 2, kGather>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, s);
    case 4: return launch_structured<T, 4, kGather>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, s);
    case 8: return launch_structured<T, 8, kGather>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, s);
    case 16: return launch_structured<T, 16, kGather>(x, w, active_index, out, ws, tickets, batch,
                                                      d_in, a_pad, d_out, ld_w, s);
    default: return cudaErrorInvalidValue;
  }
}

size_t dtype_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

extern "C" {

// K4. dtype: 0 = float32, 1 = bfloat16 (x, values and out). block_rows: 1,
// 2, 4 or 8 rows of x per block. Returns the cudaError_t (0 = success).
int coa_matmul_fwd(const void* x, const void* values, const void* indices, const void* out_index,
                   void* out, int batch, int d_in, int a, int k, int d_out, int dtype,
                   int block_rows, int rows_per_warp, void* stream) {
  if (batch <= 0 || a <= 0 || d_in <= 0 || d_out <= 0 || k < 0 || rows_per_warp <= 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * dtype_size(dtype), s);
  if (err != cudaSuccess) return err;
  return condensed_rows::dispatch(dtype, 0, block_rows, x, values, indices, nullptr, out_index,
                                  out, batch, d_in, a, k, d_out, rows_per_warp, s);
}

// K2-coa. As coa_matmul_fwd, with int8 (vtype 1) or float8_e4m3 (vtype 2)
// codes and a float32 scale per row (scales: a floats).
int coa_matmul_scaled_fwd(const void* x, const void* codes, const void* indices,
                          const void* out_index, const void* scales, void* out, int batch,
                          int d_in, int a, int k, int d_out, int dtype, int vtype,
                          int block_rows, int rows_per_warp, void* stream) {
  if (batch <= 0 || a <= 0 || d_in <= 0 || d_out <= 0 || k < 0 || rows_per_warp <= 0 ||
      (dtype != 0 && dtype != 1) || (vtype != 1 && vtype != 2) || scales == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * dtype_size(dtype), s);
  if (err != cudaSuccess) return err;
  return condensed_rows::dispatch(dtype, vtype, block_rows, x, codes, indices,
                                  static_cast<const float*>(scales), out_index, out, batch, d_in,
                                  a, k, d_out, rows_per_warp, s);
}

// K5 (gather = 0: w is the (d_in, a_pad) panel, ld_w = a_pad) and K6
// (gather = 1: w is the dense (d_in, d_out) weight, ld_w = d_out).
// out: out_bytes bytes, at least structured_matmul_out_bytes(...): the
// (batch, d_out) output, then the tickets. workspace: ws_floats float32
// elements, at least ceil(d_in / 256) * batch * a_pad, for the partial sums.
// block_rows: 1, 2, 4, 8 or 16. Returns the cudaError_t (0 = success).
int structured_matmul_fwd(const void* x, const void* w, const void* active_index, void* out,
                          long long out_bytes, void* workspace, long long ws_floats, int batch,
                          int d_in, int a_pad, int d_out, int ld_w, int gather, int dtype,
                          int block_rows, void* stream) {
  if (batch <= 0 || d_in <= 0 || a_pad <= 0 || d_out <= 0 || block_rows <= 0 ||
      (dtype != 0 && dtype != 1) || ld_w < (gather ? d_out : a_pad))
    return cudaErrorInvalidValue;
  const long long splits = (d_in + kSplitRows - 1) / kSplitRows;
  const size_t n_tickets =
      static_cast<size_t>((a_pad + kCols - 1) / kCols) * ((batch + block_rows - 1) / block_rows);
  const size_t zeroed = tickets_offset(batch, d_out, dtype_size(dtype)) + n_tickets * sizeof(int);
  if (ws_floats < splits * batch * a_pad || out_bytes < static_cast<long long>(zeroed))
    return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  int* tickets = reinterpret_cast<int*>(static_cast<char*>(out) +
                                        tickets_offset(batch, d_out, dtype_size(dtype)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, zeroed, s);
  if (err != cudaSuccess) return err;
  if (dtype == 0)
    return gather ? dispatch_structured<float, true>(block_rows, x, w, active_index, out, ws,
                                                     tickets, batch, d_in, a_pad, d_out, ld_w, s)
                  : dispatch_structured<float, false>(block_rows, x, w, active_index, out, ws,
                                                      tickets, batch, d_in, a_pad, d_out, ld_w, s);
  return gather ? dispatch_structured<__nv_bfloat16, true>(block_rows, x, w, active_index, out, ws,
                                                           tickets, batch, d_in, a_pad, d_out,
                                                           ld_w, s)
                : dispatch_structured<__nv_bfloat16, false>(block_rows, x, w, active_index, out,
                                                            ws, tickets, batch, d_in, a_pad,
                                                            d_out, ld_w, s);
}

// Bytes of the region structured_matmul_fwd takes as out: the output and
// the tickets.
long long structured_matmul_out_bytes(int batch, int d_out, int a_pad, int dtype,
                                      int block_rows) {
  if (batch <= 0 || d_out <= 0 || a_pad <= 0 || block_rows <= 0) return 0;
  const size_t n_tickets =
      static_cast<size_t>((a_pad + kCols - 1) / kCols) * ((batch + block_rows - 1) / block_rows);
  return static_cast<long long>(tickets_offset(batch, d_out, dtype_size(dtype)) +
                                n_tickets * sizeof(int));
}

const char* structured_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
