// The condensed gather-reduce body shared by K1 and K2 (condensed_matmul.cu)
// and K4 and K2-coa (structured_matmul.cu), for Hopper (sm_90a). It
// replaces the TPU kernels repro/kernels/condensed_matmul.py::_fwd_kernel
// and _fwd_scaled_kernel (launched by _fwd_tiled and _fwd_decode) and
// repro/kernels/structured_matmul.py::_coa_kernel (scaled=False / True):
//
//   y[b, col(n)] = (sum_k f32(x[b, idx[n, k]]) * f32(values[n, k])) * s(n)   (f32)
//
// cast to the dtype of x. x: (B, d_in); values, idx: (n_rows, k), idx int32;
// y: (B, ld_y). x is float32 or bfloat16 (T); values are stored as V: T
// itself (K1, K4), or int8 / float8_e4m3 codes (K2, K2-coa), each with a
// float32 scale per row, s(n) = scales[n], multiplied into the row's sum
// after the k-reduction and before the one cast (no scales: nothing is
// multiplied). Every index must lie in [0, d_in); the kernel does not check
// it (an export's indices come from a sort of the rows, so they do), and a
// slot outside is skipped. Padding slots have value 0 and index an inactive
// row, so they add exact zeros. Indices need not be sorted (an export puts a
// row's active inputs first, in ascending order, then its padding rows).
//
// col(n) = n when out_index is null (K1: ld_y = n_rows). Otherwise row n is
// stored at column out_index[n] and dropped when that is not in [0, ld_y)
// (K4: the d_out sentinel marks padding rows). Row n's arithmetic is the
// same either way, so K4's output at column out_index[n] is bitwise K1's
// output for row n.
//
// Bound: bytes, at decode and at B = 128 alike. Each (value, index) pair is
// used once per batch row, 2 * B flops for 5 (1-byte codes), 6 (bf16) or 8
// (f32) bytes: values + indices (+ scales) + x + y over the 3.35 TB/s of
// HBM (a qwen3-1.7b layer holds 25.2 MB of bf16 slots: 7.6 us at B = 4, 9.7
// us at B = 128). On the CUDA cores the gathers (a random shared-memory read
// of x per slot and batch row) cost far more than those bytes at B = 128;
// a densified tile on the tensor cores multiplies 1 / density more products
// but reads shared memory once per 16 of them.
//
// bfloat16: each output's float32 chain is fixed by d_in alone. d_in falls
// in splits of split_rows = 64 * ceil(d_in / 512) inputs (at most 8); each
// split is one chain of mma.sync.m16n8k16 (bf16 in, f32 sums; swap-AB: the
// neurons as M from a dense bf16 panel of the weight, the batch as the n8
// side from x) over its 64-input chunks in order, four k16 steps a chunk,
// from zero; the splits' partials are added in split order. An mma's output
// (m, n) depends on row m of A, column n of B and its own accumulator only,
// so the chain depends on nothing else -- not the batch tile, the neuron
// tile, the passes or which of the two kernels computes it: decode == tiled
// at any tile, K4 is
// bitwise K1's rows scattered, K2-coa K2's. Codes widen to bf16 exactly (|q|
// <= 127; E4M3 widens) and the scale multiplies the f32 sum before the cast.
//
// gather_mma (the tiled launch, and the decode launch where the decode
// kernel's panel does not fit): a block owns kM neurons (block_neurons),
// one split and the batch tile (1 to 128 rows); the splits' blocks of a
// neuron tile are one thread-block cluster.
//   1. Densify. The cluster's blocks share the tile's slots, a contiguous
//      range of values and indices that HBM sees once per call: each block
//      reads 1/splits of it, kBatch slots a thread in flight, while x's
//      first chunks and the zeroed panel are started, and buckets each slot
//      by the split of its index into an outbox in shared memory (4 bytes:
//      the value's bf16 bits over the row and the input in the split; places
//      from a warp scan of packed counts, no atomics). Past a cluster barrier
//      each block reads its bucket from every outbox with 16-byte distributed
//      shared-memory loads and stores the values into its own panel (kM x
//      split, rows padded by 16 bytes so ldmatrix is free of bank
//      conflicts). Storing each value straight into the owning block's
//      panel, a scattered 2-byte st.shared::cluster a slot, was slower than
//      the CUDA-core gather at every shape on an H100.
//   2. Multiply as K5 does (structured_matmul.cu): ldmatrix from the panel
//      and from x chunks brought by cp.async (a ring of three, two ahead);
//      warp w holds kMW m16 tiles by kNW n8 tiles.
//   3. Reduce. The partial tile goes to shared memory (over the ring and the
//      panel); past a cluster barrier each block adds its share of the tile
//      over the splits in order, reading every block's partial (distributed
//      shared memory), scales, casts once and stores.
//   Where a split's panel for 16 neurons does not fit (d_in past about
//   36k), the panel holds pass_rows inputs of the split and steps 1 and 2
//   run once a pass, every slot read again each pass; each thread's
//   accumulators wait in a stash between passes, so the chain is the one
//   pass's chain. Any d_in runs.
// gather_mma_decode (batch tiles of 1 to 8 rows, where its panel fits: d_in
// up to 6656): a block owns 16 neurons (8, the m16 tile's other rows zero,
// where the grid then still holds at most a block an SM) and every split, so
// no slot crosses a block and no cluster is needed. It reads its neurons'
// slots (one contiguous range) into a panel over all of d_in, then warp w
// runs split w's chain with x's chunks brought into its own buffer by
// cp.async (16-byte piece p of row r at p ^ r), and the partials are added in
// split order. Past d_in 6656 the decode launch runs gather_mma.
//
// Duplicates. A dense tile has one entry per (neuron, input), and two slots
// of a row at one index cannot share a bf16 entry exactly. While it stores
// its panel, each block marks every (row, input) in a bitmap (atomicOr); a
// store that finds its bit set flags the row (in gather_mma, in every block
// of the cluster). A flagged row's outputs come from a CUDA-core chain over
// its k slots in slot order (f32 products of the bf16 operands, the plain
// version's arithmetic), which depends on nothing but the row: the pairs
// above still hold bitwise, and duplicates add, never overwrite. The racing
// panel entries of a flagged row only ever reach that row's outputs, which
// are discarded.
// Non-finite x. The dense tile multiplies every input feature of a split,
// so an inf or NaN in x at a feature that no slot of a row indexes makes that
// row's output NaN (0 * inf), where the gather gives a finite value. Serving
// activations are finite.
// Geometry. condensed_matmul.gather_geometry (d_in and the dtype only) and
// condensed_matmul.launch_args choose every launch: the split, the neuron
// tile and the passes of gather_mma, and where the decode kernel runs with
// how many neurons a block and slot loads a thread. This file makes no choice
// of its own; it checks that a launch fits and sizes its shared memory with
// mma_smem and decode_smem, which the wrapper's formulas equal (chip_smoke.py
// holds them equal through condensed_matmul_smem_bytes): gather_mma takes
// ring 3 * rows * 144 B (rows = the batch tile rounded up to 8) + panel kM *
// (2 * pass_rows + 16) B + outbox 4 * kOutboxCap B + bitmaps kM *
// ceil(pass_rows / 32) * 4 B + flags 8 kM B + counts 512 B (+ a stash of
// kThreads * kM / 2 floats where passes > 1); kM is the widest of 64, 32, 16
// that fits 227 KB at 128 batch rows in one pass (64 at d_in 2048, two
// blocks an SM, and at 6144, one), else 16 in passes. gather_mma_decode takes
// 16 * (2 * splits * split_rows + 16) B + a scratch (bitmaps, then x
// buffers, then partials) + flags: 74 KB at d_in 2048 (three blocks an SM,
// 20 slot loads a thread), 209 KB at 6144 (one, 40 loads).
//
// float32 -- gather_rows_kernel, on the CUDA cores in full float32 (TF32
// would miss the 1e-5 tolerance): one warp per row, the lanes strided over
// k with coalesced loads, the block's BT rows of x (BT <= 8) staged
// transposed in shared memory so one gather is one vector load for all BT
// rows, the lanes' partial sums met in a shuffle tree. That order depends on
// k alone, so decode (BT = B rounded up to a power of two) == tiled (BT = 8)
// bitwise, and a code converts to float32 exactly, so K2(x, q, idx, s) is
// bitwise K1(x, f32(q), idx) * s. Duplicate indices simply add.
//
// Expert-grouped launch (K1-moe, K2-moe, K4-moe, K2-coa-moe: an MoE layer's
// expert stack, the reference's jax.vmap of _fwd_kernel / _fwd_scaled_kernel
// / _coa_kernel over the experts). `experts` problems of one shape (B, d_in,
// n_rows, k) in one launch: expert e reads x + e * B * d_in, values and idx +
// e * n_rows * k, scales + e * n_rows and out_index + e * n_rows, and writes
// y + e * B * ld_y (a Group of element strides; ld_y = d_out for a scatter
// through out_index). The
// expert is a grid axis that no cluster spans: z in gather_rows_kernel and
// gather_mma_decode, z = expert * batch tiles + batch tile in gather_mma.
// Each block offsets its pointers and then runs the body as it stands, so
// every output's chain is the one-expert launch's: the grouped launch equals
// E separate launches bitwise. Grouping is a template argument (kGrouped,
// dispatch<true>): a plain launch (dispatch<false>, kOne) compiles to the
// one-expert kernels with no expert offset, the grouped entry point lives in
// a translation unit of its own (condensed_matmul_grouped.cu).
//
// The kernels allocate nothing and launch on the caller's stream.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// Internal linkage: K1 and K4 are two shared libraries loaded into one
// process, and a template's function-local static (the shared-memory opt-in
// below) or host stub with external linkage would be one object for both.
namespace condensed_rows {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// dynamic shared memory a Hopper block may opt into (227 KB)
constexpr int kSmemMax = 232448;

// Element strides between the experts of a grouped launch (see the header
// note); a plain launch passes kOne, which its kernels never read.
struct Group {
  int experts;
  long long x, slots, rows, y;  // x (B * d_in), values and idx, scales, y
  long long outs;               // out_index (n_rows; 0 where it is null)
};
constexpr Group kOne = {1, 0, 0, 0, 0, 0};
// A block's pointers moved to expert `e`'s problem (written out in each
// kernel, whose parameters are __restrict__ pointers).
#define CONDENSED_ROWS_TO_EXPERT(grp, e)                      \
  do {                                                        \
    const long long e_ = (e);                                 \
    x += e_ * (grp).x;                                        \
    values += e_ * (grp).slots;                               \
    idx += e_ * (grp).slots;                                  \
    if (scales != nullptr) scales += e_ * (grp).rows;         \
    if (out_index != nullptr) out_index += e_ * (grp).outs;   \
    y += e_ * (grp).y;                                        \
  } while (0)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ----------------------------------------------------------------- float32

// The BT rows of x at one input feature, side by side, so that one gather
// is one vector load from shared memory.
template <typename T, int BT>
struct alignas(sizeof(T) * BT < 16 ? sizeof(T) * BT : 16) Column {
  T v[BT];
};

// grid: (ceil(n_rows / (kWarps * rows_per_warp)), ceil(B / BT), experts); block:
// kThreads. Dynamic shared memory: d_in Columns (BT * d_in elements of T).
template <typename T, typename V, int BT, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ x, const V* __restrict__ values,
                   const int32_t* __restrict__ idx, const float* __restrict__ scales,
                   const int32_t* __restrict__ out_index, T* __restrict__ y, int batch,
                   int d_in, int n_rows, int k, int ld_y, int rows_per_warp, Group grp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Column<T, BT>* cols = reinterpret_cast<Column<T, BT>*>(smem_raw);
  if constexpr (kGrouped) CONDENSED_ROWS_TO_EXPERT(grp, blockIdx.z);

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

template <typename V, int BT, bool kGrouped>
cudaError_t launch_rows(const void* x, const void* values, const void* idx, const float* scales,
                        const void* out_index, void* y, int batch, int d_in, int n_rows, int k,
                        int ld_y, int rows_per_warp, const Group& grp, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BT) * d_in * sizeof(float);
  auto kernel = gather_rows_kernel<float, V, BT, kGrouped>;
  // Opt in above the 48 KB default once per instantiation and size.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int per_block = kWarps * rows_per_warp;
  const dim3 grid((n_rows + per_block - 1) / per_block, (batch + BT - 1) / BT, grp.experts);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const V*>(values),
      static_cast<const int32_t*>(idx), scales, static_cast<const int32_t*>(out_index),
      static_cast<float*>(y), batch, d_in, n_rows, k, ld_y, rows_per_warp, grp);
  return cudaGetLastError();
}

template <typename V, bool kGrouped>
cudaError_t dispatch_f32(int block_rows, const void* x, const void* values, const void* idx,
                         const float* scales, const void* out_index, void* y, int batch,
                         int d_in, int n_rows, int k, int ld_y, int rows_per_warp,
                         const Group& grp, cudaStream_t stream) {
  if (rows_per_warp <= 0) return cudaErrorInvalidValue;
  switch (block_rows) {
    case 1: return launch_rows<V, 1, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                     k, ld_y, rows_per_warp, grp, stream);
    case 2: return launch_rows<V, 2, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                     k, ld_y, rows_per_warp, grp, stream);
    case 4: return launch_rows<V, 4, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                     k, ld_y, rows_per_warp, grp, stream);
    case 8: return launch_rows<V, 8, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                     k, ld_y, rows_per_warp, grp, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int kChunk = 64;               // d_in inputs per ring stage: four k16 steps
constexpr int kXRowBytes = kChunk * 2 + 16;  // a batch row of a stage's x: 144 bytes
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;      // chunks loaded ahead of the one computed
constexpr int kMaxSplits = 8;            // the largest portable cluster
constexpr int kMaxTileRows = 128;        // batch rows a block: 16 n8 tiles
constexpr int kN8 = kMaxTileRows / 8;
constexpr int kBatch = 20;               // slot loads a thread keeps in flight
constexpr int kBatch16 = 16;             // the same in gather_mma's 16-neuron tile
constexpr int kOutbox = kThreads * kBatch;  // entries a block buckets a round
// the outbox: kOutbox entries, each bucket starting on a 16-byte boundary
constexpr int kOutboxCap = kOutbox + 4 * kMaxSplits;
constexpr int kDecodeNeurons = 16;       // neurons a block of the decode kernel: one m16 tile
constexpr int kPull = 8;                 // distributed shared-memory loads a thread keeps in flight

__host__ __device__ constexpr int ring_bytes(int tile_rows) {
  return kStages * ((tile_rows + 7) & ~7) * kXRowBytes;
}
__host__ __device__ constexpr int panel_stride(int inputs) { return inputs * 2 + 16; }
__host__ __device__ constexpr int scatter_rows(int neurons, int splits) {
  return (neurons + splits - 1) / splits;
}
// bits of a pass-local input index in an outbox entry: ceil(log2(pass_rows))
__host__ __device__ constexpr int col_bits(int pass_rows) {
  int bits = 0;
  while ((1 << bits) < pass_rows) ++bits;
  return bits;
}
// The dynamic shared memory of one block: [x ring | panel of pass_rows
// inputs | outbox | bitmaps | flags | duplicate marks | counts | stash];
// the partial tile takes the ring's place after the product. The stash
// (passes > 1 only) keeps each thread's neurons / 2 accumulators while the
// next pass's panel is built.
__host__ __device__ constexpr long long mma_smem(int tile_rows, int neurons, int pass_rows,
                                                 int passes) {
  return static_cast<long long>(ring_bytes(tile_rows)) +
         static_cast<long long>(neurons) * panel_stride(pass_rows) + kOutboxCap * 4 +
         static_cast<long long>(neurons) * ((pass_rows + 31) / 32) * 4 + neurons * 8 +
         4 * kMaxSplits * 4 + kWarps * kMaxSplits * 4 + kWarps * 2 * 8 +
         (passes > 1 ? static_cast<long long>(kThreads) * (neurons / 2) * 4 : 0);
}
__host__ __device__ constexpr long long cmax(long long a, long long b) { return a > b ? a : b; }
// The decode kernel's dynamic shared memory: [panel over every split |
// scratch | flags]; the scratch holds the bitmaps while the slots are
// stored, then each warp's x buffer (a chunk of 8 batch rows, 16-byte
// piece p of row r at p ^ r), then the splits' partial tiles.
constexpr int kDecodeXBytes = 8 * kChunk * 2;  // a warp's x buffer: 8 rows of a chunk
__host__ __device__ constexpr long long decode_scratch(int split_rows, int splits) {
  return cmax(cmax(static_cast<long long>(kDecodeNeurons) * (splits * split_rows / 32) * 4,
                   static_cast<long long>(kWarps) * kDecodeXBytes),
              static_cast<long long>(kMaxSplits) * 8 * kDecodeNeurons * 4);
}
__host__ __device__ constexpr long long decode_smem(int split_rows, int splits) {
  return static_cast<long long>(kDecodeNeurons) * panel_stride(splits * split_rows) +
         decode_scratch(split_rows, splits) + kDecodeNeurons * 4;
}
static_assert(kOutbox <= 0xffff, "a place in a bucket fits 16 bits");
// the partial tile, rows * (kM + 4) floats, fits the ring and the panel it
// takes the place of (the panel holds at least 144 bytes a neuron, kM <= 64)
static_assert(ring_bytes(8) + 64 * 144 >= 8 * (64 + 4) * 4 &&
                  ring_bytes(128) + 64 * 144 >= 128 * (64 + 4) * 4,
              "the partial tile fits the ring and the panel");

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint16_t bf16_bits(int8_t v) {  // exact: |q| <= 127
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(v)));
}
__device__ __forceinline__ uint16_t bf16_bits(__nv_fp8_e4m3 v) {  // exact: E4M3 widens
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(v)));
}

// the address of shared-memory location addr in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ int ld_cluster_s32(uint32_t addr) {
  return static_cast<int>(ld_cluster_u32(addr));
}
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v));
}
__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}


// grid: (splits, ceil(n_rows / kM), experts * ceil(B / tile_rows)), a cluster
// of the `splits` blocks of a neuron tile and batch tile; block: kThreads;
// dynamic shared memory mma_smem(...). Block (s, t, z) multiplies rows [s *
// split_rows, +split_rows) of d_in for neurons [kM t, +kM) of expert z /
// ceil(B / tile_rows) and its batch rows [(z % ceil(B / tile_rows)) *
// tile_rows, +tile_rows) (1 to 128: up to 16 n8 tiles). Its panel
// holds pass_rows inputs of the split (a multiple of 64): where that is
// less than the split, the block densifies and multiplies the split in
// passes of pass_rows inputs, the chain carried over from pass to pass
// (through the stash), so the chain is the one-pass chain. vec_x: x by
// 16-byte cp.async (d_in % 8 == 0, x 16-byte aligned), else element loads.
template <typename V, int kMT, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 2)
gather_mma(const __nv_bfloat16* __restrict__ x, const V* __restrict__ values,
           const int32_t* __restrict__ idx, const float* __restrict__ scales,
           const int32_t* __restrict__ out_index, __nv_bfloat16* __restrict__ y, int batch,
           int d_in, int n_rows, int k, int ld_y, int split_rows, int pass_rows, int tile_rows,
           bool vec_x, Group grp) {
  constexpr int kM = kMT * 16;
  constexpr int kMW = kMT >= 2 ? 2 : 1;               // m16 tiles a warp
  constexpr int kMG = kMT / kMW;                      // warps along the neurons
  static_assert(kMG <= kWarps && kWarps % kMG == 0, "warps tile the neurons");
  constexpr int kNG = kWarps / kMG;                   // warps along the batch
  constexpr int kNW = kN8 / kNG;                      // n8 tiles a warp
  static_assert(kNW * kNG == kN8, "warps tile the batch");
  constexpr int kAcc = kMW * kNW * 4;                 // a thread's accumulators
  static_assert(kAcc == kM / 2, "the stash holds kM / 2 floats a thread (mma_smem)");
  constexpr int kPStride = kM + 4;                    // floats a batch row of the partial tile
  // slot loads a thread keeps in flight: fewer in the 16-neuron tile, whose
  // pass loop keeps more registers live across the densify step (with
  // kBatch it spills on an H100)
  constexpr int kLoads = kMT == 1 ? kBatch16 : kBatch;
  constexpr int kRound = kThreads * kLoads;           // slots a block buckets a round
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int i0 = split * split_rows;
  const int chunks = (min(d_in - i0, split_rows) + kChunk - 1) / kChunk;
  const int pass_chunks = pass_rows / kChunk;
  // the same in every block; more than one only in the 16-neuron tile
  const int passes = kMT == 1 ? (split_rows + pass_rows - 1) / pass_rows : 1;
  const int n0 = blockIdx.y * kM;
  int tile_z = blockIdx.z;
  if constexpr (kGrouped) {
    const int z_tiles = (batch + tile_rows - 1) / tile_rows;
    const int expert = tile_z / z_tiles;
    CONDENSED_ROWS_TO_EXPERT(grp, expert);
    tile_z -= expert * z_tiles;
  }
  const int b0 = tile_z * tile_rows;
  const int nb = min(tile_rows, batch - b0);
  const int n8 = (nb + 7) >> 3;  // n8 tiles holding this block's batch rows
  const int stage_bytes = ((tile_rows + 7) & ~7) * kXRowBytes;
  const int ps = panel_stride(pass_rows);
  const int words = (pass_rows + 31) >> 5;  // a panel row's bitmap
  const int rb = scatter_rows(kM, splits);
  const int cbits = col_bits(pass_rows);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t panel = base + kStages * stage_bytes;
  unsigned char* const tail = smem + kStages * stage_bytes + kM * ps;
  uint32_t* const outbox = reinterpret_cast<uint32_t*>(tail);         // [kOutboxCap]
  uint32_t* const bitmap = outbox + kOutboxCap;                       // [kM][words]
  int* const flags = reinterpret_cast<int*>(bitmap + kM * words);     // [kM] every block's
  int* const row_dup = flags + kM;     // [kM] what this block found
  int* const counts = row_dup + kM;    // [kMaxSplits] entries for each split, this round
  int* const offsets = counts + kMaxSplits;  // [kMaxSplits] where each split's entries start
  int* const pull_n = offsets + kMaxSplits;  // [kMaxSplits] entries of this split in each block
  int* const pull_at = pull_n + kMaxSplits;  // [kMaxSplits] and where they start
  int* const warp_at = pull_at + kMaxSplits;  // [kWarps][kMaxSplits] a warp's start in a bucket
  uint64_t* const warp_count =                // [kWarps][2] a warp's packed bucket counts
      reinterpret_cast<uint64_t*>(warp_at + kWarps * kMaxSplits);

  // x rows [b0, b0 + 8 n8) of chunk c, 144-byte rows; zeros past B and d_in
  auto x_tile = [&](int c) { return base + (c % kStages) * stage_bytes; };
  auto load_x = [&](int c) {
    const uint32_t xs = x_tile(c);
    const int ic = i0 + c * kChunk;
    for (int item = tid; item < n8 * 8 * 8; item += kThreads) {
      const int r = item >> 3, piece = item & 7;
      const int i = ic + piece * 8;
      const uint32_t dst = xs + r * kXRowBytes + piece * 16;
      const __nv_bfloat16* src = x + static_cast<size_t>(b0 + r) * d_in + i;
      if (vec_x) {
        const bool ok = r < nb && i < d_in;
        hopper::cp_async16(dst, ok ? src : x, ok);
      } else {
        uint16_t v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = r < nb && i + e < d_in ? __bfloat16_as_ushort(src[e]) : 0;
        st_shared_v4(dst, make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                                     v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16)));
      }
    }
  };
  // Started once a pass's first slots are on their way: x's first chunks
  // of the pass (x is independent of the panel), then the zeroed panel and
  // bitmaps, and in the first pass the flags.
  auto start = [&](int pass) {
    const int c_first = pass * pass_chunks;
    const int c_end = min(chunks, c_first + pass_chunks);
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (c_first + c < c_end) load_x(c_first + c);
      hopper::cp_async_commit();
    }
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int o = tid * 16; o < kM * ps; o += kThreads * 16) st_shared_v4(panel + o, zero);
    for (int o = tid; o < kM * words; o += kThreads) bitmap[o] = 0;
    if (pass == 0)
      for (int o = tid; o < 2 * kM; o += kThreads) flags[o] = 0;  // and row_dup
  };

  // 1. Densify, a pass at a time (one pass where the panel holds the split).
  // This block reads the slots of rows [r_first, r_end) of the tile, a
  // contiguous range of values and indices, kLoads a thread in flight,
  // and buckets those whose index falls in this pass of a split by that
  // split into its outbox: an entry is the value's bf16 bits over (local
  // row << cbits | input in the pass). Past a cluster barrier each block
  // reads its bucket from every block's outbox (coalesced distributed
  // shared-memory loads) and stores the values into its own panel. Every
  // block runs the same number of passes, and of rounds of kRound slots.
  const int r_first = split * rb;
  const int r_end = min(min(kM, r_first + rb), n_rows - n0);
  const int count = max(0, r_end - r_first) * k;
  const size_t g0 = static_cast<size_t>(n0 + r_first) * k;
  const float inv_k = k > 0 ? 1.f / static_cast<float>(k) : 0.f;
  const float inv_split = 1.f / static_cast<float>(split_rows);
  const int rounds = max(1, (rb * k + kRound - 1) / kRound);  // the same in every block
  const uint32_t col_mask = (1u << cbits) - 1;
  // 2. Multiply (each pass after its densify): warp w holds m16 tiles (w %
  // kMG) kMW + q, q < kMW, and n8 tiles (w / kMG) kNW + u, u < kNW; a
  // thread's accumulators wait in the stash while the next pass densifies
  float acc[kMW][kNW][4];
  float* const stash = reinterpret_cast<float*>(warp_count + kWarps * 2);  // [kAcc][kThreads]
  // chunk c of the split, the panel's chunk pc
  auto compute = [&](int c, int pc) {
    const int mg = warp % kMG;
    const int ng = warp / kMG;
    // ldmatrix row addresses: lanes 8q .. 8q + 7 give matrix q's rows
    const int q8 = lane >> 3;
    const int r8 = lane & 7;
    const uint32_t xs = x_tile(c);
    const uint32_t pa = panel + pc * kChunk * 2;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      // A (16 neurons x 16 inputs): matrix q = (rows + 8 (q % 2), inputs + 8
      // (q / 2)) gives a[q]
      uint32_t a[kMW][4];
#pragma unroll
      for (int q = 0; q < kMW; ++q) {
        const int row = (mg * kMW + q) * 16 + r8 + ((q8 & 1) << 3);
        hopper::ldmatrix_x4(a[q], pa + row * ps + ks * 32 + ((q8 >> 1) << 4));
      }
#pragma unroll
      for (int u = 0; u < kNW; u += 2) {
        const int t0 = ng * kNW + u;  // n8 tiles t0 and t0 + 1
        if (t0 < n8) {
          const bool pair = u + 1 < kNW && t0 + 1 < n8;
          // matrix q = (tile t0 + (q / 2) or t0 alone, inputs + 8 (q % 2))
          const int tile = (q8 >> 1) && pair ? t0 + 1 : t0;
          uint32_t b[4];
          hopper::ldmatrix_x4(b, xs + (tile * 8 + r8) * kXRowBytes + ks * 32 + ((q8 & 1) << 4));
#pragma unroll
          for (int q = 0; q < kMW; ++q) {
            hopper::mma_m16n8k16(acc[q][u], a[q], b[0], b[1]);
            if constexpr (kNW > 1) {
              if (pair) hopper::mma_m16n8k16(acc[q][u + 1], a[q], b[2], b[3]);
            }
          }
        }
      }
    }
  };

  for (int pass = 0; pass < passes; ++pass) {
    for (int round = 0; round < rounds; ++round) {
      const int first = round * kRound;
      int ii[kLoads];
      V vv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int g = first + u * kThreads + tid;
        ii[u] = g < count ? __ldg(idx + g0 + g) : -1;
        vv[u] = g < count ? values[g0 + g] : V();
      }
      if (round == 0) start(pass);
      // each entry and its bucket (-1: none); this thread's entries a bucket
      // in 16-bit fields, buckets 0-3 in mine[0] and 4-7 in mine[1]
      uint32_t entry[kLoads];
      int bucket[kLoads];
      uint64_t mine[2] = {0, 0};
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int g = first + u * kThreads + tid;
        const int i = ii[u];
        bucket[u] = -1;
        if (g >= count || static_cast<unsigned>(i) >= static_cast<unsigned>(d_in)) continue;
        int rl = static_cast<int>(static_cast<float>(g) * inv_k);  // g / k, exact after the fix
        const int jj = g - rl * k;
        rl += jj < 0 ? -1 : jj >= k ? 1 : 0;
        if (out_index != nullptr &&
            static_cast<unsigned>(__ldg(out_index + n0 + r_first + rl)) >=
                static_cast<unsigned>(ld_y))
          continue;  // a dropped row: never stored
        int sp = static_cast<int>(static_cast<float>(i) * inv_split);  // i / split_rows
        int c = i - sp * split_rows;
        if (c < 0) {
          --sp;
          c += split_rows;
        } else if (c >= split_rows) {
          ++sp;
          c -= split_rows;
        }
        c -= pass * pass_rows;  // the input in this pass
        if (static_cast<unsigned>(c) >= static_cast<unsigned>(pass_rows)) continue;  // another pass
        entry[u] = static_cast<uint32_t>(bf16_bits(vv[u])) << 16 |
                   static_cast<uint32_t>(rl) << cbits | static_cast<uint32_t>(c);
        bucket[u] = sp;
        const uint64_t one = 1ull << (16 * (sp & 3));
        mine[0] += sp < 4 ? one : 0;
        mine[1] += sp < 4 ? 0 : one;
      }
      // places in the outbox without atomics: a warp scan of the packed
      // counts, then the warps' totals, then the buckets in order
      uint64_t before[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t v = mine[h];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint64_t t = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += t;
        }
        before[h] = v - mine[h];
        if (lane == 31) warp_count[warp * 2 + h] = v;
      }
      __syncthreads();
      if (tid < kMaxSplits) {  // bucket tid: its start and each warp's start in it
        const int h = tid >> 2, sh = 16 * (tid & 3);
        int n = 0;
        for (int w = 0; w < kWarps; ++w) {
          warp_at[w * kMaxSplits + tid] = n;
          n += static_cast<int>((warp_count[w * 2 + h] >> sh) & 0xffff);
        }
        counts[tid] = n;
      }
      __syncthreads();
      if (tid == 0) {
        int at = 0;
        for (int d = 0; d < kMaxSplits; ++d) {
          offsets[d] = at;
          at += (counts[d] + 3) & ~3;  // the next bucket on a 16-byte boundary
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int sp = bucket[u];
        if (sp < 0) continue;
        const int h = sp >> 2, sh = 16 * (sp & 3);
        const int place = offsets[sp] + warp_at[warp * kMaxSplits + sp] +
                          static_cast<int>((before[h] >> sh) & 0xffff);
        before[h] += 1ull << sh;
        outbox[place] = entry[u];
      }
      cluster.sync();  // every outbox is full (and, in round 0, every panel zeroed)

      if (tid < splits) {
        pull_n[tid] = ld_cluster_s32(map_rank(hopper::smem_addr(counts + split), tid));
        pull_at[tid] = ld_cluster_s32(map_rank(hopper::smem_addr(offsets + split), tid));
      }
      __syncthreads();
      // the buckets for this split, four entries (16 bytes) a load, kPull
      // loads a thread in flight; quad_first: each source's first in the
      // flat order of the quads
      int quad_first[kMaxSplits];
      int total = 0;
#pragma unroll
      for (int src = 0; src < kMaxSplits; ++src) {
        quad_first[src] = total;
        total += src < splits ? (pull_n[src] + 3) >> 2 : 0;
      }
      for (int f0 = 0; f0 < total; f0 += kThreads * kPull) {
        uint4 en[kPull];
        int src_of[kPull], left[kPull];
#pragma unroll
        for (int u = 0; u < kPull; ++u) {
          const int f = f0 + u * kThreads + tid;
          src_of[u] = -1;
          if (f >= total) continue;
          int src = 0, start = 0;
#pragma unroll
          for (int q = 1; q < kMaxSplits; ++q) {
            if (q < splits && f >= quad_first[q]) {
              src = q;
              start = quad_first[q];
            }
          }
          const int quad = f - start;
          src_of[u] = src;
          left[u] = pull_n[src] - 4 * quad;
          en[u] = ld_cluster_v4(
              map_rank(hopper::smem_addr(outbox + pull_at[src] + 4 * quad), src));
        }
#pragma unroll
        for (int u = 0; u < kPull; ++u) {
          if (src_of[u] < 0) continue;
          const uint32_t four[4] = {en[u].x, en[u].y, en[u].z, en[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= left[u]) break;
            const uint32_t e = four[j];
            const int c = static_cast<int>(e & col_mask);
            const int m = src_of[u] * rb + static_cast<int>((e & 0xffffu) >> cbits);
            const uint32_t bit = 1u << (c & 31);
            // a second slot of row m at this input
            if (atomicOr(bitmap + m * words + (c >> 5), bit) & bit) row_dup[m] = 1;
            st_shared_u16(panel + m * ps + c * 2, static_cast<uint16_t>(e >> 16));
          }
        }
      }
      // the outboxes are read: free for the next round or pass
      if (round + 1 < rounds || pass + 1 < passes) cluster.sync();
    }
    __syncthreads();  // this block's panel is complete

    const int c_first = pass * pass_chunks;
    const int c_end = min(chunks, c_first + pass_chunks);
    const bool busy = warp / kMG * kNW < n8;  // uniform across the warp
    // the chain goes on from the last pass's accumulators
#pragma unroll
    for (int q = 0; q < kMW; ++q)
#pragma unroll
      for (int u = 0; u < kNW; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[q][u][e] = pass == 0 ? 0.f : stash[((q * kNW + u) * 4 + e) * kThreads + tid];
    for (int c = c_first; c < c_end; ++c) {
      hopper::cp_async_wait<kAhead - 1>();
      // chunk c is in place for every thread; past the barrier every warp is
      // also done with chunk c - 1, whose stage the next load reuses
      __syncthreads();
      const int next = c + kAhead;
      if (next < c_end) load_x(next);
      hopper::cp_async_commit();
      if (busy) compute(c, c - c_first);
    }
    hopper::cp_async_wait<0>();
    // the ring and the panel are free: for the next pass, or for the partial tile
    __syncthreads();
    if (pass + 1 < passes) {
#pragma unroll
      for (int q = 0; q < kMW; ++q)
#pragma unroll
        for (int u = 0; u < kNW; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            stash[((q * kNW + u) * 4 + e) * kThreads + tid] = acc[q][u][e];
    }
  }
  for (int e = tid; e < kM * splits; e += kThreads)  // every block learns each row found
    if (row_dup[e / splits])
      st_cluster_u32(map_rank(hopper::smem_addr(flags + e / splits), e % splits), 1u);

  // 3. This split's partial tile, [batch row][neuron] (kPStride floats a
  // row): accumulator e of (q, u) is neuron 16 (mg kMW + q) + lane / 4 (+ 8
  // for e >= 2), batch row 8 (ng kNW + u) + 2 (lane % 4) (+ 1 for odd e)
  const int mg = warp % kMG;
  const int ng = warp / kMG;
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < kMW; ++q) {
    const int mm = (mg * kMW + q) * 16 + (lane >> 2);
#pragma unroll
    for (int u = 0; u < kNW; ++u) {
      const int t = ng * kNW + u;
      if (t < n8) {
        const int bb = t * 8 + 2 * (lane & 3);
        part[bb * kPStride + mm] = acc[q][u][0];
        part[(bb + 1) * kPStride + mm] = acc[q][u][1];
        part[bb * kPStride + mm + 8] = acc[q][u][2];
        part[(bb + 1) * kPStride + mm + 8] = acc[q][u][3];
      }
    }
  }
  cluster.sync();  // every split's partial tile is in place

  // block s of the cluster adds its share of the tile over the splits, in
  // order, four neurons at a time, scales, casts and stores; a flagged row
  // takes its slot chain instead
  for (int e = split * kThreads + tid; e < nb * (kM / 4); e += splits * kThreads) {
    const int b = e / (kM / 4);
    const int m4 = (e % (kM / 4)) * 4;
    const int off = b * kPStride + m4;
    float4 p[kMaxSplits];  // every split's partial in flight, then added in order
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits)
        p[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s) + off);
    float4 v = p[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {
      if (s < splits) {
        v.x += p[s].x;
        v.y += p[s].y;
        v.z += p[s].z;
        v.w += p[s].w;
      }
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + m4 + q;
      if (n >= n_rows) break;
      const int col = out_index == nullptr ? n : __ldg(out_index + n);
      if (static_cast<unsigned>(col) >= static_cast<unsigned>(ld_y)) continue;  // dropped row
      float r = vs[q];
      if (flags[m4 + q]) {  // duplicate indices: the row's slots in slot order
        const __nv_bfloat16* xrow = x + static_cast<size_t>(b0 + b) * d_in;
        const int32_t* irow = idx + static_cast<size_t>(n) * k;
        const V* vrow = values + static_cast<size_t>(n) * k;
        r = 0.f;
        for (int j = 0; j < k; ++j) {
          const int i = __ldg(irow + j);
          if (static_cast<unsigned>(i) < static_cast<unsigned>(d_in))
            r = fmaf(__bfloat162float(xrow[i]), to_f32(vrow[j]), r);
        }
      }
      if (scales != nullptr) r *= __ldg(scales + n);  // dequantize after the sum
      y[static_cast<size_t>(b0 + b) * ld_y + col] = __float2bfloat16_rn(r);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

template <typename V, int kLoads, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 1)
gather_mma_decode(const __nv_bfloat16* __restrict__ x, const V* __restrict__ values,
                  const int32_t* __restrict__ idx, const float* __restrict__ scales,
                  const int32_t* __restrict__ out_index, __nv_bfloat16* __restrict__ y,
                  int batch, int d_in, int n_rows, int k, int ld_y, int split_rows,
                  int tile_rows, int rows, bool vec_x, Group grp) {
  constexpr int kM = kDecodeNeurons;  // the panel's rows; the block's neurons fill `rows`
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (kGrouped) CONDENSED_ROWS_TO_EXPERT(grp, blockIdx.z);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int splits = (d_in + split_rows - 1) / split_rows;
  const int width = splits * split_rows;  // a multiple of 64
  const int ps = panel_stride(width);
  const int words = width >> 5;
  const int n0 = blockIdx.x * rows;
  const int b0 = blockIdx.y * tile_rows;
  const int nb = min(tile_rows, batch - b0);
  const uint32_t panel = hopper::smem_addr(smem);
  unsigned char* const scratch = smem + kM * ps;
  uint32_t* const bitmap = reinterpret_cast<uint32_t*>(scratch);  // [kM][words], then
  const uint32_t xbuf = hopper::smem_addr(scratch) + warp * kDecodeXBytes;  // warp w's x, then
  float* const part = reinterpret_cast<float*>(scratch);          // [split][8][kM]
  int* const flags = reinterpret_cast<int*>(scratch + decode_scratch(split_rows, splits));

  const int count = max(0, min(rows, n_rows - n0)) * k;
  const size_t g0 = static_cast<size_t>(n0) * k;
  const float inv_k = k > 0 ? 1.f / static_cast<float>(k) : 0.f;
  for (int first = 0; first < count || first == 0; first += kThreads * kLoads) {
    int ii[kLoads];
    V vv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int g = first + u * kThreads + tid;
      ii[u] = g < count ? __ldg(idx + g0 + g) : -1;
      vv[u] = g < count ? values[g0 + g] : V();
    }
    if (first == 0) {  // zero the panel while the first slots are on their way
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int o = tid * 16; o < kM * ps; o += kThreads * 16) st_shared_v4(panel + o, zero);
      for (int o = tid; o < kM * words; o += kThreads) bitmap[o] = 0;
      if (tid < kM) flags[tid] = 0;
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int g = first + u * kThreads + tid;
      const int i = ii[u];
      if (g >= count || static_cast<unsigned>(i) >= static_cast<unsigned>(d_in)) continue;
      int m = static_cast<int>(static_cast<float>(g) * inv_k);  // g / k, exact after the fix
      const int jj = g - m * k;
      m += jj < 0 ? -1 : jj >= k ? 1 : 0;
      if (out_index != nullptr &&
          static_cast<unsigned>(__ldg(out_index + n0 + m)) >= static_cast<unsigned>(ld_y))
        continue;  // a dropped row: never stored
      const uint32_t bit = 1u << (i & 31);
      if (atomicOr(bitmap + m * words + (i >> 5), bit) & bit) flags[m] = 1;
      st_shared_u16(panel + m * ps + i * 2, bf16_bits(vv[u]));
    }
  }
  __syncthreads();

  // warp w < splits: split w's chain over its chunks, 4 k16 steps each, the
  // order of gather_mma's split block
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp < splits) {
    const int i0 = warp * split_rows;
    const int chunks = (min(d_in - i0, split_rows) + kChunk - 1) / kChunk;
    const int q8 = lane >> 3, r8 = lane & 7;
    // chunk h of the split's x (rows b0 .. b0 + 7, inputs i0 + 64 h ..) into
    // the warp's buffer; zeros past B and d_in
    auto load_x = [&](int h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int item = e * 32 + lane;
        const int r = item >> 3, piece = item & 7;
        const int i = i0 + h * kChunk + piece * 8;
        const uint32_t dst = xbuf + r * (kChunk * 2) + ((piece ^ r) << 4);
        const __nv_bfloat16* src = x + static_cast<size_t>(b0 + r) * d_in + i;
        if (vec_x) {
          const bool ok = r < nb && i < d_in;
          hopper::cp_async16(dst, ok ? src : x, ok);
        } else {
          uint16_t v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = r < nb && i + q < d_in ? __bfloat16_as_ushort(src[q]) : 0;
          st_shared_v4(dst, make_uint4(v[0] | (uint32_t(v[1]) << 16),
                                       v[2] | (uint32_t(v[3]) << 16),
                                       v[4] | (uint32_t(v[5]) << 16),
                                       v[6] | (uint32_t(v[7]) << 16)));
        }
      }
      hopper::cp_async_commit();
    };
    const uint32_t arow = panel + (r8 + ((q8 & 1) << 3)) * ps + ((q8 >> 1) << 4);
    load_x(0);
    for (int h = 0; h < chunks; ++h) {
      hopper::cp_async_wait<0>();
      __syncwarp();  // chunk h is in place for every lane
      // the chunk's B fragments: matrix q = (k16 step 2 p + q / 2, inputs +
      // 8 (q % 2)) of ldmatrix p gives b[p][q]
      uint32_t b[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int piece = (2 * p + (q8 >> 1)) * 2 + (q8 & 1);
        hopper::ldmatrix_x4(b[p], xbuf + r8 * (kChunk * 2) + ((piece ^ r8) << 4));
      }
      __syncwarp();  // every lane holds chunk h: the buffer takes chunk h + 1
      if (h + 1 < chunks) load_x(h + 1);
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t a[4];
        hopper::ldmatrix_x4(a, arow + (i0 + h * kChunk + ks * 16) * 2);
        hopper::mma_m16n8k16(acc, a, b[ks >> 1][(ks & 1) * 2], b[ks >> 1][(ks & 1) * 2 + 1]);
      }
    }
    hopper::cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with its x buffer: the partial tiles take the scratch
  if (warp < splits) {
    const int g = lane >> 2, t = lane & 3;
    // accumulator e: neuron lane / 4 (+ 8 for e >= 2), batch row 2 (lane % 4)
    // (+ 1 for odd e)
    float* p = part + warp * 8 * kM;
    p[(2 * t) * kM + g] = acc[0];
    p[(2 * t + 1) * kM + g] = acc[1];
    p[(2 * t) * kM + g + 8] = acc[2];
    p[(2 * t + 1) * kM + g + 8] = acc[3];
  }
  __syncthreads();

  if (tid < nb * kM) {  // a thread an output: the splits in order, scale, cast, store
    const int b = tid / kM, m = tid % kM, n = n0 + m;
    const int col = m >= rows || n >= n_rows ? -1 : out_index == nullptr ? n : __ldg(out_index + n);
    if (static_cast<unsigned>(col) < static_cast<unsigned>(ld_y)) {
      float r = part[b * kM + m];
      for (int s = 1; s < splits; ++s) r += part[(s * 8 + b) * kM + m];
      if (flags[m]) {  // duplicate indices: the row's slots in slot order
        const __nv_bfloat16* xrow = x + static_cast<size_t>(b0 + b) * d_in;
        const int32_t* irow = idx + static_cast<size_t>(n) * k;
        const V* vrow = values + static_cast<size_t>(n) * k;
        r = 0.f;
        for (int j = 0; j < k; ++j) {
          const int i = __ldg(irow + j);
          if (static_cast<unsigned>(i) < static_cast<unsigned>(d_in))
            r = fmaf(__bfloat162float(xrow[i]), to_f32(vrow[j]), r);
        }
      }
      if (scales != nullptr) r *= __ldg(scales + n);  // dequantize after the sum
      y[static_cast<size_t>(b0 + b) * ld_y + col] = __float2bfloat16_rn(r);
    }
  }
}

template <typename V, int kLoads, bool kGrouped>
cudaError_t launch_decode(const void* x, const void* values, const void* idx,
                          const float* scales, const void* out_index, void* y, int batch,
                          int d_in, int n_rows, int k, int ld_y, int split_rows, int tile_rows,
                          int rows, size_t smem, const Group& grp, cudaStream_t stream) {
  auto kernel = gather_mma_decode<V, kLoads, kGrouped>;
  static const cudaError_t opted =  // above the 48 KB default, once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n_rows + rows - 1) / rows, (batch + tile_rows - 1) / tile_rows, grp.experts);
  const bool vec_x = d_in % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const V*>(values),
      static_cast<const int32_t*>(idx), scales, static_cast<const int32_t*>(out_index),
      static_cast<__nv_bfloat16*>(y), batch, d_in, n_rows, k, ld_y, split_rows, tile_rows, rows,
      vec_x, grp);
  return cudaGetLastError();
}

template <typename V, int kMT, bool kGrouped>
cudaError_t launch_mma(const void* x, const void* values, const void* idx, const float* scales,
                       const void* out_index, void* y, int batch, int d_in, int n_rows, int k,
                       int ld_y, int split_rows, int pass_rows, int splits, int tile_rows,
                       size_t smem, const Group& grp, cudaStream_t stream) {
  auto kernel = gather_mma<V, kMT, kGrouped>;
  static const cudaError_t opted =  // above the 48 KB default, once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (opted != cudaSuccess) return opted;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (n_rows + kMT * 16 - 1) / (kMT * 16),
                        grp.experts * ((batch + tile_rows - 1) / tile_rows));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const bool vec_x = d_in % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const V*>(values), static_cast<const int32_t*>(idx),
                            scales, static_cast<const int32_t*>(out_index),
                            static_cast<__nv_bfloat16*>(y), batch, d_in, n_rows, k, ld_y,
                            split_rows, pass_rows, tile_rows, vec_x, grp);
}

// The launch condensed_matmul.launch_args chose; this side only checks that
// it fits (shared memory, the outbox's bits) and launches it.
template <typename V, bool kGrouped>
cudaError_t dispatch_bf16(int block_rows, int split_rows, int pass_rows, int neurons,
                          int decode_loads, const void* x, const void* values, const void* idx,
                          const float* scales, const void* out_index, void* y, int batch,
                          int d_in, int n_rows, int k, int ld_y, const Group& grp,
                          cudaStream_t s) {
  if (block_rows <= 0 || block_rows > kMaxTileRows || (block_rows & (block_rows - 1)) != 0 ||
      split_rows <= 0 || split_rows % kChunk != 0)
    return cudaErrorInvalidValue;
  // the expert axis shares grid z with gather_mma's batch tiles
  if (static_cast<long long>(grp.experts) * ((batch + block_rows - 1) / block_rows) > 65535)
    return cudaErrorInvalidValue;
  const int splits = (d_in + split_rows - 1) / split_rows;
  if (splits > kMaxSplits) return cudaErrorInvalidValue;
  if (decode_loads != 0) {  // the decode kernel: every split of `neurons` rows in one block
    const long long smem = decode_smem(split_rows, splits);
    if (block_rows > 8 || (neurons != 8 && neurons != kDecodeNeurons) || smem > kSmemMax)
      return cudaErrorInvalidValue;
    if (decode_loads == kBatch)
      return launch_decode<V, kBatch, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows,
                                      k, ld_y, split_rows, block_rows, neurons,
                                      static_cast<size_t>(smem), grp, s);
    if (decode_loads == 2 * kBatch)
      return launch_decode<V, 2 * kBatch, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in,
                                          n_rows, k, ld_y, split_rows, block_rows, neurons,
                                          static_cast<size_t>(smem), grp, s);
    return cudaErrorInvalidValue;
  }
  if (pass_rows <= 0 || pass_rows % kChunk != 0 || pass_rows > split_rows)
    return cudaErrorInvalidValue;
  const int passes = (split_rows + pass_rows - 1) / pass_rows;
  if (passes > 1 && neurons != 16) return cudaErrorInvalidValue;
  const long long smem = mma_smem(block_rows, neurons, pass_rows, passes);
  // an outbox entry holds a block's local row in the bits the input leaves
  if (smem > kSmemMax || scatter_rows(neurons, splits) > (1 << (16 - col_bits(pass_rows))))
    return cudaErrorInvalidValue;
  switch (neurons) {
    case 16: return launch_mma<V, 1, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows, k,
                                     ld_y, split_rows, pass_rows, splits, block_rows,
                                     static_cast<size_t>(smem), grp, s);
    case 32: return launch_mma<V, 2, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows, k,
                                     ld_y, split_rows, pass_rows, splits, block_rows,
                                     static_cast<size_t>(smem), grp, s);
    case 64: return launch_mma<V, 4, kGrouped>(x, values, idx, scales, out_index, y, batch, d_in, n_rows, k,
                                     ld_y, split_rows, pass_rows, splits, block_rows,
                                     static_cast<size_t>(smem), grp, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (x and y). vtype: 0 = values of x's
// dtype (scales null), 1 = int8 codes, 2 = float8_e4m3 codes (scales: one
// float32 per row, required). block_rows: the batch rows of a block
// (float32: 1, 2, 4 or 8; bfloat16: a power of two up to 128).
// rows_per_warp: float32's neurons a warp. bfloat16 (the launch
// condensed_matmul.launch_args chose): split_rows, the d_in split (a
// multiple of 64, at most 8 splits); decode_loads 0 for the cluster kernel
// (neurons 16, 32 or 64 a block, a panel of pass_rows inputs), else the
// decode kernel with that many slot loads a thread in flight (20 or 40;
// neurons 8 or 16 a block). kGrouped, grp: the experts of a grouped launch
// (a plain launch: false, kOne).
template <bool kGrouped = false>
cudaError_t dispatch(int dtype, int vtype, int block_rows, int rows_per_warp, int split_rows,
                     int pass_rows, int neurons, int decode_loads, const void* x,
                     const void* values, const void* idx, const float* scales,
                     const void* out_index, void* y, int batch, int d_in, int n_rows, int k,
                     int ld_y, cudaStream_t stream, const Group& grp = kOne) {
  if ((vtype == 0) != (scales == nullptr) || batch <= 0 || n_rows <= 0 || d_in <= 0 || k < 0 ||
      grp.experts <= 0 || grp.experts > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vtype) {
      case 0: return dispatch_f32<float, kGrouped>(block_rows, x, values, idx, scales,
                                                   out_index, y, batch, d_in, n_rows, k, ld_y,
                                                   rows_per_warp, grp, stream);
      case 1: return dispatch_f32<int8_t, kGrouped>(block_rows, x, values, idx, scales,
                                                    out_index, y, batch, d_in, n_rows, k, ld_y,
                                                    rows_per_warp, grp, stream);
      case 2: return dispatch_f32<__nv_fp8_e4m3, kGrouped>(block_rows, x, values, idx, scales,
                                                           out_index, y, batch, d_in, n_rows, k,
                                                           ld_y, rows_per_warp, grp, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (vtype) {
      case 0: return dispatch_bf16<__nv_bfloat16, kGrouped>(
          block_rows, split_rows, pass_rows, neurons, decode_loads, x, values, idx, scales,
          out_index, y, batch, d_in, n_rows, k, ld_y, grp, stream);
      case 1: return dispatch_bf16<int8_t, kGrouped>(
          block_rows, split_rows, pass_rows, neurons, decode_loads, x, values, idx, scales,
          out_index, y, batch, d_in, n_rows, k, ld_y, grp, stream);
      case 2: return dispatch_bf16<__nv_fp8_e4m3, kGrouped>(
          block_rows, split_rows, pass_rows, neurons, decode_loads, x, values, idx, scales,
          out_index, y, batch, d_in, n_rows, k, ld_y, grp, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace condensed_rows
