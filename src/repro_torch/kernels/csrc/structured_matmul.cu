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
// whose out_index is the sentinel d_out are padding: their slots are never
// stored and they are dropped. Bound: bytes (values + indices + out_index +
// x + out over HBM). It is K1's body (condensed_rows.cuh) with the store
// addressed through out_index: in bfloat16 one chain a row, fixed by d_in,
// of mma.sync products over a dense bf16 panel of the slots, one chain per
// d_in split, the splits added in order -- a cluster of the splits' blocks
// at the tiled launch, one block for every split at decode (the cluster
// past d_in 6656); in float32 a
// warp per row gathering on the CUDA cores. So its output at column
// out_index[r] is bitwise K1's output for row r, and the decode launch is
// bitwise the tiled launch at any batch tile. Duplicates, non-finite x and
// the geometry are as that note gives them.
//
// K2-coa (replaces _coa_kernel with scaled=True): K4 over int8 or
// float8_e4m3 codes with one float32 scale per surviving row, multiplied
// after the k-sum, before the cast and the store (codes widen to bf16
// exactly for the tensor cores): its output at column out_index[r] is
// bitwise K2's output for row r.
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
// so one call is one memset and one kernel launch (the float32 K5/K6 keep
// their tickets right after the output, in the same memset). The TPU
// kernels' one-hot MXU scatter has no counterpart: each result is stored
// straight to its column (the exports guarantee unique columns).
//
// K5/K6 bound: bytes in bfloat16 at every batch the serving path gives
// (the panel, or the gathered columns of W, d_in * a_pad elements for 2 * B
// * d_in * a_pad operations: at B = 128 that is 128 operations a byte,
// below the card's 295), bytes at decode and CUDA-core operations at
// prefill in float32. Every output's float32 value is the same at every
// batch tile and in every launch (decode or tiled, K5 or K6): the d_in
// splits and the order of the products within a split depend only on d_in
// and the dtype, and the splits are added in order. So the decode launch
// is bitwise the tiled launch at any tile, and K6 is bitwise K5's decode
// launch on the panel that K5's wrapper gathers.
//
// bfloat16 -- structured_mma, on the tensor cores, swap-AB: out^T[j, b] =
// sum_i panel[i, j] x[b, i], the panel's columns as the M side (A, read
// MN-major with ldmatrix.trans) and the batch as the narrow N side (B = x,
// K-major, ldmatrix). The instruction is mma.sync.m16n8k16 (bf16 in, f32
// sums) in every launch: one fixed shape gives each output the same chain
// of products whether its batch row shares an n8 tile with 3 or with 7
// others, and a 16 x 8 tile wastes little at decode (B <= 8), where wgmma's
// 64-row M would need a warpgroup per 64 columns and gains nothing against
// the bytes. A block owns 64 columns (four m16 tiles), one split of d_in,
// and up to 128 batch rows (16 n8 tiles): warp w takes m16 tile w % 4 and
// every second n8 tile, each an f32 accumulator chain over the split's
// rows in order, so the panel is read once per call at B <= 128 (at B =
// 256 the product reaches the card's operations-to-bytes balance, so a
// second read costs little). The split has split_rows rows, a multiple of
// 64, with at most 8 splits (split_rows = 64 * ceil(d_in / 512)): a cluster
// of the splits' blocks adds their partial tiles in split order through
// distributed shared memory, each block a share of the tile, with no
// global workspace and no ticket. A ring of four stages of 64 rows brings
// the panel tile (128-byte rows, 16-byte chunk c of row r at c ^ (r % 8),
// so ldmatrix.trans is free of bank conflicts) and the batch rows of x
// (144-byte rows) through cp.async, three chunks ahead. The decode launch
// (B <= 8) instantiates one n8 tile a block, so four blocks share an SM.
// K6 fills the same tile from W through active_index, then runs K5's
// instructions. A tile whose 64 active columns lie in order in W from a
// multiple of 8 (an export's, where none of them is ablated) is copied as
// K5's panel is; any other tile (neurons ablated at random) takes the
// element path: a column a lane, so a warp reads 32 neighbouring active
// columns of one row with 2-byte loads, issued three chunks ahead into
// registers and stored to the tile after the chunk before is computed
// (deeper register pipelines cost blocks an SM and ran slower). A panel
// K5 cannot copy 16 bytes at a time (a_pad % 8 != 0, or unaligned) takes
// the element path too. Ragged B, d_in and a_pad are zero-filled in shared
// memory; the wrapper pads nothing.
//
// float32 -- CUDA cores, full float32 (TF32 would change the result beyond
// the float32 tolerance). Each output sums its split's 256 rows in eight
// chains (rows r, r + 8, ... in order), the chains in order, then the
// splits in order, through a float32 workspace of split partials (splits
// x B x a_pad floats). Decode (and K6): structured_kernel, 32 columns a
// block, a lane each, each warp one chain with all its 32 rows loaded
// before the first FMA; a ticket taken after __threadfence elects the last
// block of a tile, which adds the splits. Tiled: structured_f32_tiled, 64
// columns by 32 batch rows a block, two blocks an SM, x and the panel tile
// brought into shared memory by cp.async, each lane 8 columns by 8 batch
// rows, the warps the chains; the batch tiles of a panel tile run side by
// side, so HBM sees the panel about once and L2 serves the rest. Both
// share f32_split_epilogue: no block waits for another.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cooperative_groups.h>

#include "condensed_rows.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using condensed_rows::Column;

// ----------------------------------------------------------------- float32

constexpr int kSplitRows = 256;  // rows of d_in per block; fixes the reduction order
constexpr int kCols = 32;        // compact columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kSplitRows / kWarps;
// structured_f32_tiled: a block of 64 columns by 32 batch rows, two blocks an SM
constexpr int kF32TileRows = 32;
constexpr int kF32TileCols = 64;
constexpr int kF32XStride = kSplitRows + 4;  // floats a batch row of x takes (4 banks apart)
constexpr int kF32XFloats = kF32TileRows * kF32XStride;  // x
constexpr int kF32WFloats = kSplitRows * kF32TileCols;  // the panel tile
constexpr int kF32TileSmem = (kF32XFloats + kF32WFloats) * 4;
static_assert(kWarps * kF32TileRows * kF32TileCols <= kF32XFloats + kF32WFloats,
              "the chains' sums fit x's and the panel's space");

// The output and then, 16-byte aligned, the tickets: one region, cleared by
// one memset.
size_t tickets_offset(int batch, int d_out, size_t elem) {
  return (static_cast<size_t>(batch) * d_out * elem + 15) / 16 * 16;
}

// The split's partial sums of a (tile_rows x kTileCols) tile, each element
// the sum of kWarps chains in order (red: [kWarps][tile_rows][kTileCols]),
// to ws; the last block of the tile to finish (a ticket taken with
// atomicAdd after __threadfence) adds the splits in order and stores. No
// block waits for another, and the sums are the same whichever block is
// last. kBatched: the last block keeps eight loads of the splits in flight
// (faster for the tiled kernel's 64-column tiles, slower for the decode
// kernel's, on an H100).
template <int kTileCols, bool kBatched>
__device__ __forceinline__ void f32_split_epilogue(const float* red, int tile_rows, float* ws,
                                                   int* ticket, int split, int splits,
                                                   const int32_t* active_index, float* out,
                                                   int batch, int b0, int nb, int j0, int a_pad,
                                                   int d_out) {
  __shared__ bool last;
  float* part = ws + (static_cast<size_t>(split) * batch + b0) * a_pad;
  for (int e = threadIdx.x; e < tile_rows * kTileCols; e += kThreads) {
    const int b = e / kTileCols, c = e % kTileCols;
    if (b >= nb || j0 + c >= a_pad) continue;
    float v = red[e];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) v += red[wi * tile_rows * kTileCols + e];
    part[static_cast<size_t>(b) * a_pad + j0 + c] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const size_t split_stride = static_cast<size_t>(batch) * a_pad;
  for (int e = threadIdx.x; e < tile_rows * kTileCols; e += kThreads) {
    const int b = e / kTileCols, c = e % kTileCols;
    if (b >= nb || j0 + c >= a_pad) continue;
    const int dst = __ldg(active_index + j0 + c);
    if (static_cast<unsigned>(dst) >= static_cast<unsigned>(d_out)) continue;  // sentinel
    const float* p = ws + static_cast<size_t>(b0 + b) * a_pad + j0 + c;
    float v = __ldcg(p);
    if (kBatched) {  // eight loads in flight, added in order
      for (int s0 = 1; s0 < splits; s0 += 8) {
        float q[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          q[u] = s0 + u < splits ? __ldcg(p + (s0 + u) * split_stride) : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (s0 + u < splits) v += q[u];
      }
    } else {
      for (int s = 1; s < splits; ++s) v += __ldcg(p + s * split_stride);
    }
    out[static_cast<size_t>(b0 + b) * d_out + dst] = v;
  }
}

// Decode (and K6). grid: (ceil(a_pad / kCols), ceil(d_in / kSplitRows),
// ceil(B / BT)); block: kThreads. A lane per column, warp w the chain of
// rows w, w + 8, ... of the split, all 32 loaded before the first FMA so
// that many loads are in flight. ws: (splits, B, a_pad) float32 partial
// sums; tickets: one zeroed int per (column tile, batch tile).
template <int BT, bool kGather>
__global__ void __launch_bounds__(kThreads)
structured_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int32_t* __restrict__ active_index, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int batch, int d_in,
                  int a_pad, int d_out, int ld_w) {
  __shared__ __align__(16) unsigned char xs_raw[kSplitRows * sizeof(Column<float, BT>)];
  __shared__ float red[kWarps * BT * kCols];
  Column<float, BT>* xs = reinterpret_cast<Column<float, BT>*>(xs_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kCols;
  const int i0 = blockIdx.y * kSplitRows;
  const int ni = min(kSplitRows, d_in - i0);
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, batch - b0);

  for (int r = threadIdx.x; r < ni; r += kThreads) {
    Column<float, BT> c;
#pragma unroll
    for (int b = 0; b < BT; ++b)
      c.v[b] = b < nb ? x[static_cast<size_t>(b0 + b) * d_in + i0 + r] : 0.f;
    xs[r] = c;
  }
  __syncthreads();

  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
  const int j = j0 + lane;
  if (j < a_pad) {
    const int col = kGather ? min(__ldg(active_index + j), d_out - 1) : j;
    const float* wcol = w + static_cast<size_t>(i0) * ld_w + col;
    float wv[kRowsPerWarp];
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int r = warp + m * kWarps;
      wv[m] = r < ni ? wcol[static_cast<size_t>(r) * ld_w] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int r = warp + m * kWarps;
      if (r < ni) {
        const Column<float, BT> c = xs[r];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(c.v[b], wv[m], acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) red[(warp * BT + b) * kCols + lane] = acc[b];
  __syncthreads();
  f32_split_epilogue<kCols, false>(red, BT, ws, tickets + blockIdx.z * gridDim.x + blockIdx.x,
                            blockIdx.y, gridDim.y, active_index, out, batch, b0, nb, j0, a_pad,
                            d_out);
}

// Tiled K5 in float32. grid: (ceil(a_pad / 64) * ceil(B / 32), ceil(d_in /
// kSplitRows)): x the column tile, then the batch tile, so the batch tiles
// of a panel tile run side by side and read it from L2 after the first;
// block: kThreads; dynamic shared memory kF32TileSmem (two blocks an SM).
// The split's panel tile and the tile's 32 rows of x sit in shared memory
// as they lie in memory, brought by cp.async in two commit groups, one per
// half of the split's rows, so the second half arrives while the first is
// computed. Warp w adds the rows r = w, w + 8, ... in order, as
// structured_kernel's warp w does; its lane l holds columns 4 (l % 8) .. +
// 3 and + 32 .. + 35 and batch rows l / 8 + 4 q, q = 0 .. 7 (rows of x 260
// floats apart fall on distinct banks). kVec: 16-byte panel copies (ld_w %
// 4 == 0 and the panel 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
structured_f32_tiled(const float* __restrict__ x, const float* __restrict__ w,
                     const int32_t* __restrict__ active_index, float* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ tickets, int batch, int d_in,
                     int a_pad, int d_out, int ld_w) {
  constexpr int kHalf = kSplitRows / 2;
  extern __shared__ __align__(16) float f32_smem[];
  float* xs = f32_smem;                // [kF32TileRows][kF32XStride]
  float* wt = f32_smem + kF32XFloats;  // [kSplitRows][kF32TileCols]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int batch_tiles = (batch + kF32TileRows - 1) / kF32TileRows;
  const int j0 = blockIdx.x / batch_tiles * kF32TileCols;
  const int i0 = blockIdx.y * kSplitRows;
  const int ni = min(kSplitRows, d_in - i0);
  const int b0 = blockIdx.x % batch_tiles * kF32TileRows;
  const int nb = min(kF32TileRows, batch - b0);

  // half h of the split's rows: the panel tile's rows and x's columns,
  // zeros past d_in, a_pad and B; 16-byte copies where the rows allow (x:
  // d_in % 4 == 0, 16-byte aligned), else element loads
  const bool vx = d_in % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (int item = threadIdx.x; item < kHalf * (kF32TileCols / 4); item += kThreads) {
      const int r = h * kHalf + item / (kF32TileCols / 4);
      const int j = j0 + 4 * (item % (kF32TileCols / 4));
      float* dst = wt + r * kF32TileCols + (j - j0);
      const float* src = w + static_cast<size_t>(i0 + r) * ld_w + j;
      if (kVec) {
        const bool ok = r < ni && j < a_pad;
        hopper::cp_async16(hopper::smem_addr(dst), ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = r < ni && j + e < a_pad ? __ldg(src + e) : 0.f;
      }
    }
    for (int item = threadIdx.x; item < kF32TileRows * (kHalf / 4); item += kThreads) {
      const int b = item / (kHalf / 4);
      const int r = h * kHalf + 4 * (item % (kHalf / 4));
      float* dst = xs + b * kF32XStride + r;
      const float* src = x + static_cast<size_t>(b0 + b) * d_in + i0 + r;
      if (vx) {
        const bool ok = b < nb && r < ni;
        hopper::cp_async16(hopper::smem_addr(dst), ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = b < nb && r + e < ni ? __ldg(src + e) : 0.f;
      }
    }
    hopper::cp_async_commit();
  }

  const int col = 4 * (lane & 7);
  const int rg = lane >> 3;
  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
  // rows [r_begin, r_end) of this warp's chain, in order: two 16-byte reads
  // of the panel tile and eight 4-byte reads of x for 64 FMAs
  auto compute = [&](int r_begin, int r_end) {
#pragma unroll 2
    for (int r = r_begin; r < r_end; r += kWarps) {
      const float4 wa = *reinterpret_cast<const float4*>(wt + r * kF32TileCols + col);
      const float4 wb = *reinterpret_cast<const float4*>(wt + r * kF32TileCols + col + 32);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      float xq[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) xq[q] = xs[(rg + 4 * q) * kF32XStride + r];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(xq[q], wv[e], acc[q][e]);
    }
  };

  hopper::cp_async_wait<1>();
  __syncthreads();
  compute(warp, min(kHalf, ni));
  hopper::cp_async_wait<0>();
  __syncthreads();
  compute(kHalf + warp, ni);
  __syncthreads();  // x and the panel tile are done with: the chains' sums take their place

  float* red = f32_smem;  // [kWarps][kF32TileRows][kF32TileCols]
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float* row = red + (warp * kF32TileRows + rg + 4 * q) * kF32TileCols + col;
    *reinterpret_cast<float4*>(row) = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    *reinterpret_cast<float4*>(row + 32) = make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
  }
  __syncthreads();

  f32_split_epilogue<kF32TileCols, true>(red, kF32TileRows, ws, tickets + blockIdx.x, blockIdx.y,
                                   gridDim.y, active_index, out, batch, b0, nb, j0, a_pad,
                                   d_out);
}

// ---------------------------------------------------------------- bfloat16

constexpr int kMmaCols = 64;       // compact columns per block: four m16 tiles
constexpr int kChunk = 64;         // d_in rows per ring stage: four k16 steps
constexpr int kMaxTileRows = 128;  // batch rows per block: 16 n8 tiles, two per warp pair
constexpr int kMaxSplits = 8;      // the largest portable cluster
constexpr int kABytes = kChunk * kMmaCols * 2;  // a stage's panel tile: 64 rows of 128 bytes
constexpr int kXRowBytes = kChunk * 2 + 16;     // a batch row of a stage's x: 144 bytes
constexpr int kPStride = kMmaCols + 4;          // floats per batch row of the partial tile
static_assert(kThreads * 2 == kChunk * kMmaCols / 8, "two 16-byte pieces a thread per chunk");
static_assert(kThreads % kMmaCols == 0 && kChunk % (kThreads / kMmaCols) == 0,
              "the element path: a column a thread, every fourth row");
constexpr int kStages = 4;
constexpr int kAhead = kStages - 1;  // chunks loaded ahead of the one computed

// A ring of kStages stages of [panel tile | x]
__host__ __device__ constexpr int mma_stage_bytes(int tile_rows) {
  return kABytes + ((tile_rows + 7) & ~7) * kXRowBytes;
}
__host__ __device__ constexpr int mma_smem(int tile_rows) {
  return kStages * mma_stage_bytes(tile_rows);
}
static_assert(mma_smem(1) >= 8 * kPStride * 4 &&
              mma_smem(kMaxTileRows) >= kMaxTileRows * kPStride * 4,
              "the partial tile fits the ring");

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v));
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

// grid: (splits, ceil(a_pad / kMmaCols), ceil(B / tile_rows)), a cluster of
// the `splits` blocks of a column and batch tile; block: kThreads; dynamic
// shared memory mma_smem(tile_rows). Block (s, t, z) computes rows
// [s * split_rows, +split_rows) of d_in for columns [64 t, +64) and batch
// rows [z * tile_rows, +tile_rows). kN8: the most n8 tiles of batch rows a
// block holds, 1 (decode, tile_rows <= 8: four blocks an SM, three on the
// element path) or 16.
// kVecA: the panel by 16-byte cp.async (w 16-byte aligned, ld_w % 8 == 0);
// else the element path, through active_index when kGather (K6). kVecX: x
// by cp.async (d_in % 8 == 0, x 16-byte aligned).
template <int kN8, bool kVecA, bool kGather, bool kVecX>
__global__ void __launch_bounds__(kThreads, kN8 == 1 ? 4 : 2)
structured_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const int32_t* __restrict__ active_index, __nv_bfloat16* __restrict__ out,
               int batch, int d_in, int a_pad, int d_out, int ld_w, int split_rows,
               int tile_rows, bool vec_w) {
  static_assert(!(kVecA && kGather), "K6 gathers through active_index");
  extern __shared__ __align__(128) unsigned char mma_smem_raw[];
  const uint32_t base = hopper::smem_addr(mma_smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int i0 = split * split_rows;
  const int chunks = (min(d_in - i0, split_rows) + kChunk - 1) / kChunk;
  const int j0 = blockIdx.y * kMmaCols;
  const int b0 = blockIdx.z * tile_rows;
  const int nb = min(tile_rows, batch - b0);
  const int n8 = (nb + 7) >> 3;  // n8 tiles holding this block's batch rows
  const int stage_bytes = mma_stage_bytes(tile_rows);

  // K6's bulk path: a tile whose 64 active columns lie in order in W from
  // a multiple of 8 (as an export's do where none of the 64 neurons is
  // ablated) comes by 16-byte cp.async, as K5's panel does, from column
  // col0 of w
  int col0 = j0;
  bool bulk = kVecA;
  if constexpr (kGather) {
    const int c = tid & (kMmaCols - 1);
    const int first = j0 + kMmaCols <= a_pad ? __ldg(active_index + j0) : 0;
    bulk = __syncthreads_and(vec_w && j0 + kMmaCols <= a_pad && first % 8 == 0 &&
                             first + kMmaCols <= d_out && __ldg(active_index + j0 + c) == first + c);
    col0 = first;
  }
  // chunk c's stage: its panel tile, then its x
  auto a_tile = [&](int c) { return base + (c % kStages) * stage_bytes; };
  auto x_tile = [&](int c) { return a_tile(c) + kABytes; };

  // x rows [b0, b0 + 8 n8) of chunk c; zeros past B and d_in
  auto load_x = [&](int c) {
    const uint32_t xs = x_tile(c);
    const int ic = i0 + c * kChunk;
    for (int item = tid; item < n8 * 8 * 8; item += kThreads) {
      const int r = item >> 3, piece = item & 7;
      const int i = ic + piece * 8;
      const uint32_t dst = xs + r * kXRowBytes + piece * 16;
      const __nv_bfloat16* src = x + static_cast<size_t>(b0 + r) * d_in + i;
      if (kVecX) {
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
  // the panel tile of chunk c by 16-byte cp.async (16-byte chunk p of row r
  // at p ^ (r % 8)); zeros past d_in and a_pad
  auto load_a = [&](int c) {
    const uint32_t as = a_tile(c);
    const int ic = i0 + c * kChunk;
    for (int item = tid; item < kChunk * 8; item += kThreads) {
      const int r = item >> 3, piece = item & 7;
      const int i = ic + r;
      const bool ok = i < d_in && j0 + piece * 8 < a_pad;
      hopper::cp_async16(as + r * 128 + ((piece ^ (r & 7)) << 4),
                         ok ? w + static_cast<size_t>(i) * ld_w + col0 + piece * 8 : w, ok);
    }
  };

  // The element path (a panel K5 cannot copy 16 bytes at a time, and K6
  // off the bulk path): thread t loads column ec = t % 64 of the tile at
  // rows er + 4 m (er = t / 64, m < kElems) of a chunk with 2-byte loads,
  // so a warp's lanes read 32 neighbouring active columns of one row. A
  // chunk's loads are issued into registers kAhead chunks ahead, before the
  // compute, and stored to its panel tile after it.
  const int ec = tid & (kMmaCols - 1);
  const int er = tid / kMmaCols;
  constexpr int kRowStep = kThreads / kMmaCols;
  constexpr int kElems = kChunk / kRowStep;
  const int ej = j0 + ec;
  const int wcol = ej >= a_pad ? -1 : kGather ? min(__ldg(active_index + ej), d_out - 1) : ej;
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w) + max(wcol, 0);
  auto fetch = [&](int c, uint16_t (&v)[kElems]) {
    const int rows = wcol < 0 ? 0 : min(kChunk, d_in - i0 - c * kChunk);  // zeros past d_in
    const unsigned short* p = wu + static_cast<size_t>(i0 + c * kChunk + er) * ld_w;
    const size_t step = static_cast<size_t>(kRowStep) * ld_w;
#pragma unroll
    for (int m = 0; m < kElems; ++m) v[m] = er + m * kRowStep < rows ? __ldg(p + m * step) : 0;
  };
  auto deposit = [&](int c, const uint16_t (&v)[kElems]) {
    const uint32_t as = a_tile(c) + (ec & 7) * 2;
#pragma unroll
    for (int m = 0; m < kElems; ++m) {
      const int r = er + m * kRowStep;
      st_shared_u16(as + r * 128 + (((ec >> 3) ^ (r & 7)) << 4), v[m]);
    }
  };

  // warp w: m16 tile w % 4 (columns j0 + 16 (w % 4) ..), n8 tiles w / 4 + 2 u
  constexpr int kPerWarp = kN8 > 1 ? kN8 / 2 : 1;
  const int mt = warp & 3;
  const int nq = warp >> 2;
  float acc[kPerWarp][4];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  // ldmatrix row addresses: lanes 8q .. 8q + 7 give matrix q's rows
  const int q8 = lane >> 3;
  const int r8 = lane & 7;
  auto compute = [&](int c) {
    const uint32_t as = a_tile(c);
    const uint32_t xs = x_tile(c);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      // A (16 columns x 16 rows of d_in), trans: matrix q = (rows + 8 (q / 2),
      // columns + 8 (q % 2)) gives a[q]
      const int kr = ks * 16 + r8 + ((q8 >> 1) << 3);
      const int piece = mt * 2 + (q8 & 1);
      uint32_t a[4];
      hopper::ldmatrix_x4_trans(a, as + kr * 128 + ((piece ^ (kr & 7)) << 4));
#pragma unroll
      for (int u = 0; u < kPerWarp; u += 2) {
        const int t0 = nq + 2 * u;  // n8 tiles t0 and t0 + 2
        if (t0 < n8) {
          const bool pair = u + 1 < kPerWarp && t0 + 2 < n8;
          // matrix q = (tile t0 + 2 (q / 2) or t0 alone, rows + 8 (q % 2) of d_in)
          const int tile = (q8 >> 1) && pair ? t0 + 2 : t0;
          uint32_t b[4];
          hopper::ldmatrix_x4(b, xs + (tile * 8 + r8) * kXRowBytes + ks * 32 + ((q8 & 1) << 4));
          hopper::mma_m16n8k16(acc[u], a, b[0], b[1]);
          if (pair) hopper::mma_m16n8k16(acc[u + 1], a, b[2], b[3]);
        }
      }
    }
  };

  uint16_t v[kElems];  // the element path's loads of one chunk
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < chunks) {
      if (bulk) {
        load_a(c);
      } else if constexpr (!kVecA) {
        fetch(c, v);
        deposit(c, v);
      }
      load_x(c);
    }
    hopper::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    hopper::cp_async_wait<kAhead - 1>();
    // chunk c is in place for every thread; past the barrier every warp is
    // also done with chunk c - 1, whose stage the next load reuses
    __syncthreads();
    const int next = c + kAhead;
    if (next < chunks) {
      if (bulk) load_a(next);
      else if constexpr (!kVecA) fetch(next, v);
      load_x(next);
    }
    hopper::cp_async_commit();
    compute(c);
    // the element path stores chunk next once its loads land, while no warp
    // reads that stage any more
    if constexpr (!kVecA) {
      if (!bulk && next < chunks) deposit(next, v);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  // this split's partial tile, [batch row][column] (kPStride floats a row):
  // accumulator e of tile u is column 16 mt + lane / 4 (+ 8 for e >= 2),
  // batch row 8 (nq + 2 u) + 2 (lane % 4) (+ 1 for odd e)
  float* part = reinterpret_cast<float*>(mma_smem_raw);
  {
    const int jj = mt * 16 + (lane >> 2);
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int t = nq + 2 * u;
      if (t < n8) {
        const int bb = t * 8 + 2 * (lane & 3);
        part[bb * kPStride + jj] = acc[u][0];
        part[(bb + 1) * kPStride + jj] = acc[u][1];
        part[bb * kPStride + jj + 8] = acc[u][2];
        part[(bb + 1) * kPStride + jj + 8] = acc[u][3];
      }
    }
  }
  cluster.sync();  // every split's partial tile is in place

  // block s of the cluster adds its share of the tile over the splits, in
  // order, four columns at a time, and stores
  for (int e = split * kThreads + tid; e < nb * (kMmaCols / 4); e += splits * kThreads) {
    const int b = e / (kMmaCols / 4);
    const int c4 = (e % (kMmaCols / 4)) * 4;
    const int off = b * kPStride + c4;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + off);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s) + off);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + c4 + q;
      if (j >= a_pad) break;
      const int dst = __ldg(active_index + j);
      if (static_cast<unsigned>(dst) < static_cast<unsigned>(d_out))  // else a sentinel
        out[static_cast<size_t>(b0 + b) * d_out + dst] = __float2bfloat16_rn(vs[q]);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

template <int kN8, bool kVecA, bool kGather, bool kVecX>
cudaError_t launch_mma(const void* x, const void* w, const void* active_index, void* out,
                       int batch, int d_in, int a_pad, int d_out, int ld_w, int split_rows,
                       int splits, int tile_rows, bool vec_w, cudaStream_t stream) {
  auto kernel = structured_mma<kN8, kVecA, kGather, kVecX>;
  static const cudaError_t opted =  // above the 48 KB default, once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           mma_smem(kN8 * 8));
  if (opted != cudaSuccess) return opted;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (a_pad + kMmaCols - 1) / kMmaCols,
                        (batch + tile_rows - 1) / tile_rows);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = mma_smem(tile_rows);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<const int32_t*>(active_index),
                            static_cast<__nv_bfloat16*>(out), batch, d_in, a_pad, d_out, ld_w,
                            split_rows, tile_rows, vec_w);
}

template <bool kVecA, bool kGather>
cudaError_t dispatch_mma_x(bool vec_x, const void* x, const void* w, const void* active_index,
                           void* out, int batch, int d_in, int a_pad, int d_out, int ld_w,
                           int split_rows, int splits, int tile_rows, bool vec_w,
                           cudaStream_t s) {
  if (tile_rows <= 8)
    return vec_x ? launch_mma<1, kVecA, kGather, true>(x, w, active_index, out, batch, d_in,
                                                       a_pad, d_out, ld_w, split_rows, splits,
                                                       tile_rows, vec_w, s)
                 : launch_mma<1, kVecA, kGather, false>(x, w, active_index, out, batch, d_in,
                                                        a_pad, d_out, ld_w, split_rows, splits,
                                                        tile_rows, vec_w, s);
  return vec_x ? launch_mma<16, kVecA, kGather, true>(x, w, active_index, out, batch, d_in,
                                                      a_pad, d_out, ld_w, split_rows, splits,
                                                      tile_rows, vec_w, s)
               : launch_mma<16, kVecA, kGather, false>(x, w, active_index, out, batch, d_in,
                                                       a_pad, d_out, ld_w, split_rows, splits,
                                                       tile_rows, vec_w, s);
}

template <int BT, bool kGather>
cudaError_t launch_f32(const void* x, const void* w, const void* active_index, void* out,
                       float* ws, int* tickets, int batch, int d_in, int a_pad, int d_out,
                       int ld_w, cudaStream_t stream) {
  const dim3 grid((a_pad + kCols - 1) / kCols, (d_in + kSplitRows - 1) / kSplitRows,
                  (batch + BT - 1) / BT);
  structured_kernel<BT, kGather><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(active_index), static_cast<float*>(out), ws, tickets, batch,
      d_in, a_pad, d_out, ld_w);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_f32_tiled(const void* x, const void* w, const void* active_index, void* out,
                             float* ws, int* tickets, int batch, int d_in, int a_pad, int d_out,
                             int ld_w, cudaStream_t stream) {
  auto kernel = structured_f32_tiled<kVec>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32TileSmem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((a_pad + kF32TileCols - 1) / kF32TileCols *
                      ((batch + kF32TileRows - 1) / kF32TileRows),
                  (d_in + kSplitRows - 1) / kSplitRows);
  kernel<<<grid, kThreads, kF32TileSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(active_index), static_cast<float*>(out), ws, tickets, batch,
      d_in, a_pad, d_out, ld_w);
  return cudaGetLastError();
}

template <bool kGather>
cudaError_t dispatch_f32(int block_rows, const void* x, const void* w, const void* active_index,
                         void* out, float* ws, int* tickets, int batch, int d_in, int a_pad,
                         int d_out, int ld_w, cudaStream_t s) {
  switch (block_rows) {
    case 1: return launch_f32<1, kGather>(x, w, active_index, out, ws, tickets, batch, d_in,
                                          a_pad, d_out, ld_w, s);
    case 2: return launch_f32<2, kGather>(x, w, active_index, out, ws, tickets, batch, d_in,
                                          a_pad, d_out, ld_w, s);
    case 4: return launch_f32<4, kGather>(x, w, active_index, out, ws, tickets, batch, d_in,
                                          a_pad, d_out, ld_w, s);
    case 8: return launch_f32<8, kGather>(x, w, active_index, out, ws, tickets, batch, d_in,
                                          a_pad, d_out, ld_w, s);
    default: return cudaErrorInvalidValue;
  }
}

size_t dtype_size(int dtype) { return dtype == 0 ? 4 : 2; }

// Tickets of the float32 launches: one per (column tile, batch tile).
size_t f32_tickets(int batch, int a_pad, int block_rows) {
  return static_cast<size_t>((a_pad + kCols - 1) / kCols) *
         ((batch + block_rows - 1) / block_rows);
}

bool is_tile(int rows, int most) {
  return rows > 0 && rows <= most && (rows & (rows - 1)) == 0;
}

}  // namespace

extern "C" {

// K4. dtype: 0 = float32, 1 = bfloat16 (x, values and out). block_rows,
// rows_per_warp, split_rows, pass_rows, block_neurons, decode_loads: the
// launch, as condensed_matmul_fwd's. Returns the cudaError_t (0 = success).
int coa_matmul_fwd(const void* x, const void* values, const void* indices, const void* out_index,
                   void* out, int batch, int d_in, int a, int k, int d_out, int dtype,
                   int block_rows, int rows_per_warp, int split_rows, int pass_rows,
                   int block_neurons, int decode_loads, void* stream) {
  if (batch <= 0 || a <= 0 || d_in <= 0 || d_out <= 0 || k < 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * dtype_size(dtype), s);
  if (err != cudaSuccess) return err;
  return condensed_rows::dispatch(dtype, 0, block_rows, rows_per_warp, split_rows, pass_rows,
                                  block_neurons, decode_loads, x, values, indices, nullptr,
                                  out_index, out, batch, d_in, a, k, d_out, s);
}

// K2-coa. As coa_matmul_fwd, with int8 (vtype 1) or float8_e4m3 (vtype 2)
// codes and a float32 scale per row (scales: a floats).
int coa_matmul_scaled_fwd(const void* x, const void* codes, const void* indices,
                          const void* out_index, const void* scales, void* out, int batch,
                          int d_in, int a, int k, int d_out, int dtype, int vtype, int block_rows,
                          int rows_per_warp, int split_rows, int pass_rows, int block_neurons,
                          int decode_loads, void* stream) {
  if (batch <= 0 || a <= 0 || d_in <= 0 || d_out <= 0 || k < 0 || (dtype != 0 && dtype != 1) ||
      (vtype != 1 && vtype != 2) || scales == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * dtype_size(dtype), s);
  if (err != cudaSuccess) return err;
  return condensed_rows::dispatch(dtype, vtype, block_rows, rows_per_warp, split_rows, pass_rows,
                                  block_neurons, decode_loads, x, codes, indices,
                                  static_cast<const float*>(scales), out_index, out, batch, d_in,
                                  a, k, d_out, s);
}

// K5 (gather = 0: w is the (d_in, a_pad) panel, ld_w = a_pad) and K6
// (gather = 1: w is the dense (d_in, d_out) weight, ld_w = d_out).
// out: out_bytes bytes, at least structured_matmul_out_bytes(...): the
// (batch, d_out) output, then (float32) the tickets. block_rows: the batch
// rows of a block. split_rows: the rows of d_in of a split.
//   bfloat16 (dtype 1): block_rows a power of two up to 128; split_rows a
//   multiple of 64 with at most 8 splits; no workspace.
//   float32 (dtype 0): block_rows 1, 2, 4 or 8 (decode, K6) or 32 (tiled,
//   K5 only); split_rows 256; workspace: ws_floats float32 elements, at
//   least ceil(d_in / 256) * batch * a_pad, for the split partials.
// Returns the cudaError_t (0 = success).
int structured_matmul_fwd(const void* x, const void* w, const void* active_index, void* out,
                          long long out_bytes, void* workspace, long long ws_floats, int batch,
                          int d_in, int a_pad, int d_out, int ld_w, int gather, int dtype,
                          int block_rows, int split_rows, void* stream) {
  if (batch <= 0 || d_in <= 0 || a_pad <= 0 || d_out <= 0 || split_rows <= 0 ||
      (dtype != 0 && dtype != 1) || ld_w < (gather ? d_out : a_pad))
    return cudaErrorInvalidValue;
  const long long splits = (d_in + split_rows - 1) / split_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!is_tile(block_rows, kMaxTileRows) || split_rows % kChunk != 0 || splits > kMaxSplits ||
        out_bytes < static_cast<long long>(batch) * d_out * 2)
      return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * d_out * 2, s);
    if (err != cudaSuccess) return err;
    const bool vec_x = d_in % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool vec_w = ld_w % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const int n = static_cast<int>(splits);
    if (gather)
      return dispatch_mma_x<false, true>(vec_x, x, w, active_index, out, batch, d_in, a_pad,
                                         d_out, ld_w, split_rows, n, block_rows, vec_w, s);
    if (vec_w)
      return dispatch_mma_x<true, false>(vec_x, x, w, active_index, out, batch, d_in, a_pad,
                                         d_out, ld_w, split_rows, n, block_rows, vec_w, s);
    return dispatch_mma_x<false, false>(vec_x, x, w, active_index, out, batch, d_in, a_pad,
                                        d_out, ld_w, split_rows, n, block_rows, vec_w, s);
  }
  const bool tiled = block_rows == kF32TileRows;
  const size_t zeroed = tickets_offset(batch, d_out, 4) +
                        f32_tickets(batch, a_pad, block_rows) * sizeof(int);
  if (split_rows != kSplitRows || !(is_tile(block_rows, 8) || (tiled && !gather)) ||
      ws_floats < splits * batch * a_pad || out_bytes < static_cast<long long>(zeroed))
    return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  int* tickets = reinterpret_cast<int*>(static_cast<char*>(out) + tickets_offset(batch, d_out, 4));
  cudaError_t err = cudaMemsetAsync(out, 0, zeroed, s);
  if (err != cudaSuccess) return err;
  if (tiled) {
    const bool vec = ld_w % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    return vec ? launch_f32_tiled<true>(x, w, active_index, out, ws, tickets, batch, d_in, a_pad,
                                        d_out, ld_w, s)
               : launch_f32_tiled<false>(x, w, active_index, out, ws, tickets, batch, d_in,
                                         a_pad, d_out, ld_w, s);
  }
  return gather ? dispatch_f32<true>(block_rows, x, w, active_index, out, ws, tickets, batch, d_in,
                                     a_pad, d_out, ld_w, s)
                : dispatch_f32<false>(block_rows, x, w, active_index, out, ws, tickets, batch,
                                      d_in, a_pad, d_out, ld_w, s);
}

// Bytes of the region structured_matmul_fwd takes as out: the output and,
// in float32, the tickets.
long long structured_matmul_out_bytes(int batch, int d_out, int a_pad, int dtype,
                                      int block_rows) {
  if (batch <= 0 || d_out <= 0 || a_pad <= 0 || block_rows <= 0) return 0;
  if (dtype == 1) return static_cast<long long>(batch) * d_out * 2;
  return static_cast<long long>(tickets_offset(batch, d_out, 4) +
                                f32_tickets(batch, a_pad, block_rows) * sizeof(int));
}

const char* structured_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
