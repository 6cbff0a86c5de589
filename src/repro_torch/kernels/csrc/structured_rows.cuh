// The bodies of K5 and K6 (structured_mma in bfloat16, structured_kernel and
// structured_f32_tiled in float32) and their launches, shared by the plain
// entry points (structured_matmul.cu, whose header note gives the design and
// the bounds) and the expert-grouped ones (structured_matmul_grouped.cu:
// K5-moe and K6-moe, the reference's jax.vmap of _structured_kernel and
// _structured_prefetch_kernel over an MoE layer's experts).
//
// Grouping is a template argument (kGrouped): a grouped block moves its
// pointers to its expert's problem (an SGroup of element strides) and then
// runs the one-expert body as it stands, so every output's chain is the
// one-expert launch's and the grouped launch equals E separate launches
// bitwise. The expert is a grid axis that no cluster spans: z = expert *
// batch tiles + batch tile in structured_mma and structured_kernel, z =
// expert in structured_f32_tiled; in float32 each expert has its own slice
// of the split partials and its own tickets. A plain launch (kGrouped false,
// kSOne) compiles to the one-expert kernels with no expert offset.
//
// Internal linkage: the plain and the grouped library are loaded into one
// process, and a template's function-local static (the shared-memory
// opt-in) with external linkage would be one object for both.
#pragma once

#include <cooperative_groups.h>

#include "condensed_rows.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using condensed_rows::Column;

// Element strides between the experts of a grouped launch (K5-moe, K6-moe;
// structured_matmul_grouped.cu): x (B * d_in), w (d_in * ld_w), active_index
// (a_pad), out (B * d_out), and in float32 the split partials (splits * B *
// a_pad) and the tickets. A plain launch passes kSOne, which its kernels
// never read.
struct SGroup {
  int experts;
  long long x, w, ai, out, ws, tickets;
};
constexpr SGroup kSOne = {1, 0, 0, 0, 0, 0, 0};
// A grouped block's z index `tile_z` (z_tiles tiles an expert) split into
// its expert `e` and its tile of that expert, the pointers moved to the
// expert's problem (written out in each kernel, whose parameters are
// __restrict__ pointers)
#define STRUCTURED_TO_EXPERT(grp, e, tile_z, z_tiles)   \
  const long long e = (tile_z) / (z_tiles);             \
  tile_z -= static_cast<int>(e) * (z_tiles);            \
  x += e * (grp).x;                                     \
  w += e * (grp).w;                                     \
  active_index += e * (grp).ai;                         \
  out += e * (grp).out

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
// sums; tickets: one zeroed int per (column tile, batch tile). kGrouped: z
// = expert * ceil(B / BT) + batch tile, each expert its own ws and tickets.
template <int BT, bool kGather, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
structured_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int32_t* __restrict__ active_index, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int batch, int d_in,
                  int a_pad, int d_out, int ld_w, SGroup grp) {
  __shared__ __align__(16) unsigned char xs_raw[kSplitRows * sizeof(Column<float, BT>)];
  __shared__ float red[kWarps * BT * kCols];
  Column<float, BT>* xs = reinterpret_cast<Column<float, BT>*>(xs_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kCols;
  const int i0 = blockIdx.y * kSplitRows;
  const int ni = min(kSplitRows, d_in - i0);
  int tile_z = blockIdx.z;
  if constexpr (kGrouped) {
    STRUCTURED_TO_EXPERT(grp, e, tile_z, (batch + BT - 1) / BT);
    ws += e * grp.ws;
    tickets += e * grp.tickets;
  }
  const int b0 = tile_z * BT;
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
  f32_split_epilogue<kCols, false>(red, BT, ws, tickets + tile_z * gridDim.x + blockIdx.x,
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
// 4 == 0 and the panel 16-byte aligned). kGrouped: z = the expert.
template <bool kVec, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 2)
structured_f32_tiled(const float* __restrict__ x, const float* __restrict__ w,
                     const int32_t* __restrict__ active_index, float* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ tickets, int batch, int d_in,
                     int a_pad, int d_out, int ld_w, SGroup grp) {
  constexpr int kHalf = kSplitRows / 2;
  if constexpr (kGrouped) {
    int tile_z = blockIdx.z;
    STRUCTURED_TO_EXPERT(grp, e, tile_z, 1);
    ws += e * grp.ws;
    tickets += e * grp.tickets;
  }
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
// by cp.async (d_in % 8 == 0, x 16-byte aligned). kGrouped: z = expert *
// ceil(B / tile_rows) + batch tile (no cluster spans z).
template <int kN8, bool kVecA, bool kGather, bool kVecX, bool kGrouped>
__global__ void __launch_bounds__(kThreads, kN8 == 1 ? 4 : 2)
structured_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const int32_t* __restrict__ active_index, __nv_bfloat16* __restrict__ out,
               int batch, int d_in, int a_pad, int d_out, int ld_w, int split_rows,
               int tile_rows, bool vec_w, SGroup grp) {
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
  int tile_z = blockIdx.z;
  if constexpr (kGrouped) {
    STRUCTURED_TO_EXPERT(grp, e, tile_z, (batch + tile_rows - 1) / tile_rows);
  }
  const int b0 = tile_z * tile_rows;
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

template <int kN8, bool kVecA, bool kGather, bool kVecX, bool kGrouped>
cudaError_t launch_mma(const void* x, const void* w, const void* active_index, void* out,
                       int batch, int d_in, int a_pad, int d_out, int ld_w, int split_rows,
                       int splits, int tile_rows, bool vec_w, const SGroup& grp,
                       cudaStream_t stream) {
  auto kernel = structured_mma<kN8, kVecA, kGather, kVecX, kGrouped>;
  static const cudaError_t opted =  // above the 48 KB default, once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           mma_smem(kN8 * 8));
  if (opted != cudaSuccess) return opted;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (a_pad + kMmaCols - 1) / kMmaCols,
                        grp.experts * ((batch + tile_rows - 1) / tile_rows));
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
                            split_rows, tile_rows, vec_w, grp);
}

template <bool kVecA, bool kGather, bool kGrouped>
cudaError_t dispatch_mma_x(bool vec_x, const void* x, const void* w, const void* active_index,
                           void* out, int batch, int d_in, int a_pad, int d_out, int ld_w,
                           int split_rows, int splits, int tile_rows, bool vec_w,
                           const SGroup& grp, cudaStream_t s) {
  if (tile_rows <= 8)
    return vec_x ? launch_mma<1, kVecA, kGather, true, kGrouped>(
                       x, w, active_index, out, batch, d_in, a_pad, d_out, ld_w, split_rows,
                       splits, tile_rows, vec_w, grp, s)
                 : launch_mma<1, kVecA, kGather, false, kGrouped>(
                       x, w, active_index, out, batch, d_in, a_pad, d_out, ld_w, split_rows,
                       splits, tile_rows, vec_w, grp, s);
  return vec_x ? launch_mma<16, kVecA, kGather, true, kGrouped>(
                     x, w, active_index, out, batch, d_in, a_pad, d_out, ld_w, split_rows,
                     splits, tile_rows, vec_w, grp, s)
               : launch_mma<16, kVecA, kGather, false, kGrouped>(
                     x, w, active_index, out, batch, d_in, a_pad, d_out, ld_w, split_rows,
                     splits, tile_rows, vec_w, grp, s);
}

template <int BT, bool kGather, bool kGrouped>
cudaError_t launch_f32(const void* x, const void* w, const void* active_index, void* out,
                       float* ws, int* tickets, int batch, int d_in, int a_pad, int d_out,
                       int ld_w, const SGroup& grp, cudaStream_t stream) {
  const dim3 grid((a_pad + kCols - 1) / kCols, (d_in + kSplitRows - 1) / kSplitRows,
                  grp.experts * ((batch + BT - 1) / BT));
  structured_kernel<BT, kGather, kGrouped><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(active_index), static_cast<float*>(out), ws, tickets, batch,
      d_in, a_pad, d_out, ld_w, grp);
  return cudaGetLastError();
}

template <bool kVec, bool kGrouped>
cudaError_t launch_f32_tiled(const void* x, const void* w, const void* active_index, void* out,
                             float* ws, int* tickets, int batch, int d_in, int a_pad, int d_out,
                             int ld_w, const SGroup& grp, cudaStream_t stream) {
  auto kernel = structured_f32_tiled<kVec, kGrouped>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32TileSmem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((a_pad + kF32TileCols - 1) / kF32TileCols *
                      ((batch + kF32TileRows - 1) / kF32TileRows),
                  (d_in + kSplitRows - 1) / kSplitRows, grp.experts);
  kernel<<<grid, kThreads, kF32TileSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(active_index), static_cast<float*>(out), ws, tickets, batch,
      d_in, a_pad, d_out, ld_w, grp);
  return cudaGetLastError();
}

template <bool kGather, bool kGrouped>
cudaError_t dispatch_f32(int block_rows, const void* x, const void* w, const void* active_index,
                         void* out, float* ws, int* tickets, int batch, int d_in, int a_pad,
                         int d_out, int ld_w, const SGroup& grp, cudaStream_t s) {
  switch (block_rows) {
    case 1: return launch_f32<1, kGather, kGrouped>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, grp, s);
    case 2: return launch_f32<2, kGather, kGrouped>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, grp, s);
    case 4: return launch_f32<4, kGather, kGrouped>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, grp, s);
    case 8: return launch_f32<8, kGather, kGrouped>(x, w, active_index, out, ws, tickets, batch,
                                                    d_in, a_pad, d_out, ld_w, grp, s);
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

// The launch checks of structured_matmul_fwd (one expert's problem; see its
// note), without the memset: true where the arguments are a launch.
bool structured_args_ok(int batch, int d_in, int a_pad, int d_out, int ld_w, int gather,
                        int dtype, int block_rows, int split_rows) {
  if (batch <= 0 || d_in <= 0 || a_pad <= 0 || d_out <= 0 || split_rows <= 0 ||
      (dtype != 0 && dtype != 1) || ld_w < (gather ? d_out : a_pad))
    return false;
  const long long splits = (d_in + split_rows - 1) / split_rows;
  if (dtype == 1)
    return is_tile(block_rows, kMaxTileRows) && split_rows % kChunk == 0 && splits <= kMaxSplits;
  return split_rows == kSplitRows &&
         (is_tile(block_rows, 8) || (block_rows == kF32TileRows && !gather));
}

// The kernel launch of K5 / K6 once the output (and the tickets) are
// cleared: structured_mma in bfloat16; in float32 structured_f32_tiled at
// kF32TileRows rows a block, else structured_kernel. ws and tickets: one
// expert's (grp gives the strides of the others).
template <bool kGrouped>
cudaError_t structured_launch(const void* x, const void* w, const void* active_index, void* out,
                              float* ws, int* tickets, int batch, int d_in, int a_pad, int d_out,
                              int ld_w, int gather, int dtype, int block_rows, int split_rows,
                              const SGroup& grp, cudaStream_t s) {
  if (dtype == 1) {
    const bool vec_x = d_in % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool vec_w = ld_w % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const int n = (d_in + split_rows - 1) / split_rows;
    if (gather)
      return dispatch_mma_x<false, true, kGrouped>(vec_x, x, w, active_index, out, batch, d_in,
                                                   a_pad, d_out, ld_w, split_rows, n,
                                                   block_rows, vec_w, grp, s);
    if (vec_w)
      return dispatch_mma_x<true, false, kGrouped>(vec_x, x, w, active_index, out, batch, d_in,
                                                   a_pad, d_out, ld_w, split_rows, n,
                                                   block_rows, vec_w, grp, s);
    return dispatch_mma_x<false, false, kGrouped>(vec_x, x, w, active_index, out, batch, d_in,
                                                  a_pad, d_out, ld_w, split_rows, n, block_rows,
                                                  vec_w, grp, s);
  }
  if (block_rows == kF32TileRows) {
    const bool vec = ld_w % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    return vec ? launch_f32_tiled<true, kGrouped>(x, w, active_index, out, ws, tickets, batch,
                                                  d_in, a_pad, d_out, ld_w, grp, s)
               : launch_f32_tiled<false, kGrouped>(x, w, active_index, out, ws, tickets, batch,
                                                   d_in, a_pad, d_out, ld_w, grp, s);
  }
  return gather ? dispatch_f32<true, kGrouped>(block_rows, x, w, active_index, out, ws, tickets,
                                               batch, d_in, a_pad, d_out, ld_w, grp, s)
                : dispatch_f32<false, kGrouped>(block_rows, x, w, active_index, out, ws, tickets,
                                                batch, d_in, a_pad, d_out, ld_w, grp, s);
}

}  // namespace
