// Values gradient of the condensed constant fan-in matmul for Hopper
// (sm_90a): K3.
//
//   dw[n, k] = sum_b f32(dy[b, n]) * f32(x[b, idx[n, k]])   (f32 accumulator, f32 out)
//
// dy: (B, n_out), x: (B, d_in), both float32 or both bfloat16; idx:
// (n_out, k) int32 in any order, duplicates allowed; dw: (n_out, k)
// float32. A duplicate index gets its own entry (the kernels gather and
// never scatter). Every index must lie in [0, d_in): the kernels do not
// check (an export's indices always do).
//
// Replaces the TPU kernel repro/kernels/condensed_matmul.py::_dw_kernel
// (launched by _dw_tiled, its pallas_call at :453, through
// condensed_matmul_dw), the values gradient of the condensed linears'
// custom VJPs in repro/kernels/ops.py.
//
// Bound: dy, x, idx and dw each once is (B * (n_out + d_in)) * sizeof(T) +
// 8 * n_out * k bytes; the work is 2 * B * n_out * k operations on inputs of
// type T, at the card's peak for T (989 TFLOP/s for bfloat16 with float32
// accumulation, 67 TFLOP/s for float32). At the training shapes of
// qwen3-1.7b (B*T = 512, k = 195..585) the bytes bound bfloat16 (about 19
// µs per layer of wo + w_gate + w_up + w_down) and the operations bound
// float32 (about 64 µs). Two paths, chosen by the dtype:
//
// bfloat16 -- a dense tile product on the tensor cores with a gather
// epilogue. Its own floor is the dense product, 2 * B * d_in * n_out
// operations (42.9 GFLOP per training layer, 43.4 µs at the bf16 peak, ten
// times the kept products: at 9.5% density no tile is empty), and the
// operands' traffic from L2, (kTI + kTJ) * B * 2 bytes per tile, which
// bounds it in practice. Two kernels:
//   * dw_kernel_bucket groups each 16 rows' slots into cells (the
//     128-input d_in tile of their index, row) in an int32 workspace (per
//     group: its slots f | (index % 128) << 25, cell by cell, tile-major,
//     then the cells' offsets), for both paths. It lets dw_kernel_mma start
//     at once (a programmatic dependent launch).
//   * dw_kernel_mma: a block owns one 128 x 128 tile of (d_in, neurons) and
//     computes G = x[:, I]^T dy[:, N] over the whole batch with
//     wgmma.m64n128k16 (bf16 in, f32 accumulators), a warpgroup per 64 d_in
//     rows, both operands read from shared memory MN-major (the batch is
//     the reduction axis) with the 128-byte swizzle. cp.async brings the
//     batch in chunks of kBK = 64 rows through a ring (zero-filled past B,
//     d_in and n_out), kStages - 2 chunks ahead, one chunk's product left
//     running while the next is awaited. Three stages let two blocks share
//     an SM; where the tiles leave one block per SM, four stages keep more
//     bytes in flight. Then G goes to shared memory, the block waits for the
//     workspace, and each warp takes its group's segment for this tile:
//     dw[n, s] = G[idx - i0, n - n0].
//   Every slot is written once, by the one block whose tile holds its index:
//   no atomics on dw and no pass over it but this one, so two launches are
//   bitwise equal (the order inside a segment, set by shared-memory atomics
//   in the bucket kernel, changes no value) and duplicate indices read one
//   entry of G. wgmma is taken over mma.sync: with ldmatrix.trans and
//   mma.sync the same tiles ran no faster, and wgmma reads both operands
//   from shared memory without staging fragments in registers. The products
//   are exact in f32; only the order of the f32 additions differs from the
//   plain version.
//
// float32 -- dw_kernel_f32: CUDA cores in full float32 (no TF32), on the
// same bucket workspace and the same grid of 128 x 128 tiles. A block
// stages chunks of kF32BK = 32 batch rows of x[:, I] and dy[:, N] in shared
// memory transposed (16-byte loads and stores, a column's rows side by
// side). Each lane holds an equal, contiguous run of its warp's segment
// (ordered by row) with the accumulators in registers; per four batch rows
// it reads each entry's x with one 16-byte load and its row's dy only where
// the row changes. Each slot adds the batch rows in order, in one thread,
// so the result is deterministic and duplicate indices give equal columns.
// A block holds only the slots whose index lies in its tile, so it covers
// 128 rows at a few entries per lane, and each staged value of x feeds
// about 128 * k / d_in slots (a block that holds all k slots of its rows
// stages all of x per 16 or 32 rows). The time follows the total work over
// the card, bound by the random 16-byte reads of x from shared memory; a
// run longer than kF32Entries takes more passes.
//
// Expert-grouped launch (K3-moe: the values gradient of an MoE layer's
// expert stack, the reference's jax.vmap of _dw_kernel over the experts):
// `experts` problems of one shape (B, d_in, n_out, k) in one launch, the
// expert a grid axis of every kernel (y in dw_kernel_bucket, z in
// dw_kernel_mma and dw_kernel_f32). Expert e reads dy + e * B * n_out, x + e
// * B * d_in and idx + e * n_out * k, writes dw + e * n_out * k and has its
// own workspace, ws + e * condensed_matmul_dw_workspace(d_in, n_out, k) (a
// DGroup of element strides). Each block moves its pointers to its expert's
// problem and then runs the one-expert body as it stands, so the grouped
// launch equals E separate launches bitwise. Grouping is a template argument
// (kGrouped): the plain kernels (kGrouped false, kDOne) compile with no
// expert offset.
//
// The kernels allocate nothing and launch on the caller's stream. The
// cp.async, wgmma and fence helpers are in hopper.cuh.
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include "hopper.cuh"

namespace condensed_dw {
namespace {

// ---------------------------------------------------------------- bfloat16

constexpr int kTI = 128;                 // d_in inputs of a tile (MMA M, 64 per warpgroup)
constexpr int kTJ = 128;                 // neurons of a tile (MMA N)
constexpr int kBK = 64;                  // batch rows per ring stage (MMA K)
constexpr int kInflight = 1;             // products left running while the next chunk is awaited
constexpr int kMmaThreads = 256;         // two warpgroups
constexpr int kGStride = kTJ + 4;        // f32 row stride of the staged tile G
constexpr int kGroupRows = kTJ / 8;      // rows of a workspace group: one warp's share of a tile
constexpr int kSlotBits = 25;            // a workspace entry: slot in its group, then index % kTI
constexpr int kMaxBucketSmem = 227 * 1024;  // shared memory a block may opt into
constexpr int kEpilogueLoads = 4;        // workspace entries a lane loads at once in the epilogue

// Element strides between the experts of a grouped launch (see the header
// note); a plain launch passes kDOne, which its kernels never read.
struct DGroup {
  int experts;
  long long dy, x, idx, ws, dw;  // dy (B * n_out), x (B * d_in), idx and dw, workspace
};
constexpr DGroup kDOne = {1, 0, 0, 0, 0, 0};
static_assert(kMmaThreads / 32 * kGroupRows == kTJ, "a warp per group of rows");
// A stage operand (kBK batch rows x 128 columns) as wgmma reads it with the
// 128-byte swizzle, MN-major: two blocks of 64 columns kHalfBytes apart,
// each kBK rows of 128 bytes (8-row atoms of 1024 bytes), the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8).
constexpr int kHalfBytes = kBK * 128;
constexpr int kOperandBytes = 2 * kHalfBytes;
constexpr int kStageBytes = 2 * kOperandBytes;  // x's columns of the tile, then dy's
constexpr int kGBytes = kTI * kGStride * 4;

// Dynamic shared memory of dw_kernel_mma<kStages>: the ring of kStages
// stages, which G reuses, and room to align the ring to 1024 bytes. Three
// stages let two blocks share an SM; four serve one block alone.
template <int kStages>
__host__ __device__ constexpr int mma_smem() {
  return (kStages * kStageBytes > kGBytes ? kStages * kStageBytes : kGBytes) + 1024;
}

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::fence_operands;
using hopper::fence_proxy_async;
using hopper::smem_addr;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_m64n128k16;
using hopper::wgmma_wait;

// The shared-memory descriptor of an operand block at addr (see kHalfBytes).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return hopper::wgmma_desc(addr, kHalfBytes);
}

// One chunk of kBK batch rows of src[:, c0 : c0 + 128] (row stride ld,
// `limit` valid columns, `batch` valid rows) into a stage operand at dst.
// kVec: cp.async of 16 bytes (ld % 8 == 0 and src 16-byte aligned); else
// element loads through registers, zeros past the edges.
template <bool kVec>
__device__ __forceinline__ void load_operand(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                             int b0, int batch, int c0, int limit, int ld) {
  for (int item = threadIdx.x; item < kBK * 16; item += kMmaThreads) {
    const int row = item >> 4;
    const int chunk = item & 15;
    const int b = b0 + row;
    const int col = c0 + chunk * 8;
    const uint32_t to =
        dst + (chunk >> 3) * kHalfBytes + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
    if (kVec) {
      const bool valid = b < batch && col < limit;
      cp_async16(to, valid ? src + static_cast<size_t>(b) * ld + col : src, valid);
    } else {
      uint16_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = b < batch && col + e < limit
                   ? __bfloat16_as_ushort(src[static_cast<size_t>(b) * ld + col + e])
                   : 0;
      }
      const uint4 packed = make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                                      v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16));
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(to), "r"(packed.x),
                   "r"(packed.y), "r"(packed.z), "r"(packed.w));
    }
  }
}

// The row f / k of slot f of a group (f < kGroupRows * k), from a float
// reciprocal of k and one correction: the estimate is off by less than one.
__device__ __forceinline__ int row_of(int f, int k, float rk) {
  const int r = __float2int_rz(__int2float_rn(f) * rk);
  const int rest = f - r * k;
  return r + (rest >= k) - (rest < 0);
}

// Calls visit(index, f) for every slot f < slots of src, kBucketLoads
// 16-byte loads in flight per thread where src is 16-byte aligned.
constexpr int kBucketLoads = 8;

template <typename Visit>
__device__ __forceinline__ void for_each_slot(const int32_t* __restrict__ src, int slots,
                                              Visit visit) {
  const int step = 4 * blockDim.x;
  const int f0 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? slots & ~3 : 0;
  for (int base = 4 * threadIdx.x; base < f0; base += step * kBucketLoads) {
    int4 v[kBucketLoads];
#pragma unroll
    for (int u = 0; u < kBucketLoads; ++u) {
      const int f = base + step * u;
      if (f < f0) v[u] = __ldg(reinterpret_cast<const int4*>(src + f));
    }
#pragma unroll
    for (int u = 0; u < kBucketLoads; ++u) {
      const int f = base + step * u;
      if (f < f0) {
        visit(v[u].x, f);
        visit(v[u].y, f + 1);
        visit(v[u].z, f + 2);
        visit(v[u].w, f + 3);
      }
    }
  }
  for (int f = f0 + threadIdx.x; f < slots; f += blockDim.x) visit(__ldg(src + f), f);
}

// grid: ceil(n_out / kGroupRows) (by the experts, kGrouped); block: 256;
// dynamic shared memory:
// tiles * kGroupRows ints. Group g of kGroupRows rows (their slots f = row *
// k + s, contiguous in idx) gets ws[g] (stride kGroupRows * k + tiles *
// kGroupRows + 1): its slots f | (index % kTI) << kSlotBits grouped into
// cells (tile index / kTI, row), tile-major, then the cells' start offsets
// and the group's slot count. A tile's cells are contiguous: its segment.
// The order inside a cell follows shared-memory atomics and may vary.
template <bool kGrouped>
__global__ void __launch_bounds__(256)
dw_kernel_bucket(const int32_t* __restrict__ idx, int32_t* __restrict__ ws, int n_out, int k,
                 int tiles, DGroup grp) {
  extern __shared__ int cursor[];
  if constexpr (kGrouped) {  // expert blockIdx.y
    idx += blockIdx.y * grp.idx;
    ws += blockIdx.y * grp.ws;
  }
  // dw_kernel_mma may start now: it reads ws only after griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int lane = threadIdx.x & 31;
  const int cells = tiles * kGroupRows;
  const int r0 = blockIdx.x * kGroupRows;
  const int slots = min(kGroupRows, n_out - r0) * k;
  const float rk = 1.f / k;
  const int32_t* src = idx + static_cast<size_t>(r0) * k;
  int32_t* out = ws + static_cast<size_t>(blockIdx.x) * (kGroupRows * k + cells + 1);
  int32_t* starts = out + kGroupRows * k;
  auto cell = [&](int v, int f) { return v / kTI * kGroupRows + row_of(f, k, rk); };
  for (int c = threadIdx.x; c < cells; c += blockDim.x) cursor[c] = 0;
  __syncthreads();
  for_each_slot(src, slots, [&](int v, int f) { atomicAdd(cursor + cell(v, f), 1); });
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive prefix sum over the cells, 32 at a time
    int carry = 0;
    for (int c0 = 0; c0 < cells; c0 += 32) {
      const int c = c0 + lane;
      const int n = c < cells ? cursor[c] : 0;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int m = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += m;
      }
      if (c < cells) cursor[c] = starts[c] = carry + incl - n;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) starts[cells] = slots;
  }
  __syncthreads();
  for_each_slot(src, slots, [&](int v, int f) {
    const uint32_t entry = static_cast<uint32_t>(f) | static_cast<uint32_t>(v % kTI) << kSlotBits;
    out[atomicAdd(cursor + cell(v, f), 1)] = static_cast<int32_t>(entry);
  });
}

// grid: (ceil(n_out / kTJ), ceil(d_in / kTI), experts); block: kMmaThreads; dynamic
// shared memory mma_smem<kStages>(). Block (bj, t) owns the tile of neurons
// [bj * kTJ, +kTJ) and inputs [t * kTI, +kTI); ws is dw_kernel_bucket's
// workspace. Warpgroup w computes rows [64 w, +64) of G.
template <int kStages, bool kVecX, bool kVecD, bool kGrouped>
__global__ void __launch_bounds__(kMmaThreads, kStages <= 3 ? 2 : 1)
dw_kernel_mma(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
              const int32_t* __restrict__ ws, float* __restrict__ dw, int batch, int d_in,
              int n_out, int k, DGroup grp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kGrouped) {  // expert blockIdx.z
    dy += blockIdx.z * grp.dy;
    x += blockIdx.z * grp.x;
    ws += blockIdx.z * grp.ws;
    dw += blockIdx.z * grp.dw;
  }
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;  // the swizzle atoms' alignment
  float* g = reinterpret_cast<float*>(smem_raw + (ring - base));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n0 = blockIdx.x * kTJ;
  const int t = blockIdx.y;
  const int i0 = t * kTI;
  const int tiles = gridDim.y;
  const int chunks = (batch + kBK - 1) / kBK;
  const int rows = min(kTJ, n_out - n0);
  const int ws_stride = kGroupRows * k + tiles * kGroupRows + 1;
  const float rk = 1.f / k;
  constexpr int kAhead = kStages - 1 - kInflight;  // chunks loaded ahead of the one computed

  auto load_chunk = [&](int c) {
    const uint32_t stage = ring + (c % kStages) * kStageBytes;
    load_operand<kVecX>(stage, x, c * kBK, batch, i0, d_in, d_in);
    load_operand<kVecD>(stage + kOperandBytes, dy, c * kBK, batch, n0, n_out, n_out);
  };

#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < chunks) load_chunk(c);
    cp_async_commit();
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kAhead - 1>();
    // this thread's copies of chunk c are done: make them visible to the
    // tensor cores' (async proxy) reads, then wait for every thread's.
    // Past the barrier every warpgroup has also waited for the product
    // of chunk c - 1 - kInflight, whose stage the next load reuses.
    fence_proxy_async();
    __syncthreads();
    if (c + kAhead < chunks) load_chunk(c + kAhead);
    cp_async_commit();
    const uint32_t sx = ring + (c % kStages) * kStageBytes + wg * kHalfBytes;
    const uint32_t sd = ring + (c % kStages) * kStageBytes + kOperandBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)  // 16 batch rows: two 8-row atoms
      wgmma_m64n128k16(acc, wgmma_desc(sx + ks * 2048), wgmma_desc(sd + ks * 2048));
    wgmma_commit();
    wgmma_wait<kInflight>();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Warp w takes the slots of rows [n0 + 16 w, +16) whose index lies in
  // this tile: their group's segment t of ws, contiguous. ws comes from
  // dw_kernel_bucket, launched just before this kernel, which may still run
  // (a programmatic dependent launch): wait until it is complete, then
  // fetch the segment's bounds while G is stored.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const bool has_group = warp * kGroupRows < rows;
  const int32_t* wgp = ws + static_cast<size_t>(n0 / kGroupRows + warp) * ws_stride;
  // ld.global.cg, never the read-only path: ws was written while this
  // kernel ran
  const int32_t* cell_starts = wgp + kGroupRows * k + t * kGroupRows;
  const int q0 = has_group ? __ldcg(cell_starts) : 0;
  const int end = has_group ? __ldcg(cell_starts + kGroupRows) : 0;
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: G takes its place

  // the accumulators: row 64 wg + 16 (warp % 4) + lane / 4 (and + 8),
  // columns 8 j + 2 (lane % 4) + {0, 1} for j = 0 .. 15
  {
    const int i = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(g + i * kGStride + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(g + (i + 8) * kGStride + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();

  float* dg = dw + static_cast<size_t>(n0 + warp * kGroupRows) * k;
  for (int q = q0 + lane; q < end; q += 32 * kEpilogueLoads) {
    uint32_t e[kEpilogueLoads];  // every load issued before the first store
#pragma unroll
    for (int u = 0; u < kEpilogueLoads; ++u)
      e[u] = q + 32 * u < end ? static_cast<uint32_t>(__ldcg(wgp + q + 32 * u)) : 0u;
#pragma unroll
    for (int u = 0; u < kEpilogueLoads; ++u) {
      if (q + 32 * u < end) {
        const int f = static_cast<int>(e[u] & ((1u << kSlotBits) - 1));
        dg[f] = g[(e[u] >> kSlotBits) * kGStride + warp * kGroupRows + row_of(f, k, rk)];
      }
    }
  }
}

// ----------------------------------------------------------------- float32

constexpr int kF32Threads = 256;       // a warp per group of kGroupRows rows
constexpr int kF32BK = 32;             // batch rows per staged chunk
constexpr int kF32Stride = kF32BK + 4; // f32 stride of a staged column: its 16-byte groups
                                       // fall on all eight 16-byte bank groups
constexpr int kF32Entries = 12;        // workspace entries per lane and pass
static_assert(kF32Threads / 32 * kGroupRows == kTJ, "a warp per group of rows");
static_assert(kTI * kF32Stride < (1 << 15) && kTJ * kF32Stride < (1 << 15), "offsets in 15 bits");
static_assert(kTI * kF32BK == 16 * kF32Threads && kTJ * kF32BK == 16 * kF32Threads,
              "a 4 x 4 block of each operand per thread and chunk");

// Rows [b0, b0 + kF32BK) of src[:, c0 : c0 + 128] (row stride ld, `limit`
// valid columns, `batch` valid rows) into dst transposed: column c at dst +
// c * kF32Stride, its kF32BK rows side by side, zeros past the edges. A
// thread moves one 4 x 4 block: four 16-byte loads where the columns allow
// (vec: ld % 4 == 0 and src 16-byte aligned), four 16-byte stores.
__device__ __forceinline__ void stage_f32(float* __restrict__ dst, const float* __restrict__ src,
                                          int b0, int batch, int c0, int limit, int ld, bool vec) {
  const int rb = threadIdx.x & 7;   // rows 4 rb .. 4 rb + 3
  const int cb = threadIdx.x >> 3;  // columns 4 cb .. 4 cb + 3
  const int col = c0 + 4 * cb;
  float v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * rb + r;
    const float* row = src + static_cast<size_t>(b) * ld + col;
    if (b < batch && vec && col + 4 <= limit) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row));
      v[r][0] = q.x;
      v[r][1] = q.y;
      v[r][2] = q.z;
      v[r][3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = b < batch && col + c < limit ? __ldg(row + c) : 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(dst + (4 * cb + c) * kF32Stride + 4 * rb) =
        make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
}

// grid: (ceil(n_out / kTJ), ceil(d_in / kTI), experts); block: kF32Threads. Block
// (bj, t) owns the tile of neurons [bj * kTJ, +kTJ) and inputs [t * kTI,
// +kTI), as dw_kernel_mma, and ws is dw_kernel_bucket's workspace, complete
// before this kernel starts (an ordinary launch). Warp w takes group w's
// segment for tile t, its entries ordered by row: lane l a contiguous run of
// ceil(entries / 32), up to kF32Entries of them per pass (more passes where
// the segment is longer), adding every batch row into each in order.
template <bool kGrouped>
__global__ void __launch_bounds__(kF32Threads, 3)
dw_kernel_f32(const float* __restrict__ dy, const float* __restrict__ x,
              const int32_t* __restrict__ ws, float* __restrict__ dw, int batch, int d_in,
              int n_out, int k, DGroup grp) {
  __shared__ __align__(16) float xs[kTI * kF32Stride];
  __shared__ __align__(16) float ds[kTJ * kF32Stride];
  __shared__ int passes;
  if constexpr (kGrouped) {  // expert blockIdx.z
    dy += blockIdx.z * grp.dy;
    x += blockIdx.z * grp.x;
    ws += blockIdx.z * grp.ws;
    dw += blockIdx.z * grp.dw;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kTJ;
  const int t = blockIdx.y;
  const int i0 = t * kTI;
  const int ws_stride = kGroupRows * k + gridDim.y * kGroupRows + 1;
  const float rk = 1.f / k;
  const bool has_group = warp * kGroupRows < min(kTJ, n_out - n0);
  const int32_t* wgp = ws + static_cast<size_t>(n0 / kGroupRows + warp) * ws_stride;
  const int32_t* seg = wgp + kGroupRows * k + t * kGroupRows;  // the tile's first cell
  const int s0 = has_group ? __ldg(seg) : 0;
  const int s1 = has_group ? __ldg(seg + kGroupRows) : 0;
  const int run = (s1 - s0 + 31) / 32;  // entries per lane
  const int q0 = s0 + lane * run;
  const int end = min(s1, q0 + run);
  const bool vx = d_in % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vd = n_out % 4 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  float* dg = dw + static_cast<size_t>(n0 + warp * kGroupRows) * k;

  if (threadIdx.x == 0) passes = 0;
  __syncthreads();
  if (lane == 0 && run > 0) atomicMax(&passes, (run + kF32Entries - 1) / kF32Entries);
  __syncthreads();
  const int count = passes;

  for (int p = 0; p < count; ++p) {
    const int qp = q0 + kF32Entries * p;
    // an entry's columns of x and dy in shared memory (f32 offsets below
    // 2^15): x's | dy's << 16; -1 past the run, and then for every later entry
    int code[kF32Entries];
    float acc[kF32Entries];
#pragma unroll
    for (int j = 0; j < kF32Entries; ++j) {
      const int q = qp + j;
      code[j] = -1;
      if (q < end) {
        const uint32_t e = static_cast<uint32_t>(__ldg(wgp + q));
        const int f = static_cast<int>(e & ((1u << kSlotBits) - 1));
        code[j] = static_cast<int>(e >> kSlotBits) * kF32Stride |
                  ((warp * kGroupRows + row_of(f, k, rk)) * kF32Stride) << 16;
      }
      acc[j] = 0.f;
    }
    for (int b0 = 0; b0 < batch; b0 += kF32BK) {
      __syncthreads();  // every warp is done with the previous chunk
      stage_f32(xs, x, b0, batch, i0, d_in, d_in, vx);
      stage_f32(ds, dy, b0, batch, n0, n_out, n_out, vd);
      __syncthreads();
#pragma unroll
      for (int b = 0; b < kF32BK; b += 4) {  // rows past the batch are zeros: add 0
        float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kF32Entries; ++j) {
          const int c = code[j];
          if (c >= 0) {
            // a run holds few rows, in order: dy is read where the row changes
            if (j == 0 || (c >> 16) != (code[j > 0 ? j - 1 : 0] >> 16))
              dv = *reinterpret_cast<const float4*>(ds + (c >> 16) + b);
            const float4 xv = *reinterpret_cast<const float4*>(xs + (c & 0xffff) + b);
            float a = acc[j];
            a = fmaf(dv.x, xv.x, a);
            a = fmaf(dv.y, xv.y, a);
            a = fmaf(dv.z, xv.z, a);
            a = fmaf(dv.w, xv.w, a);
            acc[j] = a;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kF32Entries; ++j) {
      const int q = qp + j;
      if (q < end) dg[__ldg(wgp + q) & ((1 << kSlotBits) - 1)] = acc[j];
    }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted_in) {
  // above the 48 KB default once per instantiation and size
  if (smem <= opted_in) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) opted_in = smem;
  return err;
}

template <int kStages, bool kVecX, bool kVecD, bool kGrouped>
cudaError_t launch_mma(const void* dy, const void* x, const int32_t* ws, float* dw, int batch,
                       int d_in, int n_out, int k, const DGroup& grp, cudaStream_t stream) {
  auto kernel = dw_kernel_mma<kStages, kVecX, kVecD, kGrouped>;
  constexpr int smem = mma_smem<kStages>();
  static size_t opted_in = 48 * 1024;
  cudaError_t err = opt_in(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  // a programmatic dependent launch: the tile products overlap
  // dw_kernel_bucket, and each epilogue waits for its workspace
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n_out + kTJ - 1) / kTJ, (d_in + kTI - 1) / kTI, grp.experts);
  config.blockDim = dim3(kMmaThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const __nv_bfloat16*>(dy),
                            static_cast<const __nv_bfloat16*>(x), ws, dw, batch, d_in, n_out, k,
                            grp);
}

template <int kStages, bool kGrouped>
cudaError_t dispatch_mma(bool vx, bool vd, const void* dy, const void* x, const int32_t* ws,
                         float* dw, int batch, int d_in, int n_out, int k, const DGroup& grp,
                         cudaStream_t s) {
  if (vx && vd)
    return launch_mma<kStages, true, true, kGrouped>(dy, x, ws, dw, batch, d_in, n_out, k, grp, s);
  if (vx)
    return launch_mma<kStages, true, false, kGrouped>(dy, x, ws, dw, batch, d_in, n_out, k, grp,
                                                      s);
  if (vd)
    return launch_mma<kStages, false, true, kGrouped>(dy, x, ws, dw, batch, d_in, n_out, k, grp,
                                                      s);
  return launch_mma<kStages, false, false, kGrouped>(dy, x, ws, dw, batch, d_in, n_out, k, grp,
                                                     s);
}

// The bucket kernel, then a block per 128 x 128 tile (an expert's, grp):
// the launches of condensed_matmul_dw (see its note), checked by the caller.
template <bool kGrouped>
cudaError_t dw_launch(const void* dy, const void* x, const void* indices, void* dw,
                      int32_t* ws, int batch, int d_in, int n_out, int k, int dtype, int stages,
                      const DGroup& grp, cudaStream_t s) {
  const int tiles = (d_in + kTI - 1) / kTI;
  const size_t bucket_smem = static_cast<size_t>(tiles) * kGroupRows * sizeof(int);
  static size_t bucket_opted_in = 48 * 1024;
  cudaError_t err = opt_in(dw_kernel_bucket<kGrouped>, bucket_smem, bucket_opted_in);
  // the bucket kernel needs little shared memory; asking for the most keeps
  // the SMs it runs on ready for dw_kernel_mma's blocks beside it
  static const cudaError_t carved = cudaFuncSetAttribute(
      dw_kernel_bucket<kGrouped>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = carved;
  if (err != cudaSuccess) return err;
  dw_kernel_bucket<kGrouped>
      <<<dim3((n_out + kGroupRows - 1) / kGroupRows, grp.experts), 256, bucket_smem, s>>>(
          static_cast<const int32_t*>(indices), ws, n_out, k, tiles, grp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto out = static_cast<float*>(dw);
  if (dtype == 0) {
    const dim3 grid((n_out + kTJ - 1) / kTJ, tiles, grp.experts);
    dw_kernel_f32<kGrouped><<<grid, kF32Threads, 0, s>>>(static_cast<const float*>(dy),
                                                         static_cast<const float*>(x), ws, out,
                                                         batch, d_in, n_out, k, grp);
    return cudaGetLastError();
  }
  const bool vx = d_in % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vd = n_out % 8 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  if (stages == 4)
    return dispatch_mma<4, kGrouped>(vx, vd, dy, x, ws, out, batch, d_in, n_out, k, grp, s);
  return dispatch_mma<3, kGrouped>(vx, vd, dy, x, ws, out, batch, d_in, n_out, k, grp, s);
}

}  // namespace
}  // namespace condensed_dw

extern "C" {

// The int32 workspace condensed_matmul_dw needs at these shapes, which the
// launches check the caller's against (the Python wrapper sizes it with
// dw_workspace_ints): for each group of 16 rows, its 16 * k slots grouped
// by (d_in tile, row), then the 16 T + 1 cells' offsets (T = ceil(d_in /
// 128)). 0 where the kernels do not take the shapes: an entry holds a slot
// of its group in 25 bits (k < 2^21), and the bucket kernel counts the
// cells in shared memory (T <= 3632).
long long condensed_matmul_dw_workspace(int d_in, int n_out, int k) {
  using namespace condensed_dw;
  if (d_in <= 0 || n_out <= 0 || k <= 0 || k >= (1 << kSlotBits) / kGroupRows) return 0;
  const long long tiles = (d_in + kTI - 1) / kTI;
  if (tiles * kGroupRows * sizeof(int) > kMaxBucketSmem) return 0;
  return static_cast<long long>((n_out + kGroupRows - 1) / kGroupRows) *
         (kGroupRows * k + tiles * kGroupRows + 1);
}

// What one launch takes, as condensed_matmul_dw_workspace checks it: at
// most *max_slots slots a row and *max_inputs d_in inputs.
void condensed_matmul_dw_limits(int* max_slots, int* max_inputs) {
  using namespace condensed_dw;
  *max_slots = (1 << kSlotBits) / kGroupRows - 1;
  *max_inputs = static_cast<int>(kMaxBucketSmem / (kGroupRows * sizeof(int))) * kTI;
}

// dtype: 0 = float32 (the CUDA-core path), 1 = bfloat16 (the tensor-core
// path, with stages 3 for two blocks per SM or 4 for one). Both launch
// dw_kernel_bucket into workspace (workspace_ints of int32, at least
// condensed_matmul_dw_workspace's), then a block per 128 x 128 tile. dw:
// n_out * k float32. Returns the cudaError_t of the launches (0 = success).
int condensed_matmul_dw(const void* dy, const void* x, const void* indices, void* dw,
                        void* workspace, long long workspace_ints, int batch, int d_in,
                        int n_out, int k, int dtype, int stages, void* stream) {
  using namespace condensed_dw;
  const long long need = condensed_matmul_dw_workspace(d_in, n_out, k);
  if (batch <= 0 || need == 0 || workspace == nullptr || workspace_ints < need ||
      (dtype == 1 && stages != 3 && stages != 4) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  return dw_launch<false>(dy, x, indices, dw, static_cast<int32_t*>(workspace), batch, d_in,
                         n_out, k, dtype, stages, kDOne, static_cast<cudaStream_t>(stream));
}

// K3-moe: condensed_matmul_dw over `experts` problems of one shape stored one
// after another: dy (experts, batch, n_out), x (experts, batch, d_in),
// indices and dw (experts, n_out, k); workspace: workspace_ints of int32, at
// least experts * condensed_matmul_dw_workspace(d_in, n_out, k), an expert's
// slice each. dtype and stages as there, one expert's. Returns the
// cudaError_t of the launches (0 = success).
int condensed_matmul_dw_grouped(const void* dy, const void* x, const void* indices, void* dw,
                                void* workspace, long long workspace_ints, int experts,
                                int batch, int d_in, int n_out, int k, int dtype, int stages,
                                void* stream) {
  using namespace condensed_dw;
  const long long need = condensed_matmul_dw_workspace(d_in, n_out, k);
  if (experts <= 0 || experts > 65535 || batch <= 0 || need == 0 || workspace == nullptr ||
      workspace_ints < experts * need || (dtype == 1 && stages != 3 && stages != 4) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const DGroup grp = {experts, static_cast<long long>(batch) * n_out,
                      static_cast<long long>(batch) * d_in, static_cast<long long>(n_out) * k,
                      need, static_cast<long long>(n_out) * k};
  return dw_launch<true>(dy, x, indices, dw, static_cast<int32_t*>(workspace), batch, d_in,
                         n_out, k, dtype, stages, grp, static_cast<cudaStream_t>(stream));
}

const char* condensed_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
