// Kernel K2: masked Hamming top-2 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sivo_tpu/ops/pallas_match.py::_kernel.
// See sivo_tpu_torch/ops/kernel_match.py for the semantics, the bound on
// the H100 and the measurements behind this design;
// masked_hamming_top2_plain there is the plain PyTorch version this
// kernel must equal bit for bit.
//
// Distances on the tensor cores. One mma.m16n8k256 .b1 .and.popc gives
// popc(a & b) for a 16-row x 8-column block of descriptor pairs, and
// Hamming = popc(a) + popc(b) - 2 popc(a & b); the two single popcounts
// come from the same instruction against an all-ones operand. A warp
// holds 16 rows as the mma's A fragment (and their windows, level
// ranges and running top-2s, two rows per thread) and walks 8-column
// blocks. The window test then runs on the CUDA cores for the four
// pairs each thread holds.
//
// Layout. A CTA owns 32 rows: 2 row warps x 4 column warps, each column
// warp taking a quarter of every column tile. A cluster of 4 CTAs shares
// one 32-row tile and splits its columns: CTA `rank` scans column tiles
// rank, rank + 4, ... Each tile (descriptors and five attributes of 128
// columns) comes through a two-stage cp.async ring, so the next tile is
// in flight while the current one is scanned. At N = M = 2048 that is
// 256 CTAs of 8 warps, one wave at 3 CTAs per SM, each CTA reading its
// 512 columns once from L2 for 32 rows.
//
// Work. A warp none of whose 16 rows is valid scans nothing; on the main
// path most rows are map points or keypoints without a point, and are
// invalid. Each thread of a live warp tests the window of its four pairs
// of an 8-column block; only where a pair in the warp passes (a warp
// vote) does the warp load the block's descriptors, run the two mma and
// update the top-2 keys. The windowed searches pass few pairs, so most
// blocks cost only the window tests.
//
// Order. A candidate is one 32-bit key, distance << 23 | column index,
// and a masked pair is 0xffffffff. Keys order pairs by (distance, index),
// a total order, so the top-2 of any split of the columns, merged in any
// order (threads by shuffles, warps through shared memory, CTAs through
// distributed shared memory), equals a serial scan's with first-index
// ties. Masked rows come out as (inf, index 0), and a row with one
// candidate as second (inf, 0), as the plain version's argmins give.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowWarps = 2;                 // 16-row groups per CTA
constexpr int kColWarps = 4;                 // warps splitting a tile
constexpr int kWarps = kRowWarps * kColWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kCtaRows = 16 * kRowWarps;     // rows per CTA (one row tile)
constexpr int kCluster = 4;                  // CTAs splitting the columns
constexpr int kTile = 128;                   // columns per ring stage
constexpr int kWarpCols = kTile / kColWarps; // columns per warp per tile
constexpr int kIndexBits = 23;               // the wrapper keeps m below 2^23
constexpr unsigned kIndexMask = (1u << kIndexBits) - 1u;
constexpr unsigned kNone = 0xffffffffu;      // key of a masked pair

struct Stage {
  uint32_t desc[2][kTile][4];  // [half][column][word]: words 0-3, 4-7
  float attr[5][kTile];        // x, y, ur, level, valid
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying columns [c0, c0 + cnt) into a stage: descriptors in
// 16-byte pieces; attribute rows in 16-byte pieces where (8, m) keeps
// them aligned, else element by element.
__device__ __forceinline__ void load_tile(Stage& st, const uint4* b,
                                          const float* col_attr, int m,
                                          int c0, int cnt) {
  for (int i = threadIdx.x; i < 2 * cnt; i += kThreads) {
    cp_async16(&st.desc[i & 1][i >> 1][0], b + 2 * (size_t)c0 + i);
  }
  if ((m & 3) == 0 && ((uintptr_t)col_attr & 15) == 0) {
    const int q = (cnt + 3) >> 2;  // cnt is a multiple of 4 here
    for (int i = threadIdx.x; i < 5 * q; i += kThreads) {
      const int k = i / q, c = 4 * (i - k * q);
      cp_async16(&st.attr[k][c], col_attr + (size_t)k * m + c0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < 5 * cnt; i += kThreads) {
      const int k = i / cnt, c = i - k * cnt;
      cp_async4(&st.attr[k][c], col_attr + (size_t)k * m + c0 + c);
    }
  }
}

// d[i] = popc(a & b) over 256 bits for the fragment's four (row, col)
// pairs: d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// (k1, k2) <- the two smallest of {k1, k2, o1, o2}, given k1 < k2 and
// o1 < o2 (or equal sentinels); keys are otherwise distinct.
__device__ __forceinline__ void merge2(unsigned& k1, unsigned& k2,
                                       unsigned o1, unsigned o2) {
  k2 = min(max(k1, o1), min(k2, o2));
  k1 = min(k1, o1);
}

template <bool kUseUr>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
hamming_top2_kernel(const uint32_t* __restrict__ a,      // (n, 8) words
                    const uint4* __restrict__ b,         // (m, 2) x 16 B
                    const float4* __restrict__ row_attr,  // (n, 2) x float4
                    const float* __restrict__ col_attr,  // (8, m)
                    float* __restrict__ best_d, float* __restrict__ second_d,
                    int* __restrict__ best_j, int* __restrict__ second_j,
                    int n, int m) {
  __shared__ Stage stages[2];
  __shared__ uint2 part[kColWarps][kCtaRows];  // per column warp
  __shared__ uint2 cta_part[kCtaRows];         // this CTA's columns

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * kCtaRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_warp = warp % kRowWarps, col_warp = warp / kRowWarps;

  // rows g and g + 8 of this warp's 16: A fragment words, windows, top-2
  unsigned af[4];
  float u[2], v[2], r_ur[2], rad[2], lo[2], hi[2];
  unsigned k1[2], k2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * row_warp + g + 8 * h;
    k1[h] = k2[h] = kNone;
    af[h] = af[2 + h] = 0u;
    u[h] = NAN;  // |x - NaN| <= r is false: rows past n match nothing
    v[h] = r_ur[h] = rad[h] = lo[h] = hi[h] = 0.f;
    if (row < n) {
      af[h] = a[8 * (size_t)row + tq];
      af[2 + h] = a[8 * (size_t)row + 4 + tq];
      const float4 ra = row_attr[2 * (size_t)row];
      const float4 rb = row_attr[2 * (size_t)row + 1];
      u[h] = rb.z > 0.5f ? ra.x : NAN;  // an invalid row matches nothing
      v[h] = ra.y;
      r_ur[h] = ra.z;
      rad[h] = ra.w;
      lo[h] = rb.x;
      hi[h] = rb.y;
    }
  }
  const unsigned ones[4] = {~0u, ~0u, ~0u, ~0u};
  int pa[4];  // pa[0] = popc(row g), pa[2] = popc(row g + 8)
  mma_and_popc(pa, af, ~0u, ~0u);
  // a warp whose rows are all invalid (or past n) matches nothing
  const bool live =
      __any_sync(0xffffffffu, (u[0] == u[0]) | (u[1] == u[1]));

  const int ntiles = (m + kTile - 1) / kTile;
  int t = rank;
  if (t < ntiles) {
    load_tile(stages[0], b, col_attr, m, t * kTile, min(kTile, m - t * kTile));
  }
  cp_async_commit();
  for (int s = 0; t < ntiles; t += kCluster, s ^= 1) {
    const int next = t + kCluster;
    if (next < ntiles) {
      load_tile(stages[s ^ 1], b, col_attr, m, next * kTile,
                min(kTile, m - next * kTile));
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const Stage& st = stages[s];
    const int c0 = t * kTile;
    const int cnt = min(kTile, m - c0);
    if (live) {
#pragma unroll
      for (int blk = 0; blk < kWarpCols; blk += 8) {
        const int cb = col_warp * kWarpCols + blk;  // block start in the tile
        if (cb >= cnt) break;  // warp-uniform: the mma needs the whole warp
        const int cc = cb + 2 * tq;  // this thread's columns cc, cc + 1
        const float2 xs = *reinterpret_cast<const float2*>(&st.attr[0][cc]);
        const float2 ys = *reinterpret_cast<const float2*>(&st.attr[1][cc]);
        const float2 urs = *reinterpret_cast<const float2*>(&st.attr[2][cc]);
        const float2 ls = *reinterpret_cast<const float2*>(&st.attr[3][cc]);
        const float2 vs = *reinterpret_cast<const float2*>(&st.attr[4][cc]);
        bool ok[2][2];  // [row h][column e]
        bool any = false;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a column past m or invalid matches nothing: its x becomes NaN
          const bool col_ok = cc + e < cnt && (e ? vs.y : vs.x) > 0.5f;
          const float x = col_ok ? (e ? xs.y : xs.x) : NAN;
          const float y = e ? ys.y : ys.x;
          const float cur = e ? urs.y : urs.x;
          const float lvl = e ? ls.y : ls.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bool p = (fabsf(x - u[h]) <= rad[h]) & (fabsf(y - v[h]) <= rad[h]) &
                     (lvl >= lo[h]) & (lvl <= hi[h]);
            if (kUseUr) {
              p = p & ((cur <= 0.f) | (fabsf(r_ur[h] - cur) <= rad[h]));
            }
            ok[h][e] = p;
            any |= p;
          }
        }
        // distances only for blocks where some pair passes (warp-uniform)
        if (!__any_sync(0xffffffffu, any)) continue;
        const unsigned b0 = st.desc[0][cb + g][tq];
        const unsigned b1 = st.desc[1][cb + g][tq];
        int d[4], pb[4];  // pb[0] = popc(column 2t), pb[1] = popc(2t + 1)
        mma_and_popc(d, af, b0, b1);
        mma_and_popc(pb, ones, b0, b1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned j = (unsigned)(c0 + cc + e);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned dist =
                (unsigned)(pa[2 * h] + pb[e] - 2 * d[2 * h + e]);
            const unsigned key = ok[h][e] ? ((dist << kIndexBits) | j) : kNone;
            k2[h] = min(k2[h], max(k1[h], key));
            k1[h] = min(k1[h], key);
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled on the next iteration
  }

  // threads -> warp: the four threads of a group hold the same two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1[h], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2[h], off);
      merge2(k1[h], k2[h], o1, o2);
    }
  }
  if (tq == 0) {
    part[col_warp][16 * row_warp + g] = make_uint2(k1[0], k2[0]);
    part[col_warp][16 * row_warp + g + 8] = make_uint2(k1[1], k2[1]);
  }
  __syncthreads();
  // warps -> CTA
  for (int i = threadIdx.x; i < kCtaRows; i += kThreads) {
    unsigned b1 = kNone, b2 = kNone;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) merge2(b1, b2, part[w][i].x, part[w][i].y);
    cta_part[i] = make_uint2(b1, b2);
  }

  // CTAs -> cluster: rank q finalizes the rows i with i % kCluster == q,
  // reading every rank's partial through distributed shared memory
  cluster.sync();
  for (int i = threadIdx.x; i < kCtaRows; i += kThreads) {
    const int row = row0 + i;
    if (i % kCluster != rank || row >= n) continue;
    unsigned b1 = kNone, b2 = kNone;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      const uint2 p = cluster.map_shared_rank(cta_part, q)[i];
      merge2(b1, b2, p.x, p.y);
    }
    best_d[row] = b1 == kNone ? INFINITY : (float)(b1 >> kIndexBits);
    best_j[row] = b1 == kNone ? 0 : (int)(b1 & kIndexMask);
    second_d[row] = b2 == kNone ? INFINITY : (float)(b2 >> kIndexBits);
    second_j[row] = b2 == kNone ? 0 : (int)(b2 & kIndexMask);
  }
  cluster.sync();  // keep cta_part[] alive until every rank has read it
}

}  // namespace

// a: (n, 32) uint8, b: (m, 32) uint8, row_attr: (n, 8) float32 [u, v,
// ur, radius, lvl_lo, lvl_hi, valid, _], all 16-byte aligned; col_attr:
// (8, m) float32 [x, y, ur, level, valid, ...]; outputs (n,) float32 x2
// and (n,) int32 x2; m < 2^23. Returns the CUDA error code of the launch.
extern "C" int sivo_hamming_top2(const void* a, const void* b,
                                 const void* row_attr, const void* col_attr,
                                 void* best_d, void* second_d, void* best_j,
                                 void* second_j, int n, int m, int use_ur,
                                 void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kCtaRows - 1) / kCtaRows * kCluster);
  const cudaStream_t s = (cudaStream_t)stream;
  if (use_ur) {
    hamming_top2_kernel<true><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)a, (const uint4*)b, (const float4*)row_attr,
        (const float*)col_attr, (float*)best_d, (float*)second_d,
        (int*)best_j, (int*)second_j, n, m);
  } else {
    hamming_top2_kernel<false><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)a, (const uint4*)b, (const float4*)row_attr,
        (const float*)col_attr, (float*)best_d, (float*)second_d,
        (int*)best_j, (int*)second_j, n, m);
  }
  return (int)cudaGetLastError();
}
