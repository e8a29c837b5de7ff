// Kernels B1 and B2: the batched rank-windowed splay descent over the
// level-array plane; kernel B5: the seed baseline's full-width count.
//
// B1 splay_search_tiered replaces the Pallas _kernel_tiered
// (src/repro/kernels/splay_search.py:272).  One thread per query, one
// block per query block; the row loop runs inside the kernel (the TPU
// grid's sequential level axis).  In each row the thread binary-searches
// its inherited window [lo, hi), notes the first hit, and narrows the
// next row's window through rank_map[r, p] .. rank_map[r, p + 1].
// Bound: latency.  Each probe is a dependent load, L * log2(W) of them
// per query; keys and rank_map are read straight from global memory
// through L2 (the hot top rows stay cached), and one thread per query
// keeps enough independent chains in flight to hide part of it.
//
// B2 splay_search_pipelined replaces the Pallas _kernel_pipelined
// (src/repro/kernels/splay_search.py:480).  One block of QB threads per
// query block computes the same triple plus the reference's per-block
// issue-time byte counter: a block-wide reduction gives the unresolved
// lanes' union window, every thread derives the tile cover and the
// foresight bound of row r+1 through row r's rank map (block-uniform),
// thread 0 accumulates 3 * nt * tile * 4 bytes per issued row, and a
// block-wide vote ends the row loop once every lane has resolved (a hit
// answered through bot_rank, or a width-1 bottom-row projection).
// Bound: latency, as B1.  This first version reads the covered tiles
// straight from global memory instead of staging them in shared memory
// (2 slots x 3 arrays x W x 4 B is 393 KB at W = 16384, over the 227 KB
// a block may hold), so the byte counter is the reference's issue-time
// model, not bytes this kernel moved.  cp.async/TMA staging is later
// work.
//
// B5 splay_search_full replaces the Pallas _kernel_full
// (src/repro/kernels/splay_search.py:1284), the seed baseline.  The TPU
// kernel holds the whole [L, W] matrix as one VMEM block and compares a
// query block against each row at once.  Bound: operations, a compare
// and an add for every element of every row the reference runs, per
// query.  Here the width is spread over a thread-block cluster so that
// the whole card counts: each tile of kFullTile queries runs on a
// cluster of S CTAs (S <= 8, the portable size), and CTA s owns columns
// [s * slice, (s + 1) * slice) of every row (the last slice ragged).  A
// CTA stages its slice in dynamic shared memory, by TMA bulk copies (one
// per row, all completing on one mbarrier) when rows are 16-byte
// aligned, else by plain loads; a slice of more rows than fit goes in
// panels of rows (or of columns), one after the other.  Each thread
// holds kFullR queries in registers, so one 16-byte shared load feeds
// 4 x kFullR compares; 16 threads share a query group and split the
// columns, and their partial counts meet in shared memory [L, tile].
// The cluster then reduces the partial counts into the leader CTA
// through distributed shared memory (a cluster.sync to publish them and
// one to keep them alive while the leader reads), and the leader
// resolves each query top-down: hit = cnt > 0 && row[cnt - 1] == q
// (row read from the L2-resident plane), level_found = the first row
// with a hit, rank = the bottom row's cnt - 1.  The wrapper picks S,
// the slice and the panel (splay_search.py full_plan).
//
// The skip rule is dropped: the reference skips a row when every lane
// of its query block is found, which changes the work but never the
// outputs (once a lane is found later hits change nothing, and the
// bottom row always runs), so this kernel counts every row of every
// tile.  The bound in chip_smoke.py keeps counting the compares that
// the reference's rule runs.
//
// B1 and B2 keep the reference's arithmetic: (lo + hi) / 2 probes
// (lo + hi >= 0 whenever a lane is active, so truncation equals floor),
// clamped reads, and an explicit floor division in the cover, where the
// reference floors a negative quotient and C would truncate it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// tile-aligned cover [base, base + nt * tile) of the window [l, h]
__device__ __forceinline__ void cover(int l, int h, int W, int tile,
                                      int& base, int& nt) {
  base = (clampi(l, 0, W - 1) / tile) * tile;
  const int end = clampi(h, 0, W - 1);
  nt = max(-floordiv(base - (end + 1), tile), 1);
}

__global__ void tiered_kernel(const int* __restrict__ keys,
                              const int* __restrict__ rank_map,
                              const int* __restrict__ widths,
                              const int* __restrict__ queries, int L,
                              int W, int nq, bool* __restrict__ found_out,
                              int* __restrict__ rank_out,
                              int* __restrict__ level_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int q = queries[i];
  int lo = -1, hi = widths[0], p = -1, level = L;
  bool found = false;
  for (int r = 0; r < L; ++r) {
    const int* row = keys + static_cast<int64_t>(r) * W;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (__ldg(row + clampi(mid, 0, W - 1)) <= q) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    p = lo;
    const bool hit = p >= 0 && __ldg(row + clampi(p, 0, W - 1)) == q;
    if (hit && !found) {
      level = r;
      found = true;
    }
    if (r < L - 1) {
      const int* rm = rank_map + static_cast<int64_t>(r) * W;
      const int next_w = widths[r + 1];
      const bool edge = p + 1 >= W || widths[r] == 0;
      const int lo_n = p >= 0 ? __ldg(rm + clampi(p, 0, W - 1)) : -1;
      hi = edge ? next_w : __ldg(rm + clampi(p + 1, 0, W - 1));
      lo = lo_n;
    }
  }
  found_out[i] = found;
  rank_out[i] = p;
  level_out[i] = level;
}

// union [ulo, uhi) of the unresolved lanes' windows (resolved lanes
// contribute W / 0); every thread gets the result
__device__ void union_window(int lo, int hi, bool resolved, int W,
                             int* s_lo, int* s_hi, int& ulo, int& uhi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int in_warp = min(32, static_cast<int>(blockDim.x) - warp * 32);
  const unsigned mask = in_warp == 32 ? 0xffffffffu : ((1u << in_warp) - 1);
  const int a = __reduce_min_sync(mask, resolved ? W : lo);
  const int b = __reduce_max_sync(mask, resolved ? 0 : hi);
  if (lane == 0) {
    s_lo[warp] = a;
    s_hi[warp] = b;
  }
  __syncthreads();
  ulo = s_lo[0];
  uhi = s_hi[0];
  for (int w = 1; w < nwarps; ++w) {
    ulo = min(ulo, s_lo[w]);
    uhi = max(uhi, s_hi[w]);
  }
  __syncthreads();
}

__global__ void pipelined_kernel(const int* __restrict__ keys,
                                 const int* __restrict__ rank_map,
                                 const int* __restrict__ bot_rank,
                                 const int* __restrict__ widths,
                                 const int* __restrict__ queries, int L,
                                 int W, int n_live, int tile,
                                 bool* __restrict__ found_out,
                                 int* __restrict__ rank_out,
                                 int* __restrict__ level_out,
                                 int* __restrict__ bytes_out) {
  __shared__ int s_lo[32], s_hi[32];
  const int gidx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool is_pad = gidx >= n_live;
  const int q = queries[gidx];
  const int bot_w = widths[L - 1];

  int lo = is_pad ? 0 : -1, hi = is_pad ? 0 : widths[0];
  int rank = 0, level = L;
  bool found = false, resolved = is_pad;
  bool done = __syncthreads_and(resolved);

  int ulo, uhi, base, nt;
  union_window(lo, hi, resolved, W, s_lo, s_hi, ulo, uhi);
  cover(ulo, uhi, W, tile, base, nt);
  int fetched = done ? 0 : 3 * nt * tile;  // meaningful on thread 0

  for (int r = 0; r < L && !done; ++r) {
    const int w_r = widths[r];
    const int next_w = widths[min(r + 1, L - 1)];
    const int* row = keys + static_cast<int64_t>(r) * W;
    const int* rm = rank_map + static_cast<int64_t>(r) * W;
    const int* br = bot_rank + static_cast<int64_t>(r) * W;

    // foresight: bound row r+1's window union through row r's rank map
    union_window(lo, hi, resolved, W, s_lo, s_hi, ulo, uhi);
    const int l1 = ulo < 0 ? -1 : __ldg(rm + clampi(ulo, 0, W - 1));
    const int h1 = (uhi >= W || w_r == 0)
                       ? next_w
                       : __ldg(rm + clampi(uhi, 0, W - 1));
    cover(l1, h1, W, tile, base, nt);
    if (r < L - 1) fetched += 3 * nt * tile;

    if (!resolved) {
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (__ldg(row + clampi(mid, 0, W - 1)) <= q) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const int p = lo;
      const int pc = clampi(p, 0, W - 1), pc1 = clampi(p + 1, 0, W - 1);
      const bool edge = p + 1 >= W || w_r == 0;
      const bool hit = p >= 0 && __ldg(row + pc) == q;
      const int bl = p >= 0 ? __ldg(br + pc) : -1;
      const int bh = edge ? bot_w : __ldg(br + pc1);
      const int lo_n = p >= 0 ? __ldg(rm + pc) : -1;
      const int hi_n = edge ? next_w : __ldg(rm + pc1);
      if (hit) {
        level = r;
        rank = bl;
        found = true;
        resolved = true;
      } else if (bh - bl == 1) {  // bottom rank pinned
        rank = bl;
        resolved = true;
      }
      lo = resolved ? 0 : lo_n;
      hi = resolved ? 0 : hi_n;
    }
    done = __syncthreads_and(resolved);
  }
  found_out[gidx] = found;
  rank_out[gidx] = rank;
  level_out[gidx] = level;
  if (threadIdx.x == 0) bytes_out[blockIdx.x] = fetched * 4;
}

constexpr int kFullTile = 128;     // queries of a cluster tile
constexpr int kFullR = 8;          // queries a thread holds
constexpr int kFullThreads = 256;
constexpr int kFullGroups = kFullTile / kFullR;        // 16
constexpr int kFullParts = kFullThreads / kFullGroups; // 16 column parts

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Dynamic shared memory: mbarrier (16 B), queries [tile], counts
// [L, tile], hit flags [L, tile] (rounded to 16 B), panel [prows, pcols].
__global__ void __launch_bounds__(kFullThreads)
    full_kernel(const int* __restrict__ keys,
                const int* __restrict__ queries, int L, int W, int nq,
                int slice, int pcols, int prows, int bulk,
                bool* __restrict__ found_out, int* __restrict__ rank_out,
                int* __restrict__ level_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int q0 = (blockIdx.x / S) * kFullTile;
  const uint32_t bar = smem_addr(smem);
  int* s_q = reinterpret_cast<int*>(smem + 16);
  int* s_cnt = s_q + kFullTile;
  unsigned char* s_hit =
      reinterpret_cast<unsigned char*>(s_cnt + L * kFullTile);
  int* panel = reinterpret_cast<int*>(
      smem + 16 + 4 * kFullTile * (L + 1) + ((L * kFullTile + 15) & ~15));

  const int t = threadIdx.x;
  if (t < kFullTile) s_q[t] = q0 + t < nq ? queries[q0 + t] : 0;
  for (int i = t; i < L * kFullTile; i += kFullThreads) s_cnt[i] = 0;
  if (t == 0 && bulk) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int g = t % kFullGroups, part = t / kFullGroups;
  int q[kFullR];
#pragma unroll
  for (int k = 0; k < kFullR; ++k) q[k] = s_q[g * kFullR + k];

  const int c0 = me * slice, c1 = min(W, c0 + slice);
  uint32_t phase = 0;
  for (int cc = c0; cc < c1; cc += pcols) {
    const int ncol = min(pcols, c1 - cc);
    for (int r0 = 0; r0 < L; r0 += prows) {
      const int nr = min(prows, L - r0);
      if (bulk) {
        if (t == 0) {
          const uint32_t bytes = 4u * nr * ncol;
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
              :: "r"(bar), "r"(bytes) : "memory");
          for (int i = 0; i < nr; ++i)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes [%0], [%1], %2, [%3];"
                :: "r"(smem_addr(panel + i * pcols)),
                   "l"(keys + static_cast<int64_t>(r0 + i) * W + cc),
                   "r"(4u * ncol), "r"(bar) : "memory");
        }
        bar_wait(bar, phase);
        phase ^= 1;
      } else {
        for (int e = t; e < nr * ncol; e += kFullThreads) {
          const int i = e / ncol, j = e - i * ncol;
          panel[i * pcols + j] =
              __ldg(keys + static_cast<int64_t>(r0 + i) * W + cc + j);
        }
        __syncthreads();
      }
      const int n4 = ncol / 4, tail = ncol - 4 * n4;
      for (int i = 0; i < nr; ++i) {
        const int* row = panel + i * pcols;
        const int4* row4 = reinterpret_cast<const int4*>(row);
        int cnt[kFullR];
#pragma unroll
        for (int k = 0; k < kFullR; ++k) cnt[k] = 0;
#pragma unroll 4
        for (int j = part; j < n4; j += kFullParts) {
          const int4 v = row4[j];
#pragma unroll
          for (int k = 0; k < kFullR; ++k)
            cnt[k] += (v.x <= q[k]) + (v.y <= q[k]) + (v.z <= q[k]) +
                      (v.w <= q[k]);
        }
        if (part == 0)
          for (int j = 4 * n4; j < 4 * n4 + tail; ++j)
#pragma unroll
            for (int k = 0; k < kFullR; ++k) cnt[k] += row[j] <= q[k];
        // lanes l and l ^ 16 of a warp hold the same query group
#pragma unroll
        for (int k = 0; k < kFullR; ++k)
          cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], 16);
        if ((t & 16) == 0) {
#pragma unroll
          for (int k = 0; k < kFullR; ++k)
            atomicAdd(&s_cnt[(r0 + i) * kFullTile + g * kFullR + k], cnt[k]);
        }
      }
      __syncthreads();  // the panel is read out before it is refilled
    }
  }

  cluster.sync();  // every CTA's partial counts are in its shared memory
  if (me == 0) {
    for (int i = t; i < L * kFullTile; i += kFullThreads) {
      int c = s_cnt[i];
      for (int s = 1; s < S; ++s) c += cluster.map_shared_rank(s_cnt, s)[i];
      s_cnt[i] = c;
    }
  }
  cluster.sync();  // the leader has read them; the others may exit
  if (me != 0) return;

  for (int i = t; i < L * kFullTile; i += kFullThreads) {
    const int r = i / kFullTile, c = s_cnt[i];
    s_hit[i] = c > 0 &&
               __ldg(keys + static_cast<int64_t>(r) * W + c - 1) ==
                   s_q[i - r * kFullTile];
  }
  __syncthreads();
  if (t < kFullTile && q0 + t < nq) {
    bool found = false;
    int level = L;
    for (int r = 0; r < L; ++r) {
      const bool hit = s_hit[r * kFullTile + t];
      if (hit && !found) level = r;
      found = found || hit;
    }
    found_out[q0 + t] = found;
    rank_out[q0 + t] = s_cnt[(L - 1) * kFullTile + t] - 1;
    level_out[q0 + t] = level;
  }
}

}  // namespace

extern "C" int splay_search_tiered(const int* keys, const int* rank_map,
                                   const int* widths, const int* queries,
                                   int L, int W, int nq, int block,
                                   bool* found, int* rank, int* level,
                                   void* stream) {
  const int grid = (nq + block - 1) / block;
  tiered_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, rank_map, widths, queries, L, W, nq, found, rank, level);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int splay_search_pipelined(const int* keys, const int* rank_map,
                                      const int* bot_rank,
                                      const int* widths,
                                      const int* queries, int L, int W,
                                      int n_blocks, int query_block,
                                      int n_live, int tile, bool* found,
                                      int* rank, int* level, int* bytes,
                                      void* stream) {
  pipelined_kernel<<<n_blocks, query_block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, rank_map, bot_rank, widths, queries, L, W, n_live, tile, found,
      rank, level, bytes);
  return static_cast<int>(cudaGetLastError());
}

// One cluster of `cluster` CTAs per tile of kFullTile queries.  Returns
// the first CUDA error: a refused shared-memory attribute or cluster
// launch is reported, never replaced by another kernel.
extern "C" int splay_search_full(const int* keys, const int* queries, int L,
                                 int W, int nq, int cluster, int slice,
                                 int pcols, int prows, int bulk,
                                 int smem_bytes, bool* found, int* rank,
                                 int* level, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (nq + kFullTile - 1) / kFullTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(kFullThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, full_kernel, keys, queries, L, W, nq,
                           slice, pcols, prows, bulk, found, rank, level);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
