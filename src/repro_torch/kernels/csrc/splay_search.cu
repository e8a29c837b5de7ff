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
// query block against each row at once.  Here one block of QB threads
// per query block walks the rows top-down and stages each row through
// shared memory in 8 KB chunks; every thread counts row <= q over the
// chunk for its own query (all threads read the same word: a broadcast).
// cnt - 1 on the bottom row is the rank; a hit is row[cnt - 1] == q.  A
// block whose lanes are all found skips its remaining rows except the
// bottom one (a block-wide vote, as the reference's per-block rule).
// Bound: operations, L * W compares per query; only q / QB blocks run,
// so at q = 2048 eight SMs do all of it.  Splitting the width across
// blocks would need a cross-block count and is redesign work.
//
// B1 and B2 keep the reference's arithmetic: (lo + hi) / 2 probes
// (lo + hi >= 0 whenever a lane is active, so truncation equals floor),
// clamped reads, and an explicit floor division in the cover, where the
// reference floors a negative quotient and C would truncate it.

#include <cstdint>
#include <cuda_runtime.h>

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

constexpr int kFullChunk = 2048;  // ints of a row staged per pass (8 KB)

__global__ void full_kernel(const int* __restrict__ keys,
                            const int* __restrict__ queries, int L, int W,
                            bool* __restrict__ found_out,
                            int* __restrict__ rank_out,
                            int* __restrict__ level_out) {
  __shared__ __align__(16) int s_row[kFullChunk];
  const int gidx = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = queries[gidx];
  bool found = false;
  int level = L, rank = 0;
  for (int r = 0; r < L; ++r) {
    // block-uniform: every thread votes, so the skip never diverges
    if (__syncthreads_and(found) && r != L - 1) continue;
    const int* row = keys + static_cast<int64_t>(r) * W;
    int cnt = 0;
    for (int base = 0; base < W; base += kFullChunk) {
      const int n = min(kFullChunk, W - base);
      __syncthreads();  // the previous chunk's reads are done
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        s_row[j] = __ldg(row + base + j);
      }
      __syncthreads();
      const int4* s4 = reinterpret_cast<const int4*>(s_row);
      int j = 0;
#pragma unroll 8
      for (; j < n / 4; ++j) {
        const int4 v = s4[j];
        cnt += (v.x <= q) + (v.y <= q) + (v.z <= q) + (v.w <= q);
      }
      for (j *= 4; j < n; ++j) cnt += s_row[j] <= q;
    }
    const bool hit = cnt > 0 && __ldg(row + cnt - 1) == q;
    if (hit && !found) level = r;
    found = found || hit;
    if (r == L - 1) rank = cnt - 1;
  }
  found_out[gidx] = found;
  rank_out[gidx] = rank;
  level_out[gidx] = level;
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

extern "C" int splay_search_full(const int* keys, const int* queries, int L,
                                 int W, int n_blocks, int query_block,
                                 bool* found, int* rank, int* level,
                                 void* stream) {
  full_kernel<<<n_blocks, query_block, 0,
                static_cast<cudaStream_t>(stream)>>>(keys, queries, L, W,
                                                     found, rank, level);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
