// Kernels B1 and B2: the batched rank-windowed splay descent over the
// level-array plane, one engine (descent_kernel); kernel B5: the seed
// baseline's full-width count.
//
// B1 splay_search_tiered replaces the Pallas _kernel_tiered
// (src/repro/kernels/splay_search.py:272), B2 splay_search_pipelined
// the Pallas _kernel_pipelined (:480).  One thread per query walks the
// rows top-down: in row r it finds its predecessor p inside the window
// (lo, hi) that row r - 1 bounds, notes the first hit, and takes row
// r + 1's window from rank_map[r, p] .. rank_map[r, p + 1].
// Bound: the chain of dependent loads, one row after the other (the
// plane's live entries, a few MB, stay in L2; the bytes bound is under
// a microsecond).  What the design does about it:
// * One dependent trip a row.  A window of at most kLast candidates (0
//   to 3 in nearly every row of the paper plane) is read whole, with
//   the rank-map (and bot-rank) entries p and p + 1 can take: kWords
//   16-byte words of each array, issued together; the count of
//   candidates <= q is the binary search's predecessor on a sorted row.
//   A wider window first narrows kFan-ary.  The keys' compares read the
//   query through the other arrays' words (masked by a zero the
//   compiler cannot see): without that the compiler issued the rank-map
//   loads after the compares, two L2 round trips a row.
// * The walk starts at the first live row (a warp ballot over the
//   widths); the empty rows above it change nothing.
// * B1 walks every row; its rank is the bottom row's p.  A per-lane exit
//   through bot_rank cost more than it saved: every warp holds a lane
//   that walks to the bottom row.
// * B2's lanes each stop once resolved (a hit, rank bot_rank[r, p], or a
//   pinned bottom projection) and fold their windows into per-row
//   unions by min/max atomics on entry to each row, with no per-row
//   barrier; after the walk one warp rebuilds the reference's per-block
//   issue-time byte counter from the unions: the first cover, plus the
//   foresight cover of row r + 1 through row r's rank map for every row
//   some lane entered unresolved.  The counter models the TPU kernel's
//   tile fetches, not bytes this kernel moves.  A query block runs on a
//   cluster of CTAs (256 lanes: 4 of 64) whose lanes fold into the
//   leader CTA's unions through distributed shared memory, so a batch
//   spreads over four times the SMs.
// * Measured and dropped (PERF.md): the leading rows staged in shared
//   memory (TMA bulk copies, then cp.async), an L1 prefetch of them.
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
// B1 and B2 keep the reference's arithmetic where it shows: clamped
// reads, and an explicit floor division in the cover, where the
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

constexpr int kLast = 3;   // candidates a row's last trip reads at once
constexpr int kFan = 4;    // a narrowing trip reads kFan - 1 pivots
constexpr int kWords = 2;  // 16-byte words that hold entries lo .. lo + 4

// v[i] for i in [0, 8): a 3-level multiplexer, no local memory
__device__ __forceinline__ int pick(const int (&v)[4 * kWords], int i) {
  const int a0 = i & 1 ? v[1] : v[0], a1 = i & 1 ? v[3] : v[2];
  const int a2 = i & 1 ? v[5] : v[4], a3 = i & 1 ? v[7] : v[6];
  const int b0 = i & 2 ? a1 : a0, b1 = i & 2 ? a3 : a2;
  return i & 4 ? b1 : b0;
}

// the 16-byte words of a row at entry b (a multiple of 4) and the next
// kWords - 1, each clamped inside the row (a clamped word is never
// used): v[i] is entry b + i
__device__ __forceinline__ void words(const int* row, int b, int W,
                                      int (&v)[4 * kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int4 x =
        __ldg(reinterpret_cast<const int4*>(row + min(b + 4 * k, W - 4)));
    v[4 * k] = x.x, v[4 * k + 1] = x.y, v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
}

// A lane's walk state and one row of it: narrowing trips of kFan - 1
// pivots while the window (lo, hi) holds more than kLast candidates,
// then the last trip, whose loads are independent: the window's keys
// (entry lo for the hit, the candidates below hi) and the rank-map (and
// B2's bot-rank) entries p and p + 1 can take.  kVec reads kWords
// 16-byte words at max(lo, 0) & ~3 of each array; otherwise p + 1 is
// read only below the width and in a live row (else: edge).  `zero` is
// 0, passed at run time.
struct Lane {
  int q, lo, hi, rank, level;
  bool found, resolved;
};

template <bool kPipelined, bool kVec>
__device__ __forceinline__ void row_step(Lane& s, const int* gk,
                                         const int* grm, const int* gbr,
                                         int r, int L, int W, int w_r,
                                         int next_w, int bot_w, int zero) {
  int lo = s.lo, hi = s.hi;
  const int q = s.q;
  while (hi - lo - 1 > kLast) {
    const int64_t span = static_cast<int64_t>(hi) - lo;
    int c = 0;
#pragma unroll
    for (int k = 1; k < kFan; ++k) {
      const int j = lo + static_cast<int>(k * span / kFan);
      c += __ldg(gk + clampi(j, 0, W - 1)) <= q;
    }
    const int nlo = lo + static_cast<int>(c * span / kFan);
    hi = lo + static_cast<int>((c + 1) * span / kFan);
    lo = nlo;
  }
  const bool need_rm = r < L - 1, need_br = kPipelined;
  int p, kp, m0 = 0, m1 = 0, n0 = 0, n1 = 0;  // rank map, bot rank at p, p+1
  if (kVec) {
    const int b = min(max(lo, 0) & ~3, W - 4);
    int kv[4 * kWords], rv[4 * kWords], bv[4 * kWords];
    words(gk, b, W, kv);
    words(grm, b, W, rv);
    if (kPipelined) words(gbr, b, W, bv);
    // The compares read q through every word of the other arrays, masked
    // by a zero the compiler cannot see: left alone, it issued the
    // rank-map loads after the keys' compares, two L2 round trips a row
    int other = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      other ^= rv[4 * k] ^ (kPipelined ? bv[4 * k] : 0);
    const int qq = q ^ (other & zero);
    unsigned le = 0;  // candidates <= q: a mask, counted at once
#pragma unroll
    for (int i = 0; i < 4 * kWords; ++i)
      le |= static_cast<unsigned>(b + i > lo && b + i < hi && kv[i] <= qq)
            << i;
    p = lo + __popc(le);
    // p and p + 1 in the words (p < 0 only with lo = -1, b = 0: then
    // entry p is unused)
    const int ip = max(p - b, 0), ip1 = p + 1 - b;
    kp = pick(kv, ip);
    m0 = pick(rv, ip);
    m1 = pick(rv, ip1);
    if (kPipelined) {
      n0 = pick(bv, ip);
      n1 = pick(bv, ip1);
    }
  } else {
    int kv[kLast + 1], rv[kLast + 2], bv[kLast + 2];
#pragma unroll
    for (int k = 0; k <= kLast + 1; ++k) {
      const int j = lo + k, jc = clampi(j, 0, W - 1);
      if (k <= kLast)
        kv[k] = (k == 0 ? lo >= 0 : j < hi) ? __ldg(gk + jc) : 0;
      const bool in = k == 0 ? lo >= 0
                             : j < W && (k == 1 || j <= hi) &&
                                   !(w_r == 0 && j >= hi);
      rv[k] = in && need_rm ? __ldg(grm + jc) : 0;
      bv[k] = in && need_br ? __ldg(gbr + jc) : 0;
    }
    int c = 0;
#pragma unroll
    for (int k = 1; k <= kLast; ++k) c += (lo + k < hi) && kv[k] <= q;
    kp = kv[0], m0 = rv[0], m1 = rv[1], n0 = bv[0], n1 = bv[1];
#pragma unroll
    for (int k = 1; k <= kLast; ++k)
      if (k == c) {
        kp = kv[k];
        m0 = rv[k];
        m1 = rv[k + 1];
        n0 = bv[k];
        n1 = bv[k + 1];
      }
    p = lo + c;
  }
  const bool edge = p + 1 >= W || w_r == 0;
  const bool hit = p >= 0 && kp == q;
  if (kPipelined) {
    const int bl = p >= 0 ? n0 : -1, bh = edge ? bot_w : n1;
    if (hit) {
      s.found = true;
      s.level = r;
      s.rank = bl;
      s.resolved = true;
    } else if (bh - bl == 1) {  // bottom rank pinned
      s.rank = bl;
      s.resolved = true;
    }
  } else {
    if (hit && !s.found) {
      s.found = true;
      s.level = r;
    }
    s.rank = p;  // the bottom row's p is the rank
  }
  s.lo = p >= 0 ? m0 : -1;
  s.hi = edge ? next_w : m1;
}

// Dynamic shared memory: widths [L], and B2's per-row union and run
// flag [3, L].
__host__ __device__ __forceinline__ int descent_smem(int L) {
  return 16 * L;
}

// kPipelined: B2 (a lane leaves on a hit or a pinned bottom projection;
// pad lanes; the byte counter; rank 0 for a lane that never resolves),
// else B1 (every lane walks every row; rank = the bottom row's p).
// kVec: rows are 16-byte aligned.  The walk starts at the first live
// row.  B2 runs a query block on a cluster of CTAs; their lanes fold
// their windows into the leader CTA's per-row unions through
// distributed shared memory.
template <bool kPipelined, bool kVec>
__global__ void descent_kernel(const int* __restrict__ keys,
                               const int* __restrict__ rank_map,
                               const int* __restrict__ bot_rank,
                               const int* __restrict__ widths,
                               const int* __restrict__ queries, int L, int W,
                               int n_live, int tile,
                               bool* __restrict__ found_out,
                               int* __restrict__ rank_out,
                               int* __restrict__ level_out,
                               int* __restrict__ bytes_out) {
  extern __shared__ int s_w[];  // widths, then B2's s_lo, s_hi, s_run
  int* s_lo = s_w + L;
  int* s_hi = s_lo + L;
  int* s_run = s_hi + L;
  const int t = threadIdx.x, T = blockDim.x;
  const int gidx = blockIdx.x * T + t;
  const int total = gridDim.x * T;  // B2: the padded batch
  Lane s;
  s.q = gidx < (kPipelined ? total : n_live) ? queries[gidx] : 0;
  for (int r = t; r < L; r += T) {
    s_w[r] = widths[r];
    if (kPipelined) {
      s_lo[r] = W;
      s_hi[r] = 0;
      s_run[r] = 0;
    }
  }
  int C = 1, *u_lo = s_lo, *u_hi = s_hi, *u_run = s_run;
  if constexpr (kPipelined) {
    cg::cluster_group cluster = cg::this_cluster();
    C = static_cast<int>(cluster.num_blocks());
    u_lo = cluster.map_shared_rank(s_lo, 0);
    u_hi = cluster.map_shared_rank(s_hi, 0);
    u_run = cluster.map_shared_rank(s_run, 0);
    cluster.sync();  // the leader's unions start before any lane folds
  } else {
    __syncthreads();
  }
  // the first live row, found by each warp with a ballot over the
  // widths; above it every lane's window stays (-1, 0), nothing hits and
  // nothing is pinned (the bottom row is live).  An all-empty plane is
  // walked from the top.  B2 records those rows' unions once, for a
  // query block that holds a live lane
  const unsigned warp = __activemask();
  const int lane = t & 31, lanes = __popc(warp);
  int r0 = L;
  for (int base = 0; base < L && r0 == L; base += lanes) {
    const unsigned live =
        __ballot_sync(warp, base + lane < L && s_w[base + lane] > 0);
    if (live) r0 = base + __ffs(live) - 1;
  }
  if (r0 == L) r0 = 0;
  const bool leader = blockIdx.x % C == 0;
  if (kPipelined && leader && t == 0 && blockIdx.x * T < n_live)
    for (int r = 0; r < r0; ++r) {
      s_lo[r] = -1;
      s_hi[r] = 0;
      s_run[r] = 1;
    }

  const int bot_w = s_w[L - 1];
  const int zero = tile >> 30;  // tile <= 256: zero, unknown to the compiler
  s.lo = -1;
  s.hi = s_w[r0];
  s.rank = 0;
  s.level = L;
  s.found = false;
  s.resolved = gidx >= n_live;
  for (int r = r0; r < L && !s.resolved; ++r) {
    const int64_t base = static_cast<int64_t>(r) * W;
    if (kPipelined) {  // this lane is unresolved on entry to row r
      atomicMin(u_lo + r, s.lo);
      atomicMax(u_hi + r, s.hi);
      u_run[r] = 1;
    }
    row_step<kPipelined, kVec>(s, keys + base, rank_map + base,
                               bot_rank + base, r, L, W, s_w[r],
                               s_w[min(r + 1, L - 1)], bot_w, zero);
  }
  if (kPipelined ? gidx < total : gidx < n_live) {
    found_out[gidx] = s.found;
    rank_out[gidx] = s.rank;
    level_out[gidx] = s.level;
  }

  if constexpr (kPipelined) {  // the reference's issue-time byte count
    cg::this_cluster().sync();  // every lane has folded its windows
    const int lanes_c = min(T, 32);
    if (leader && t < lanes_c) {
      int sum = 0;
      for (int r = t; r < L - 1; r += lanes_c) {
        if (!s_run[r]) continue;
        const int* rm = rank_map + static_cast<int64_t>(r) * W;
        const int ulo = s_lo[r], uhi = s_hi[r];
        const int l1 = ulo < 0 ? -1 : __ldg(rm + clampi(ulo, 0, W - 1));
        const int h1 = (uhi >= W || s_w[r] == 0)
                           ? s_w[r + 1]
                           : __ldg(rm + clampi(uhi, 0, W - 1));
        int cb, nt;
        cover(l1, h1, W, tile, cb, nt);
        sum += 3 * nt * tile;
      }
      sum = __reduce_add_sync(
          lanes_c == 32 ? 0xffffffffu : (1u << lanes_c) - 1, sum);
      if (t == 0) {
        if (s_run[0]) {
          int cb, nt;
          cover(s_lo[0], s_hi[0], W, tile, cb, nt);
          sum += 3 * nt * tile;
        }
        bytes_out[blockIdx.x / C] = sum * 4;
      }
    }
  }
}

constexpr int kFullTile = 128;     // queries of a cluster tile
constexpr int kFullR = 8;          // queries a thread holds
constexpr int kFullThreads = 256;
constexpr int kFullGroups = kFullTile / kFullR;        // 16
constexpr int kFullParts = kFullThreads / kFullGroups; // 16 column parts

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

template <bool kPipelined, bool kVec>
int launch_descent(int n_blocks, int block, int cluster, cudaStream_t s,
                   const int* keys, const int* rank_map, const int* bot_rank,
                   const int* widths, const int* queries, int L, int W,
                   int n_live, int tile, bool* found, int* rank, int* level,
                   int* bytes) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * cluster);
  cfg.blockDim = dim3(block / cluster);
  cfg.dynamicSmemBytes = descent_smem(L);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kPipelined ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, descent_kernel<kPipelined, kVec>, keys, rank_map, bot_rank,
      widths, queries, L, W, n_live, tile, found, rank, level, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B1 (pipelined = 0): n_blocks blocks of `block` threads, one thread per
// query; n_live is the query count.  B2 (pipelined = 1): n_blocks query
// blocks of `block` lanes, each on a cluster of `cluster` CTAs of
// block / cluster threads; lanes at or past n_live are batch padding,
// resolved from the start, and bytes[query block] gets its count.
// `aligned`: the three arrays' rows are 16-byte aligned (16-byte reads).
// bot_rank is read by B2 only.
extern "C" int splay_descent(int pipelined, const int* keys,
                             const int* rank_map, const int* bot_rank,
                             const int* widths, const int* queries, int L,
                             int W, int n_blocks, int block, int cluster,
                             int n_live, int tile, int aligned, bool* found,
                             int* rank, int* level, int* bytes,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DESCENT(P, V)                                                       \
  launch_descent<P, V>(n_blocks, block, P ? cluster : 1, s, keys,          \
                       rank_map, bot_rank, widths, queries, L, W, n_live,  \
                       tile, found, rank, level, bytes)
  if (pipelined) return aligned ? DESCENT(true, true) : DESCENT(true, false);
  return aligned ? DESCENT(false, true) : DESCENT(false, false);
#undef DESCENT
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
