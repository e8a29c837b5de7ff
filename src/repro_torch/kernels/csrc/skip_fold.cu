// Kernel S: the skip-list's serialized op fold, on the card.
//
// Replaces: no Pallas kernel.  In the JAX package the skip-list's
// run_ops is a lax.scan over find, _find_preds, insert and delete
// (src/repro/core/skiplist.py:253), which XLA compiles into one device
// loop.  Every step branches on the state in device memory (the
// while_loops of find :160 and _find_preds :188), so eager PyTorch
// would pay a host round trip per walk step; this kernel keeps the
// whole fold on the card, one launch per op list.  It exists for the
// same reason as kernel F (splay_fold.cu), which races it in the
// paper's Figs. 3-5.
//
// The function, op for op as the reference:
//
//   contains / delete  find: advance while key[nxt[h][pred]] <= k, else
//            descend; a match is seen only on a descent (or at the
//            end), and the path length counts every advance and
//            descent.  A delete marks a live match.
//   insert   the predecessor at every level (the last node there with
//            key <= k); a marked match is revived, a live one left
//            alone; a new key takes slot n_alloc and is linked on
//            levels 0..height after its predecessors.  Path length 0.
//
// Bound: latency.  The ops run one after the other in a total order and
// a walk is a chain of dependent loads.  One thread running the
// reference's _find_preds from the head through all L levels pays two
// dependent loads a step on every level of every insert.  This kernel is
// one warp; lane l owns levels l and l + 32 (MAX_LEVELS = 64), and the
// predecessors live in the lanes' registers:
//
//   fingers  the skip-list never unlinks (a delete only marks), so the
//            predecessor at level h that the last insert of this launch
//            found (or its new node, where h <= its height) stays on
//            level h, with the successor it had then.  The warp keeps
//            them, with their keys, in registers.  For an insert of k,
//            a level whose finger key is <= k and whose successor key
//            is > k has its predecessor at once, with no load.  The
//            levels left resolve top-down, each from the level above's
//            answer or from its finger's successor where that lies
//            further right, one dependent round a step as in W
//            (state_walk.cu): key[curr], the link it needs if it
//            advances and the one it needs if it descends, issued
//            together.  Either start is a node of level h at or before
//            k's predecessor there, so every level gets the same
//            predecessor as _find_preds.  The first insert of a launch
//            has no fingers and resolves every level from the head.  A
//            sorted populate thus costs no load for its predecessors.
//   links    the lanes h <= height write nxt[h][j] (the successor they
//            hold) and nxt[h][pred], the lanes above write
//            nxt[h][j] = -1: each lane its own rows, no word twice.  The
//            revive and present cases read level 0's predecessor from
//            lane 0.  A __syncwarp() orders each op's writes before the
//            next op's reads.
//   finds    the whole warp walks the same addresses (one load serves
//            all lanes) with W's one-round step, counting every advance
//            and descent; lane 0 writes.  Measured against it on the
//            card (PERF.md §6): the lanes fetching each reached
//            node's column nxt[0..h][pred] and those slots' keys in two
//            rounds, so that a run of descents at one node costs no
//            load, 6% slower on phase 10's mixed list (23.50-23.58 ms
//            against 22.07-22.09; F found the same, splay_fold.cu).
//   op list  the warp reads the ops 32 at a time, coalesced, a chunk
//            ahead, and hands each op's kind, key and height round by
//            shuffle; each answer is written as it goes; n_alloc and
//            size live in registers, written back once.
//
// An insert that finds the capacity exhausted stops the fold before it
// writes anything of that op and reports its index; the wrapper raises.
// (The reference's scatters drop there but its predecessors get linked
// to the out-of-range slot, after which a walk can loop for ever.)
// Index rules follow the reference: a negative slot index wraps
// (numpy/JAX indexing); the wrapper refuses walk keys >= POS_INF_32,
// whose walk runs past the tail sentinel and never returns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HEAD = 0;
constexpr int OP_INSERT = 1;
constexpr int OP_DELETE = 2;
constexpr unsigned kAll = 0xffffffffu;

struct Skip {
  int* key;
  int* nxt;      // [L, C], row h at nxt + h * C
  int* top;
  bool* deleted;
  int C;
  int L;

  __device__ __forceinline__ int wrap(int i) const {
    return i < 0 ? i + C : i;
  }
  __device__ __forceinline__ int& next(int h, int i) const {
    return nxt[static_cast<int64_t>(h) * C + wrap(i)];
  }
  __device__ __forceinline__ int key_of(int i) const { return key[wrap(i)]; }
};

__device__ __forceinline__ int shfl(int v, int src) {
  return __shfl_sync(kAll, v, src);
}

// One level of an insert: its predecessor and successor with their keys.
// As a finger: the last insert's, at the same level.
struct Level {
  int pred, pk, succ, sk;
};

// The reference's find, warp-uniform, one dependent round a step:
// (slot or -1), counting advances and descents.
__device__ int find(const Skip& s, int k, int k_head, int& steps) {
  int pred = HEAD, kp = k_head, h = s.L - 1;
  int curr = s.next(h, HEAD);
  bool found = false;
  steps = 0;
  while (h >= 0 && !found) {
    const int kc = s.key_of(curr);
    const int adv = s.next(h, curr);
    const int desc = h > 0 ? s.next(h - 1, pred) : 0;
    if (kc <= k) {
      pred = curr;
      kp = kc;
      curr = adv;
    } else {
      found = kp == k;
      --h;
      curr = desc;
    }
    ++steps;
  }
  found = found || kp == k;
  return (found && pred != HEAD) ? pred : -1;
}

// Walk level h right from cur (key kcur), whose successor nx is known:
// the last node with key <= k and its successor; desc gets the link of
// that node one level down (speculated every round), the next level's
// first link.
__device__ __forceinline__ Level walk_level(const Skip& s, int h, int k,
                                            int cur, int kcur, int nx,
                                            int& desc) {
  for (;;) {
    const int knx = s.key_of(nx);
    const int adv = s.next(h, nx);
    const int d = h > 0 ? s.next(h - 1, cur) : 0;
    if (knx > k) {
      desc = d;
      return Level{cur, kcur, nx, knx};
    }
    cur = nx;
    kcur = knx;
    nx = adv;
  }
}

// An insert's predecessors in the lanes' registers (lo: level lane, hi:
// level lane + 32), from the fingers where they settle a level at once,
// else top-down.
__device__ void insert_preds(const Skip& s, int lane, int k, int k_head,
                             bool have_f, const Level& f_lo,
                             const Level& f_hi, Level& lo, Level& hi) {
  const int L = s.L;
  // settled: the finger is at or before k and its successor beyond it
  const bool set_lo = have_f && f_lo.pk <= k && f_lo.sk > k;
  const bool set_hi = have_f && f_hi.pk <= k && f_hi.sk > k;
  if (set_lo) lo = f_lo;
  if (set_hi) hi = f_hi;
  const unsigned open_lo = __ballot_sync(kAll, lane < L && !set_lo);
  const unsigned open_hi = __ballot_sync(kAll, lane + 32 < L && !set_hi);
  if (!(open_lo | open_hi)) return;
  const int top = open_hi ? 63 - __clz(open_hi) : 31 - __clz(open_lo);
  int cur = HEAD, kcur = k_head;
  if (top + 1 < L) {
    const int src = (top + 1) & 31;
    const bool up = top + 1 >= 32;
    cur = shfl(up ? hi.pred : lo.pred, src);
    kcur = shfl(up ? hi.pk : lo.pk, src);
  }
  int nx = 0;
  bool nx_known = false;
  for (int h = top; h >= 0; --h) {
    const int src = h & 31;
    const bool up = h >= 32;
    if (!(((up ? open_hi : open_lo) >> src) & 1)) {
      cur = shfl(up ? hi.pred : lo.pred, src);
      kcur = shfl(up ? hi.pk : lo.pk, src);
      nx_known = false;
      continue;
    }
    // the finger's successor, where it is at or before k and further
    // right than the level above's answer
    const int g = shfl(up ? f_hi.succ : f_lo.succ, src);
    const int gk = shfl(up ? f_hi.sk : f_lo.sk, src);
    const bool go = have_f && shfl((up ? f_hi.pk : f_lo.pk) <= k, src);
    if (go && gk > kcur) {
      cur = g;
      kcur = gk;
      nx_known = false;
    }
    if (!nx_known) nx = s.next(h, cur);
    int desc;
    const Level got = walk_level(s, h, k, cur, kcur, nx, desc);
    if (lane == src) {
      if (up) {
        hi = got;
      } else {
        lo = got;
      }
    }
    cur = got.pred;
    kcur = got.pk;
    nx = desc;
    nx_known = true;
  }
}

// Link the new node j at level h (one of this lane's), or unlink its row
// there above its height.
__device__ __forceinline__ void link(const Skip& s, int h, int height, int j,
                                     const Level& lv) {
  if (h >= s.L) return;
  if (h <= height) {
    s.next(h, j) = lv.succ;
    s.next(h, lv.pred) = j;
  } else {
    s.next(h, j) = -1;
  }
}

// The finger at level h after an insert of k that made node j (j < 0:
// the key was present): j where h <= height, else the predecessor.
__device__ __forceinline__ Level finger(int h, int height, int j, int k,
                                        const Level& lv) {
  if (j >= 0 && h <= height) return Level{j, k, lv.succ, lv.sk};
  return lv;
}

__global__ void skip_fold_kernel(Skip s, int* n_alloc_p, int* size_p, int n,
                                 const int* __restrict__ kinds,
                                 const int* __restrict__ keys,
                                 const int* __restrict__ heights,
                                 bool* __restrict__ res,
                                 int* __restrict__ plen, int* status) {
  const int lane = threadIdx.x;
  int n_alloc = *n_alloc_p, size = *size_p;
  const int k_head = s.key[HEAD];     // never written: new slots are >= 2
  Level f_lo{HEAD, k_head, 0, 0}, f_hi{HEAD, k_head, 0, 0};
  bool have_f = false;
  int stop = n;
  // the op list, 32 ops a chunk: lane l holds op l of the current chunk
  // and of the next, read a chunk ahead
  auto fetch = [&](int base, int& kd, int& ky, int& ht) {
    const int o = base + lane;
    kd = o < n ? kinds[o] : 0;
    ky = o < n ? keys[o] : 0;
    ht = o < n ? heights[o] : 0;
  };
  int kd_c, ky_c, ht_c, kd_n, ky_n, ht_n;
  fetch(0, kd_c, ky_c, ht_c);
  fetch(32, kd_n, ky_n, ht_n);
  for (int i = 0; i < n; ++i) {
    const int q = i & 31;
    if (q == 0 && i > 0) {
      kd_c = kd_n;
      ky_c = ky_n;
      ht_c = ht_n;
      fetch(i + 32, kd_n, ky_n, ht_n);
    }
    const int kind = shfl(kd_c, q), k = shfl(ky_c, q);
    const int height = shfl(ht_c, q);
    bool r;
    int steps = 0;
    if (kind == OP_INSERT) {
      Level lo{HEAD, k_head, 0, 0}, hi{HEAD, k_head, 0, 0};
      insert_preds(s, lane, k, k_head, have_f, f_lo, f_hi, lo, hi);
      const int pred0 = shfl(lo.pred, 0);
      const bool present = shfl(lo.pk, 0) == k;
      // every lane reads before lane 0 may write (the shuffle joins them)
      const bool marked = present && shfl(s.deleted[s.wrap(pred0)], 0);
      int j = -1;
      if (marked) {
        if (lane == 0) s.deleted[s.wrap(pred0)] = false;
        ++size;
      } else if (!present) {
        j = n_alloc;
        if (j >= s.C) {
          stop = i;
          break;
        }
        link(s, lane, height, j, lo);
        link(s, lane + 32, height, j, hi);
        if (lane == 0) {
          s.key[j] = k;
          s.top[j] = height;
          s.deleted[j] = false;
        }
        ++n_alloc;
        ++size;
      }
      f_lo = finger(lane, height, j, k, lo);
      f_hi = finger(lane + 32, height, j, k, hi);
      have_f = true;
      r = !present || marked;
    } else {
      const int slot = find(s, k, k_head, steps);
      r = slot >= 0 && !shfl(s.deleted[slot], 0);
      if (r && kind == OP_DELETE) {
        if (lane == 0) s.deleted[slot] = true;
        --size;
      }
    }
    if (lane == 0) {
      res[i] = r;
      plen[i] = steps;
    }
    __syncwarp();
  }
  if (lane == 0) {
    *n_alloc_p = n_alloc;
    *size_p = size;
    status[0] = stop;
  }
}

}  // namespace

extern "C" int skip_fold(int* key, int* nxt, int* top, bool* deleted,
                         int* n_alloc, int* size, int C, int L, int n,
                         const int* kinds, const int* keys,
                         const int* heights, bool* res, int* plen,
                         int* status, void* stream) {
  // the largest L1 carveout: every find starts at the head and revisits
  // the top of the list
  const cudaError_t err = cudaFuncSetAttribute(
      skip_fold_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return static_cast<int>(err);
  Skip s{key, nxt, top, deleted, C, L};
  skip_fold_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n_alloc, size, n, kinds, keys, heights, res, plen, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
