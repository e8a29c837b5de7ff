// Kernel F: the splay-list's serialized update fold, on the card.
//
// Replaces: no Pallas kernel.  In the JAX package the fold is the
// lax.scan over _update inside run_ops (src/repro/core/splaylist.py:629)
// and run_contains_batch (:696), which XLA compiles into one device loop.
// Every step branches on state in device memory (the while/cond chains
// of _update :196-316, find :158, _link_bottom :323), so eager PyTorch
// would pay a host round trip per branch; this kernel keeps the whole
// fold on the card.
//
// Bound: latency.  The fold is a chain of dependent loads (pointer
// chasing through nxt/key), one op after the other in a total order, so
// no parallelism is available inside it.  Design: one thread walks the
// op list against the state arrays in device memory (the whole state of
// the paper-scale deployment, ~28 MB, stays resident in the 50 MB L2),
// mirroring _update, _fill_down, _link_bottom and find branch for
// branch.  The kernel reports where a rebuild is due (after a contains
// or delete that leaves 2*dhits >= m) and stops there; the wrapper runs
// the vectorised rebuild and relaunches from the next op.
//
// Index rules follow the reference: a negative level or slot index
// wraps (numpy/JAX indexing), and shifts by an amount outside
// [0, bits) give the sign fill (XLA's rule; C leaves them undefined).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HEAD = 0;
constexpr int OP_CONTAINS = 0;
constexpr int OP_INSERT = 1;

template <typename T>
struct State {
  int* key;
  int* nxt;
  T* hits;
  T* selfhits;
  int* top;
  int* nzero;
  bool* deleted;
  T* m;
  T* dhits;
  int* zl;
  int* n_alloc;
  int* size;
  int C;
  int L;

  __device__ int lv(int h) const { return h < 0 ? h + L + 1 : h; }
  __device__ int sl(int i) const { return i < 0 ? i + C : i; }
  __device__ int& NXT(int h, int i) const {
    return nxt[static_cast<int64_t>(lv(h)) * C + sl(i)];
  }
  __device__ T& HITS(int h, int i) const {
    return hits[static_cast<int64_t>(lv(h)) * C + sl(i)];
  }
  __device__ int K(int i) const { return key[sl(i)]; }
  __device__ int NZ(int i) const { return nzero[sl(i)]; }
};

template <typename T>
__device__ T shr(T x, int e) {
  constexpr int bits = 8 * static_cast<int>(sizeof(T));
  if (e < 0 || e >= bits) return x < 0 ? T(-1) : T(0);
  return x >> e;
}

template <typename T>
__device__ int eff_next(const State<T>& s, int i, int h) {
  return s.NXT(max(h, s.NZ(i)), i);
}

template <typename T>
__device__ T whits(const State<T>& s, int i, int h) {
  return h >= s.NZ(i) ? s.HITS(h, i) : T(0);
}

template <typename T>
__device__ T get_hits(const State<T>& s, int i, int h) {
  return s.selfhits[s.sl(i)] + whits(s, i, h);
}

template <typename T>
__device__ void fill_down(const State<T>& s, int i, int h) {
  const int zl_i = s.NZ(i);
  const int lo = h > 0 ? h : 0;
  if (lo < zl_i) {
    const int v = s.NXT(zl_i, i);
    for (int l = lo; l < zl_i; ++l) {
      s.NXT(l, i) = v;
      s.HITS(l, i) = T(0);
    }
  }
  s.nzero[s.sl(i)] = min(zl_i, h);
}

template <typename T>
__device__ void find(const State<T>& s, int k, int& slot, int& steps) {
  int pred = HEAD, h = s.L - 1, n = 0;
  bool found = false;
  const int zl = *s.zl;
  while (h >= zl && !found) {
    const int curr = eff_next(s, pred, h);
    if (s.K(curr) <= k) {
      pred = curr;
    } else {
      found = s.K(pred) == k;
      --h;
    }
    ++n;
  }
  found = found || s.K(pred) == k;
  slot = (found && pred != HEAD) ? pred : -1;
  steps = n;
}

template <typename T>
__device__ bool promote_cascade(const State<T>& s, int curr, int pp,
                                T curr_m) {
  const int L = s.L, ml1 = L - 1;
  int curh = s.top[s.sl(curr)];
  bool promoted = false;
  while (curh + 1 < L && curh < s.top[s.sl(pp)] &&
         whits(s, pp, curh + 1) - whits(s, pp, curh) >
             shr(curr_m, ml1 - curh - 1)) {
    fill_down(s, pp, curh);
    const T new_hits = s.HITS(curh + 1, pp) - s.HITS(curh, pp) -
                       s.selfhits[s.sl(curr)];
    const int pp_next = s.NXT(curh + 1, pp);
    s.top[s.sl(curr)] = curh + 1;
    s.HITS(curh + 1, curr) = new_hits;
    s.NXT(curh + 1, curr) = pp_next;
    s.HITS(curh + 1, pp) = s.HITS(curh, pp);
    s.NXT(curh + 1, pp) = curr;
    ++curh;
    promoted = true;
  }
  return promoted;
}

template <typename T>
__device__ void demote(const State<T>& s, int curr, int pred, int h) {
  if (h == *s.zl) *s.zl -= 1;
  fill_down(s, curr, h - 1);
  fill_down(s, pred, h - 1);
  const T gh_curr = s.selfhits[s.sl(curr)] + s.HITS(h, curr);
  s.HITS(h, pred) += gh_curr;
  s.HITS(h, curr) = T(0);
  s.NXT(h, pred) = s.NXT(h, curr);
  s.NXT(h, curr) = -1;
  s.top[s.sl(curr)] = h - 1;
}

template <typename T>
__device__ void update(const State<T>& s, int k, T w) {
  const int ml1 = s.L - 1;
  *s.m += w;
  const T curr_m = *s.m;
  int h = ml1, pred = HEAD, pp = HEAD;
  bool found = false, done = false, scanned = false;
  while (!done && h >= *s.zl) {
    const int curr = eff_next(s, pred, h);
    if (s.K(curr) > k) {
      // end of scan at this level: on level entry pred is k's parent
      // here (count the hit); on scan exit it was counted in the scan
      if (!(found || scanned)) {
        fill_down(s, pred, h);
        s.HITS(h, pred) += w;
      }
      --h;
      pp = pred;
      done = found;
      scanned = false;
      continue;
    }
    const bool is_parent = s.K(eff_next(s, curr, h)) > k;
    const bool is_target = s.K(curr) == k;
    if (is_parent && is_target) s.selfhits[s.sl(curr)] += w;
    if (is_parent && !is_target) {
      fill_down(s, curr, h);
      s.HITS(h, curr) += w;
    }
    found = found || (is_parent && is_target);
    scanned = true;
    if (promote_cascade(s, curr, pp, curr_m)) {
      pred = pp = curr;
      continue;
    }
    const int nk = s.K(eff_next(s, curr, h));
    const bool desc = s.top[s.sl(curr)] == h && nk <= k &&
                      get_hits(s, curr, h) + get_hits(s, pred, h) <=
                          shr(curr_m, ml1 - h);
    if (desc) {
      demote(s, curr, pred, h);
    } else {
      pred = curr;
    }
  }
}

// Returns false when the capacity is exhausted (nothing is written).
template <typename T>
__device__ bool link_bottom(const State<T>& s, int k) {
  const int zl = *s.zl;
  int pred = HEAD, h = s.L - 1;
  while (h >= zl) {
    const int curr = eff_next(s, pred, h);
    if (s.K(curr) <= k) {
      pred = curr;
    } else {
      --h;
    }
  }
  const int j = *s.n_alloc;
  if (j >= s.C) return false;
  fill_down(s, pred, zl);
  s.key[j] = k;
  s.NXT(zl, j) = s.NXT(zl, pred);
  s.NXT(zl, pred) = j;
  s.top[j] = zl;
  s.nzero[j] = zl;
  s.selfhits[j] = T(0);
  s.deleted[j] = false;
  *s.n_alloc = j + 1;
  return true;
}

template <typename T>
__device__ bool rebuild_due(const State<T>& s) {
  const T m = *s.m;
  return m > 0 && 2 * *s.dhits >= m;
}

// mode 0: the run_ops op list (kinds/keys/upd -> res/plen), stopping
//         after the op that makes a rebuild due;
// mode 1: the weighted fold list of run_contains_batch (keys/w/wm).
// status[0] = index of the op where the kernel stopped (n: ran to the
// end); status[1] = 1 when an insert found the capacity exhausted.
template <typename T>
__global__ void fold_kernel(State<T> s, int mode, int start, int n,
                            const int* kinds, const int* keys,
                            const bool* upd, const T* w, const T* wm,
                            int* res, int* plen, int* status) {
  status[0] = n;
  status[1] = 0;
  for (int i = start; i < n; ++i) {
    const int k = keys[i];
    if (mode == 1) {
      const T wi = w[i];
      if (wi > 0) {
        update(s, k, wi);
        *s.dhits += wm[i];
      }
      continue;
    }
    const int kind = kinds[i];
    const bool u = upd[i];
    int slot, steps, r = 0;
    find(s, k, slot, steps);
    const bool present = slot >= 0;
    const bool marked = present && s.deleted[slot];
    if (kind == OP_CONTAINS) {
      r = present && !marked;
      if (present && u) {
        update(s, k, T(1));
        if (marked) *s.dhits += T(1);
      }
    } else if (kind == OP_INSERT) {
      r = !present || marked;
      if (marked) {
        s.deleted[slot] = false;
        *s.dhits -= s.selfhits[slot];
        *s.size += 1;
        update(s, k, T(1));
      } else if (present) {
        if (u) update(s, k, T(1));
      } else {
        if (!link_bottom(s, k)) {
          status[0] = i;
          status[1] = 1;
          return;
        }
        *s.size += 1;
        update(s, k, T(1));
      }
    } else {  // delete
      r = present && !marked;
      if (r) {
        s.deleted[slot] = true;
        *s.size -= 1;
        update(s, k, T(1));
        *s.dhits += s.selfhits[slot];
      } else if (marked && u) {
        update(s, k, T(1));
        *s.dhits += T(1);
      }
    }
    res[i] = r;
    plen[i] = steps;
    if (kind != OP_INSERT && rebuild_due(s)) {
      status[0] = i;
      return;
    }
  }
}

template <typename T>
int launch(int* key, int* nxt, T* hits, T* selfhits, int* top, int* nzero,
           bool* deleted, T* m, T* dhits, int* zl, int* n_alloc, int* size,
           int C, int L, int mode, int start, int n, const int* kinds,
           const int* keys, const bool* upd, const T* w, const T* wm,
           int* res, int* plen, int* status, void* stream) {
  State<T> s{key, nxt, hits, selfhits, top, nzero, deleted, m, dhits,
             zl, n_alloc, size, C, L};
  fold_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      s, mode, start, n, kinds, keys, upd, w, wm, res, plen, status);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FOLD_ENTRY(NAME, T)                                                \
  extern "C" int NAME(int* key, int* nxt, T* hits, T* selfhits, int* top,  \
                      int* nzero, bool* deleted, T* m, T* dhits, int* zl,  \
                      int* n_alloc, int* size, int C, int L, int mode,     \
                      int start, int n, const int* kinds, const int* keys, \
                      const bool* upd, const T* w, const T* wm, int* res,  \
                      int* plen, int* status, void* stream) {              \
    return launch<T>(key, nxt, hits, selfhits, top, nzero, deleted, m,     \
                     dhits, zl, n_alloc, size, C, L, mode, start, n,       \
                     kinds, keys, upd, w, wm, res, plen, status, stream);  \
  }

FOLD_ENTRY(splay_fold_i32, int32_t)
FOLD_ENTRY(splay_fold_i64, int64_t)

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
