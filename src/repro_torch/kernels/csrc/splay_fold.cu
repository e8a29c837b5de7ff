// Kernel F: the splay-list's serialized update fold, on the card.
//
// Replaces: no Pallas kernel.  In the JAX package the fold is the
// lax.scan over _update inside run_ops (src/repro/core/splaylist.py:629)
// and run_contains_batch (:696), which XLA compiles into one device loop.
// Every step branches on state in device memory (the while/cond chains
// of _update :196-316, find :158, _link_bottom :323), so eager PyTorch
// would pay a host round trip per branch; this kernel keeps the whole
// fold on the card, one launch per fold.
//
// Bound: latency.  The fold is a chain of dependent loads (pointer
// chasing through nxt/key), one op after the other in a total order, so
// the walk itself stays serial: lane 0 of one warp walks the state in
// device memory, mirroring find, _update, _fill_down and _link_bottom
// branch for branch.  The design removes the latency around the walk:
//
//   weighted fold (mode 1)  the warp loads the list 128 entries at a
//            time, coalesced, and ballots w > 0; the walker visits only
//            the set bits, in order, reading (k, w, wm) by shuffle.  A
//            zero-weight entry is a no-op of the reference fold, so the
//            walk never sees it.
//   op list (mode 0)  the walker reads the next op's kind, key and
//            update flag into registers before it walks the current one,
//            and writes each op's verdict and path length as it goes.
//   scalars  m, dhits, zl, n_alloc and size live in the walker's
//            registers and are written back once, at the end.
//   L1       the kernel asks for the largest L1 carveout: every op's walk
//            starts at the head and revisits the top of the list.
//
// Three richer designs were measured against this one on the card
// (PERF.md): three more warps staging the lists in shared memory, under
// 1% faster on the weighted fold and slower on the op lists; a warp
// walk, the lanes fetching a node's whole column into a shared-memory
// cache (a column is L + 1 rows C slots apart, so each node costs
// dozens of scattered loads where the walk needs a few), slower on
// every path; and prefetching each reached node's fields into L1 in one
// batch, slower on the op lists.
//
// The kernel reports where a rebuild is due (after a contains or delete
// that leaves 2*dhits >= m) and stops there; the wrapper runs the
// vectorised rebuild and relaunches from the next op.  An insert that
// finds the capacity exhausted stops before it writes anything.
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

constexpr int kPer = 4;            // weighted entries a lane loads a round

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
  __device__ int64_t at(int h, int i) const {
    return static_cast<int64_t>(lv(h)) * C + sl(i);
  }
};

template <typename T>
__device__ T shr(T x, int e) {
  constexpr int bits = 8 * static_cast<int>(sizeof(T));
  if (e < 0 || e >= bits) return x < 0 ? T(-1) : T(0);
  return x >> e;
}

// ---- the walk: one lane, state in device memory ---------------------

// The state's arrays stay in device memory; its scalars are held in
// registers for the whole launch.
template <typename T>
struct Walk {
  State<T> s;
  int L, C;
  T m, dhits;
  int zl, n_alloc, size;

  __device__ void load(const State<T>& st) {
    s = st;
    L = st.L;
    C = st.C;
    m = *st.m;
    dhits = *st.dhits;
    zl = *st.zl;
    n_alloc = *st.n_alloc;
    size = *st.size;
  }
  __device__ void store() const {
    *s.m = m;
    *s.dhits = dhits;
    *s.zl = zl;
    *s.n_alloc = n_alloc;
    *s.size = size;
  }
  __device__ int nxt(int h, int i) { return s.nxt[s.at(h, i)]; }
  __device__ T hits(int h, int i) { return s.hits[s.at(h, i)]; }
  __device__ int key(int i) { return s.key[s.sl(i)]; }
  __device__ int top(int i) { return s.top[s.sl(i)]; }
  __device__ int nz(int i) { return s.nzero[s.sl(i)]; }
  __device__ T sh(int i) { return s.selfhits[s.sl(i)]; }
  __device__ bool del(int i) { return s.deleted[s.sl(i)]; }
  // the successor of i at level h under lazy expansion, and its key
  __device__ int next(int i, int h, int& k) {
    const int v = nxt(max(h, nz(i)), i);
    k = key(v);
    return v;
  }
  __device__ void set_nxt(int h, int i, int v) { s.nxt[s.at(h, i)] = v; }
  __device__ void set_hits(int h, int i, T v) { s.hits[s.at(h, i)] = v; }
  __device__ void set_key(int i, int k) { s.key[s.sl(i)] = k; }
  __device__ void set_top(int i, int v) { s.top[s.sl(i)] = v; }
  __device__ void set_nz(int i, int v) { s.nzero[s.sl(i)] = v; }
  __device__ void set_sh(int i, T v) { s.selfhits[s.sl(i)] = v; }
  __device__ void set_del(int i, bool v) { s.deleted[s.sl(i)] = v; }
};

// ---- the fold: the reference's _update, find and _link_bottom ------

template <typename T>
__device__ T whits(Walk<T>& s, int i, int h) {
  return h >= s.nz(i) ? s.hits(h, i) : T(0);
}

template <typename T>
__device__ T get_hits(Walk<T>& s, int i, int h) {
  return s.sh(i) + whits<T>(s, i, h);
}

template <typename T>
__device__ void fill_down(Walk<T>& s, int i, int h) {
  const int zl_i = s.nz(i);
  const int lo = h > 0 ? h : 0;
  if (lo < zl_i) {
    const int v = s.nxt(zl_i, i);
    for (int l = lo; l < zl_i; ++l) {
      s.set_nxt(l, i, v);
      s.set_hits(l, i, T(0));
    }
  }
  s.set_nz(i, min(zl_i, h));
}

template <typename T>
__device__ void find(Walk<T>& s, int k, int& slot, int& steps) {
  int pred = HEAD, h = s.L - 1, n = 0;
  bool found = false;
  const int zl = s.zl;
  while (h >= zl && !found) {
    int ck;
    const int curr = s.next(pred, h, ck);
    if (ck <= k) {
      pred = curr;
    } else {
      found = s.key(pred) == k;
      --h;
    }
    ++n;
  }
  found = found || s.key(pred) == k;
  slot = (found && pred != HEAD) ? pred : -1;
  steps = n;
}

template <typename T>
__device__ bool promote_cascade(Walk<T>& s, int curr, int pp, T curr_m) {
  const int L = s.L, ml1 = L - 1;
  int curh = s.top(curr);
  bool promoted = false;
  while (curh + 1 < L && curh < s.top(pp) &&
         whits<T>(s, pp, curh + 1) - whits<T>(s, pp, curh) >
             shr(curr_m, ml1 - curh - 1)) {
    fill_down(s, pp, curh);
    const T new_hits = s.hits(curh + 1, pp) - s.hits(curh, pp) - s.sh(curr);
    const int pp_next = s.nxt(curh + 1, pp);
    s.set_top(curr, curh + 1);
    s.set_hits(curh + 1, curr, new_hits);
    s.set_nxt(curh + 1, curr, pp_next);
    s.set_hits(curh + 1, pp, s.hits(curh, pp));
    s.set_nxt(curh + 1, pp, curr);
    ++curh;
    promoted = true;
  }
  return promoted;
}

template <typename T>
__device__ void demote(Walk<T>& s, int curr, int pred, int h) {
  if (h == s.zl) s.zl -= 1;
  fill_down(s, curr, h - 1);
  fill_down(s, pred, h - 1);
  const T gh_curr = s.sh(curr) + s.hits(h, curr);
  s.set_hits(h, pred, s.hits(h, pred) + gh_curr);
  s.set_hits(h, curr, T(0));
  s.set_nxt(h, pred, s.nxt(h, curr));
  s.set_nxt(h, curr, -1);
  s.set_top(curr, h - 1);
}

template <typename T>
__device__ void update(Walk<T>& s, int k, T w) {
  const int ml1 = s.L - 1;
  s.m += w;
  const T curr_m = s.m;
  int h = ml1, pred = HEAD, pp = HEAD;
  bool found = false, done = false, scanned = false;
  while (!done && h >= s.zl) {
    int ck;
    const int curr = s.next(pred, h, ck);
    if (ck > k) {
      // end of scan at this level: on level entry pred is k's parent
      // here (count the hit); on scan exit it was counted in the scan
      if (!(found || scanned)) {
        fill_down(s, pred, h);
        s.set_hits(h, pred, s.hits(h, pred) + w);
      }
      --h;
      pp = pred;
      done = found;
      scanned = false;
      continue;
    }
    int pk;
    s.next(curr, h, pk);
    const bool is_parent = pk > k;
    const bool is_target = ck == k;
    if (is_parent && is_target) s.set_sh(curr, s.sh(curr) + w);
    if (is_parent && !is_target) {
      fill_down(s, curr, h);
      s.set_hits(h, curr, s.hits(h, curr) + w);
    }
    found = found || (is_parent && is_target);
    scanned = true;
    if (promote_cascade(s, curr, pp, curr_m)) {
      pred = pp = curr;
      continue;
    }
    int nk;
    s.next(curr, h, nk);
    const bool desc = s.top(curr) == h && nk <= k &&
                      get_hits<T>(s, curr, h) + get_hits<T>(s, pred, h) <=
                          shr(curr_m, ml1 - h);
    if (desc) {
      demote<T>(s, curr, pred, h);
    } else {
      pred = curr;
    }
  }
}

// Returns false when the capacity is exhausted (nothing is written).
template <typename T>
__device__ bool link_bottom(Walk<T>& s, int k) {
  const int zl = s.zl;
  int pred = HEAD, h = s.L - 1;
  while (h >= zl) {
    int ck;
    const int curr = s.next(pred, h, ck);
    if (ck <= k) {
      pred = curr;
    } else {
      --h;
    }
  }
  const int j = s.n_alloc;
  if (j >= s.C) return false;
  fill_down(s, pred, zl);
  s.set_key(j, k);
  s.set_nxt(zl, j, s.nxt(zl, pred));
  s.set_nxt(zl, pred, j);
  s.set_top(j, zl);
  s.set_nz(j, zl);
  s.set_sh(j, 0);
  s.set_del(j, false);
  s.n_alloc = j + 1;
  return true;
}

template <typename T>
__device__ bool rebuild_due(const Walk<T>& s) {
  return s.m > 0 && 2 * s.dhits >= s.m;
}

// One op of the run_ops list; returns false when an insert found no
// free slot (nothing written).
template <typename T>
__device__ bool op_step(Walk<T>& s, int kind, int k, bool u, int& r,
                        int& steps) {
  int slot;
  r = 0;
  find(s, k, slot, steps);
  const bool present = slot >= 0;
  const bool marked = present && s.del(slot);
  if (kind == OP_CONTAINS) {
    r = present && !marked;
    if (present && u) {
      update(s, k, T(1));
      if (marked) s.dhits += T(1);
    }
  } else if (kind == OP_INSERT) {
    r = !present || marked;
    if (marked) {
      s.set_del(slot, false);
      s.dhits -= s.sh(slot);
      s.size += 1;
      update(s, k, T(1));
    } else if (present) {
      if (u) update(s, k, T(1));
    } else {
      if (!link_bottom(s, k)) return false;
      s.size += 1;
      update(s, k, T(1));
    }
  } else {  // delete
    r = present && !marked;
    if (r) {
      s.set_del(slot, true);
      s.size -= 1;
      update(s, k, T(1));
      s.dhits += s.sh(slot);
    } else if (marked && u) {
      update(s, k, T(1));
      s.dhits += T(1);
    }
  }
  return true;
}

// mode 0: the run_ops op list (kinds/keys/upd -> res/plen), stopping
//         after the op that makes a rebuild due;
// mode 1: the weighted fold list of run_contains_batch (keys/w/wm).
// status[0] = index of the op where the kernel stopped (n: ran to the
// end); status[1] = 1 when an insert found the capacity exhausted.
template <typename T>
__global__ void __launch_bounds__(32)
    fold_kernel(State<T> st, int mode, int start, int n, const int* kinds,
                const int* keys, const bool* upd, const T* w, const T* wm,
                int* res, int* plen, int* status) {
  const int lane = threadIdx.x;
  const bool walker = lane == 0;
  Walk<T> s;
  if (walker) s.load(st);
  int stop_at = n;
  bool exhausted = false;
  if (mode == 1) {
    for (int base = start; base < n; base += 32 * kPer) {
      int k[kPer];
      T wi[kPer], wmi[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int j = base + 32 * r + lane;
        k[r] = j < n ? keys[j] : 0;
        wi[r] = j < n ? w[j] : T(0);
        wmi[r] = j < n ? wm[j] : T(0);
      }
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        for (unsigned ball = __ballot_sync(0xffffffffu, wi[r] > 0); ball;
             ball &= ball - 1) {
          const int src = __ffs(ball) - 1;
          const int kj = __shfl_sync(0xffffffffu, k[r], src);
          const T wj = __shfl_sync(0xffffffffu, wi[r], src);
          const T wmj = __shfl_sync(0xffffffffu, wmi[r], src);
          if (walker) {
            update(s, kj, wj);
            s.dhits += wmj;
          }
          __syncwarp();
        }
      }
    }
  } else if (walker && start < n) {
    int kind = kinds[start], k = keys[start];
    bool u = upd[start];
    for (int i = start; i < n; ++i) {
      const int j = min(i + 1, n - 1);
      const int kind_n = kinds[j], k_n = keys[j];
      const bool u_n = upd[j];
      int r, steps;
      if (!op_step<T>(s, kind, k, u, r, steps)) {
        exhausted = true;
        stop_at = i;
        break;
      }
      res[i] = r;
      plen[i] = steps;
      if (kind != OP_INSERT && rebuild_due<T>(s)) {
        stop_at = i;
        break;
      }
      kind = kind_n;
      k = k_n;
      u = u_n;
    }
  }
  if (walker) {
    s.store();
    status[0] = stop_at;
    status[1] = exhausted;
  }
}

template <typename T>
int launch(int* key, int* nxt, T* hits, T* selfhits, int* top, int* nzero,
           bool* deleted, T* m, T* dhits, int* zl, int* n_alloc, int* size,
           int C, int L, int mode, int start, int n, const int* kinds,
           const int* keys, const bool* upd, const T* w, const T* wm,
           int* res, int* plen, int* status, void* stream) {
  // the largest L1 carveout
  const cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return static_cast<int>(err);
  State<T> s{key, nxt, hits, selfhits, top, nzero, deleted, m, dhits,
             zl, n_alloc, size, C, L};
  fold_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
