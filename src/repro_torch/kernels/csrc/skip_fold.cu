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
// Bound: latency.  The fold is a chain of dependent loads (nxt, then
// key, then the next nxt), one op after the other in a total order, so
// one thread walks the state, mirroring the reference op for op:
//
//   contains / delete  find: advance while key[nxt[h][pred]] <= k, else
//            descend; a match is seen only on a descent (or at the
//            end), and the path length counts every advance and
//            descent.  A delete marks a live match.
//   insert   _find_preds over all L levels; a marked match is revived,
//            a live one left alone; a new key takes slot n_alloc and is
//            linked bottom-up on levels 0..height, each level's old
//            successor read before the predecessor is pointed at it.
//            Its path length is 0, as in the reference.
//   scalars  n_alloc and size live in registers, written back once.
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
constexpr int kMaxLevels = 64;   // skip_fold.MAX_LEVELS

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

// The reference's find: (slot or -1), counting advances and descents.
__device__ int find(const Skip& s, int k, int& steps) {
  int pred = HEAD, h = s.L - 1;
  bool found = false;
  steps = 0;
  while (h >= 0 && !found) {
    const int curr = s.next(h, pred);
    if (s.key_of(curr) <= k) {
      pred = curr;
    } else {
      found = s.key_of(pred) == k;
      --h;
    }
    ++steps;
  }
  found = found || s.key_of(pred) == k;
  return (found && pred != HEAD) ? pred : -1;
}

__global__ void skip_fold_kernel(Skip s, int* n_alloc_p, int* size_p, int n,
                                 const int* __restrict__ kinds,
                                 const int* __restrict__ keys,
                                 const int* __restrict__ heights,
                                 bool* __restrict__ res,
                                 int* __restrict__ plen, int* status) {
  int n_alloc = *n_alloc_p, size = *size_p;
  int stop = n;
  int preds[kMaxLevels];
  for (int i = 0; i < n; ++i) {
    const int kind = kinds[i];
    const int k = keys[i];
    bool r;
    int steps = 0;
    if (kind == OP_INSERT) {
      int pred = HEAD;
      for (int h = s.L - 1; h >= 0; --h) {
        for (int nx = s.next(h, pred); s.key_of(nx) <= k;
             nx = s.next(h, pred)) {
          pred = nx;
        }
        preds[h] = pred;
      }
      const bool present = s.key_of(pred) == k;
      const bool marked = present && s.deleted[s.wrap(pred)];
      if (marked) {
        s.deleted[s.wrap(pred)] = false;
        ++size;
      } else if (!present) {
        const int j = n_alloc;
        if (j >= s.C) {
          stop = i;
          break;
        }
        const int height = heights[i];
        for (int h = 0; h < s.L; ++h) {
          if (h <= height) {
            int& link = s.next(h, preds[h]);
            s.next(h, j) = link;
            link = j;
          } else {
            s.next(h, j) = -1;
          }
        }
        s.key[j] = k;
        s.top[j] = height;
        s.deleted[j] = false;
        ++n_alloc;
        ++size;
      }
      r = !present || marked;
    } else {
      const int slot = find(s, k, steps);
      r = slot >= 0 && !s.deleted[slot];
      if (r && kind == OP_DELETE) {
        s.deleted[slot] = true;
        --size;
      }
    }
    res[i] = r;
    plen[i] = steps;
  }
  *n_alloc_p = n_alloc;
  *size_p = size;
  status[0] = stop;
}

}  // namespace

extern "C" int skip_fold(int* key, int* nxt, int* top, bool* deleted,
                         int* n_alloc, int* size, int C, int L, int n,
                         const int* kinds, const int* keys,
                         const int* heights, bool* res, int* plen,
                         int* status, void* stream) {
  // the largest L1 carveout: every op's walk starts at the head and
  // revisits the top of the list
  const cudaError_t err = cudaFuncSetAttribute(
      skip_fold_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return static_cast<int>(err);
  Skip s{key, nxt, top, deleted, C, L};
  skip_fold_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n_alloc, size, n, kinds, keys, heights, res, plen, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
