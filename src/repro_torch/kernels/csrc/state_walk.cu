// Kernel W: the batched state walk of both engines' find_batch, on the card.
//
// Replaces: no Pallas kernel.  In the JAX package find_batch is a
// vmapped lax.while_loop over the state (src/repro/core/splaylist.py:157
// find, with _eff_next at :119; src/repro/core/skiplist.py:160 find),
// which XLA compiles into the jitted run_contains_batch, so one batch is
// one device program.  Eager PyTorch would step every lane of the batch
// together and ask the host after each step whether any lane is still
// walking; this kernel keeps the whole walk on the card, one launch per
// batch.  It exists for the same reason as kernels F and S
// (splay_fold.cu, skip_fold.cu), which fold the same states.
//
// Bound: latency.  Each lane is a chain of dependent loads (nzero and
// nxt of its predecessor, then the key of the successor), and the batch
// waits for its longest lane.  The lanes are independent and read-only,
// so one thread walks one query, mirroring the reference step for step:
//
//   splay_walk  pred = HEAD, h = L - 1; while h >= zl and not found:
//               curr = nxt[max(h, nzero[pred])][pred]; advance when
//               key[curr] <= k, else found = key[pred] == k and descend;
//               one step either way.  zl is read from device memory.
//   skip_walk   the same loop with curr = nxt[h][pred] and the stop at
//               h >= 0.
//   both        found |= key[pred] == k at the end; slot = pred when
//               found and pred is not the head, else -1.
//
// A negative slot index wraps, as the reference's gathers do.  A lane
// walks at most once past each slot (keys rise strictly along a walk)
// and descends at most L times, so a lane that reaches C + L + 1 steps
// is on a corrupted state: it stops and writes 1 to the status word.  A
// slot index outside [-C, C), or an nzero above the top row, stops it
// too, with 2.  The wrapper reads the word once per launch and raises,
// so a bad state fails loudly instead of hanging the card.  Keys
// >= POS_INF_32, whose walk runs past the tail sentinel, are refused by
// the callers before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HEAD = 0;
constexpr int kThreads = 256;
constexpr int kStepBound = 1;    // status: a lane reached C + L + 1 steps
constexpr int kBadSlot = 2;      // status: a slot outside [-C, C) or a
                                 // lazy level above the top row

__device__ __forceinline__ int wrap(int i, int C) { return i < 0 ? i + C : i; }

// kLazy: the splay-list's lazy expansion (a node's levels below
// nzero[pred] read the link at nzero[pred]) and its moving bottom zl.
template <bool kLazy>
__global__ void walk_kernel(const int* __restrict__ key,
                            const int* __restrict__ nxt,
                            const int* __restrict__ nzero,
                            const int* __restrict__ zl_p, int C, int L,
                            int n, const int* __restrict__ ks,
                            int* __restrict__ slot_out,
                            int* __restrict__ steps_out, int* status) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = ks[i];
  const int zl = kLazy ? *zl_p : 0;
  const int bound = C + L + 1;
  // pred keeps the raw slot index, as the reference's carry does; every
  // read wraps it
  int pred = HEAD, h = L - 1, steps = 0;
  bool found = false;
  while (h >= zl && !found) {
    if (steps == bound) {
      *status = kStepBound;
      break;
    }
    const int p = wrap(pred, C);
    const int lvl = kLazy ? max(h, nzero[p]) : h;
    if (lvl > L) {
      *status = kBadSlot;
      break;
    }
    const int curr = nxt[static_cast<int64_t>(lvl) * C + p];
    if (curr < -C || curr >= C) {
      *status = kBadSlot;
      break;
    }
    if (key[wrap(curr, C)] <= k) {
      pred = curr;
    } else {
      found = key[p] == k;
      --h;
    }
    ++steps;
  }
  found = found || key[wrap(pred, C)] == k;
  slot_out[i] = (found && pred != HEAD) ? pred : -1;
  steps_out[i] = steps;
}

int grid_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// L is the engine's max_level: nxt holds L + 1 rows for the splay-list
// (the sentinel level on top) and L rows for the skip-list; both walks
// start at row L - 1.
extern "C" int splay_walk(const int* key, const int* nxt, const int* nzero,
                          const int* zl, int C, int L, int n, const int* ks,
                          int* slot, int* steps, int* status, void* stream) {
  walk_kernel<true><<<grid_of(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      key, nxt, nzero, zl, C, L, n, ks, slot, steps, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int skip_walk(const int* key, const int* nxt, int C, int L, int n,
                         const int* ks, int* slot, int* steps, int* status,
                         void* stream) {
  walk_kernel<false><<<grid_of(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      key, nxt, nullptr, nullptr, C, L, n, ks, slot, steps, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
