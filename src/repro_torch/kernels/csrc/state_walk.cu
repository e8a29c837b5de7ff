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
// The function, one thread a query, step for step as the reference:
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
// Bound: latency.  A lane is a chain of dependent loads and the batch
// waits for its longest lane.  Run as written, a step's three loads
// depend one on the next: nzero[pred], then nxt[lvl][pred], then
// key[curr].  This kernel pays one dependent round a step:
//
//   carried  pred, key[pred], nzero[pred] and curr, the link the step
//            tests, are in registers when the step starts.
//   a round  the lane issues together key[curr] and nzero[curr], the
//            link it needs if it advances, nxt[h][curr] (speculating
//            that nzero[curr] <= h), and the link it needs if it
//            descends, nxt[max(h - 1, nzero[pred])][pred] (only while
//            h - 1 >= zl).  Selects, not branches, pick one (the lanes
//            of a warp advance and descend in any mix); the next step's
//            curr is known.  Where nzero[curr] > h proves the
//            speculation wrong, the lane loads nxt[nzero[curr]][curr]
//            once more.
//   the head each block stages the head's column, nxt[0..rows)[HEAD],
//            and the key and nzero of every slot it links to, in shared
//            memory (two cooperative rounds); every lane's steps at the
//            head read from there.  64 threads a block.
//
// Measured on the card (PERF.md §6; graph replay at the phase-7
// shape, the paper serving state and 4096 queries): this design
// 0.0138-0.0140 ms a launch; with the head read from global memory
// 0.0208-0.0211; with the step's two outcomes as branches
// 0.0148-0.0159; with the round's loads through generic pointers picked
// by selects (no branch between shared and global memory)
// 0.0178-0.0179; at 32, 128 and 256 threads a block 0.0139, 0.0142 and
// 0.0147-0.0148.
//
// No speculative load can fault: a link is used as an address only
// after the check that it lies in [-C, C), and a level only after the
// check that it lies in [0, L]; a speculative link that the lane does
// not take is dropped unchecked.  A negative slot index wraps, as the
// reference's gathers do.  A lane walks at most once past each slot
// (keys rise strictly along a walk) and descends at most L times, so a
// lane that reaches C + L + 1 steps is on a corrupted state.  The
// status word collects bit flags with atomicOr, so no cause overwrites
// another: 1 a lane reached the step bound, 2 a link outside [-C, C) or
// a level outside [0, L] on the path a lane takes, 4 a key
// >= POS_INF_32, whose walk runs past the tail sentinel and never ends
// (that lane does not walk: slot -1, steps 0).  The wrapper reads the
// word once per launch and raises, so a bad state or key fails loudly
// instead of hanging the card, and the walk, read-only, leaves the
// state as it was.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HEAD = 0;
constexpr int POS_INF_32 = 0x7fffffff;
constexpr int kStepBound = 1;    // status: a lane reached C + L + 1 steps
constexpr int kBadSlot = 2;      // status: a slot outside [-C, C) or a
                                 // level outside [0, L]
constexpr int kRefusedKey = 4;   // status: a key >= POS_INF_32

__device__ __forceinline__ int wrap(int i, int C) { return i < 0 ? i + C : i; }

// kLazy: the splay-list's lazy expansion (a node's levels below
// nzero[pred] read the link at nzero[pred]) and its moving bottom zl.
// rows = the rows of nxt (L + 1 on the splay-list, L on the skip-list).
template <bool kLazy>
__global__ void walk_kernel(const int* __restrict__ key,
                            const int* __restrict__ nxt,
                            const int* __restrict__ nzero,
                            const int* __restrict__ zl_p, int C, int L,
                            int rows, int n, const int* __restrict__ ks,
                            int* __restrict__ slot_out,
                            int* __restrict__ steps_out, int* status) {
  // the head's column: link, the linked slot's key and nzero per row,
  // then the head's own key and nzero
  extern __shared__ int smem[];
  int* h_nxt = smem;
  int* h_key = smem + rows;
  int* h_nz = smem + 2 * rows;
  int* h_self = smem + 3 * rows;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    h_nxt[r] = nxt[static_cast<int64_t>(r) * C + HEAD];
  }
  if (threadIdx.x == 0) {
    h_self[0] = key[HEAD];
    h_self[1] = kLazy ? nzero[HEAD] : 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int c = h_nxt[r];
    const int w = (c >= -C && c < C) ? wrap(c, C) : HEAD;
    h_key[r] = key[w];
    h_nz[r] = kLazy ? nzero[w] : 0;
  }
  __syncthreads();
  // the link of slot s (in [0, C)) at row r (in [0, L])
  auto link = [&](int r, int s) {
    return s == HEAD ? h_nxt[r] : nxt[static_cast<int64_t>(r) * C + s];
  };

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = ks[i];
  if (k >= POS_INF_32) {
    atomicOr(status, kRefusedKey);
    slot_out[i] = -1;
    steps_out[i] = 0;
    return;
  }
  const int zl = kLazy ? *zl_p : 0;
  const int bound = C + L + 1;
  // pred keeps the raw slot index, as the reference's carry does; every
  // read wraps it.  from_head: curr is the head's link at row lvl, so
  // its key and nzero are in shared memory.
  int pred = HEAD, p = HEAD;
  int kp = h_self[0], nzp = h_self[1];
  int h = L - 1, steps = 0;
  bool found = false;
  int lvl = kLazy ? max(h, nzp) : h;
  bool bad = lvl < 0 || lvl > L;
  int curr = bad ? 0 : link(lvl, HEAD);
  bool from_head = true;
  while (h >= zl && !found) {
    if (steps == bound) {
      atomicOr(status, kStepBound);
      break;
    }
    if (bad || curr < -C || curr >= C) {
      atomicOr(status, kBadSlot);
      break;
    }
    const int c = wrap(curr, C);
    // one round: these loads depend only on c and p
    const int dlvl = kLazy ? max(h - 1, nzp) : h - 1;
    const bool more = h - 1 >= zl && dlvl >= 0;
    const int kc = from_head ? h_key[lvl] : key[c];
    const int nzc = kLazy ? (from_head ? h_nz[lvl] : nzero[c]) : 0;
    const int adv = link(h, c);
    const int desc = more ? link(dlvl, p) : 0;
    // the branch, as selects
    const bool up = kc <= k;
    found = !up && kp == k;
    pred = up ? curr : pred;
    p = up ? c : p;
    kp = up ? kc : kp;
    nzp = up ? nzc : nzp;
    h = up ? h : h - 1;
    lvl = up ? (kLazy ? max(h, nzc) : h) : dlvl;
    bad = lvl < 0 || lvl > L;
    curr = up ? adv : desc;
    // nzero[curr] > h: the speculated link was the wrong row
    if (kLazy && up && lvl != h && !bad) curr = link(lvl, c);
    from_head = p == HEAD;
    ++steps;
  }
  found = found || kp == k;
  slot_out[i] = (found && pred != HEAD) ? pred : -1;
  steps_out[i] = steps;
}

int grid_of(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// L is the engine's max_level: nxt holds L + 1 rows for the splay-list
// (the sentinel level on top) and L rows for the skip-list; both walks
// start at row L - 1.  threads: the block size.
extern "C" int splay_walk(const int* key, const int* nxt, const int* nzero,
                          const int* zl, int C, int L, int n, const int* ks,
                          int* slot, int* steps, int* status, int threads,
                          void* stream) {
  const int rows = L + 1;
  walk_kernel<true><<<grid_of(n, threads), threads,
                      (3 * rows + 2) * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(
      key, nxt, nzero, zl, C, L, rows, n, ks, slot, steps, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int skip_walk(const int* key, const int* nxt, int C, int L, int n,
                         const int* ks, int* slot, int* steps, int* status,
                         int threads, void* stream) {
  const int rows = L;
  walk_kernel<false><<<grid_of(n, threads), threads,
                       (3 * rows + 2) * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(
      key, nxt, nullptr, nullptr, C, L, rows, n, ks, slot, steps, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
