// Kernels B3 and B4 and the fused two-tier gather of the splay vocab
// tier: one row-copy engine under three modes.
//
//   kCold  (B4, gather_rows): out[i] = table[ids[i]].  Replaces the
//          Pallas _copy_kernel (src/repro/kernels/hot_gather.py:27).
//   kHot   (B3, gather_hot):  out[i] = hot_buf[ids[i]].  Replaces the
//          Pallas _hot_kernel (src/repro/kernels/hot_gather.py:56).
//   kFused (hot_gather):      r = hot_rank[ids[i]];
//          out[i] = r >= 0 ? hot_buf[r] : table[ids[i]].  Replaces the
//          reference's composition of B3, B4 and a where-merge
//          (src/repro/kernels/ops.py:148 hot_gather), which writes three
//          [q, d] blocks and reads two of them back.
//
// Bound: bytes.  A mode writes each output row once and needs each
// distinct source row once (plus the ids and, fused, one hot-rank entry
// per id); the fused mode writes no [q, d] intermediate.
//
// Index rule, as the reference's gathers: ids are int32 or int64 (an
// int64 id keeps its low 32 bits, as .to(torch.int32) keeps them); a
// negative index wraps once (-1 -> n - 1) and what is still outside
// [0, n - 1] clamps.  hot_rank, the hot buffer and the table each
// resolve against their own length.
//
// Residency: on the TPU the whole [h, d] hot buffer is one VMEM block.
// A Hopper block has 227 KB of shared memory and minitron-8b's hot
// buffer is 4096 x 4096 x 2 B = 33.5 MB, so here it is left to the
// 50 MB L2, under priorities: hot-row reads carry an L2 evict_last
// policy, cold-table reads and every output store evict_first, so that
// the streams of a lookup pass by the hot rows rather than push them
// out.  Nothing device-wide (no
// access-policy window, no persisting-L2 carve-out) is set: it would
// outlive the call.
//
// Two copy paths, chosen by the wrapper from the row length and the
// base addresses (hot_gather.py copy_path), never as a fallback:
//   bulk   (row bytes and bases 16-byte multiples): TMA bulk copies.  A
//          persistent grid of one-warp blocks, a few per SM, each owning
//          a contiguous range of rows.  Each block keeps a ring of row
//          slots in dynamic shared memory under one mbarrier per slot.
//          The warp resolves 32 rows' sources at a time; lane 0 issues
//          one bulk load per slot (completing on the slot's mbarrier),
//          writes each arrived slot out with a bulk store, and waits for
//          the store kLag groups back to have read its slot before it
//          loads that slot again.  A row longer than a slot is copied in
//          slot-sized chunks.
//   vector (any other row): one warp per row in 8-, 4-, 2- or 1-byte
//          words, four loads in flight per lane, with the same L2
//          policies on each load and store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kCold = 0, kHot = 1, kFused = 2 };

constexpr int kWarpsPerBlock = 8;       // vector path
constexpr int kUnroll = 4;
constexpr int kRingBytes = 64 * 1024;   // bulk path: ring of slots a block
constexpr int kSlotCap = 8 * 1024;      // so a ring holds >= 8 slots
constexpr int kMaxSlots = 16;
constexpr int kBarBytes = 128;          // kMaxSlots mbarriers of 8 B
constexpr int kLag = 3;                 // bulk stores in flight per block
constexpr int kMaxBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

struct Rows {
  const char* table;
  int n;
  const char* hot;
  int h;
  const int* hot_rank;
  int nr;
  const void* ids;
  int ids64;
  int q;
  long long row_bytes;
  char* out;
};

__device__ __forceinline__ int take(int i, int n) {
  if (i < 0) i += n;  // no overflow: i >= -2^31 and 0 < n < 2^31
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ int load_id(const Rows& p, int i) {
  if (p.ids64)
    return static_cast<int>(static_cast<unsigned>(
        static_cast<const unsigned long long*>(p.ids)[i]));
  return static_cast<const int*>(p.ids)[i];
}

// The source row of output row i, and whether it is a hot-buffer row.
template <int kMode>
__device__ __forceinline__ const char* source(const Rows& p, int i,
                                              bool& hot) {
  const int id = load_id(p, i);
  if (kMode == kCold) {
    hot = false;
    return p.table + take(id, p.n) * p.row_bytes;
  }
  if (kMode == kHot) {
    hot = true;
    return p.hot + take(id, p.h) * p.row_bytes;
  }
  const int r = p.hot_rank[take(id, p.nr)];
  hot = r >= 0;
  return hot ? p.hot + take(r, p.h) * p.row_bytes
             : p.table + take(id, p.n) * p.row_bytes;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// ---- vector path: loads and stores under an L2 cache policy ----------

__device__ __forceinline__ uint2 ld(const uint2* p, uint64_t pol) {
  uint2 v;
  asm volatile("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned ld(const unsigned* p, uint64_t pol) {
  unsigned v;
  asm volatile("ld.global.L2::cache_hint.u32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned short ld(const unsigned short* p,
                                             uint64_t pol) {
  unsigned short v;
  asm volatile("ld.global.L2::cache_hint.u16 %0, [%1], %2;"
               : "=h"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned char ld(const unsigned char* p,
                                            uint64_t pol) {
  unsigned v;
  asm volatile("ld.global.L2::cache_hint.u8 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return static_cast<unsigned char>(v);
}

__device__ __forceinline__ void st(uint2* p, uint2 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.u32 [%0], {%1, %2}, %3;"
               :: "l"(p), "r"(v.x), "r"(v.y), "l"(pol) : "memory");
}
__device__ __forceinline__ void st(unsigned* p, unsigned v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.u32 [%0], %1, %2;"
               :: "l"(p), "r"(v), "l"(pol) : "memory");
}
__device__ __forceinline__ void st(unsigned short* p, unsigned short v,
                                   uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.u16 [%0], %1, %2;"
               :: "l"(p), "h"(v), "l"(pol) : "memory");
}
__device__ __forceinline__ void st(unsigned char* p, unsigned char v,
                                   uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.u8 [%0], %1, %2;"
               :: "l"(p), "r"(static_cast<unsigned>(v)), "l"(pol)
               : "memory");
}

template <int kMode, typename V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    vector_rows(Rows p) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.q) return;
  bool hot;
  const V* s = reinterpret_cast<const V*>(source<kMode>(p, row, hot));
  V* o = reinterpret_cast<V*>(p.out + row * p.row_bytes);
  const uint64_t out_pol = evict_first();
  const uint64_t in_pol = hot ? evict_last() : out_pol;
  const long long nv = p.row_bytes / static_cast<long long>(sizeof(V));
  long long j = lane;
  for (; j + (kUnroll - 1) * 32 < nv; j += kUnroll * 32) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld(s + j + u * 32, in_pol);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) st(o + j + u * 32, v[u], out_pol);
  }
  for (; j < nv; j += 32) st(o + j, ld(s + j, in_pol), out_pol);
}

// ---- bulk path: TMA bulk copies through a ring of shared slots -------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(pol) : "memory");
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

__device__ __forceinline__ void bulk_store(char* dst, uint32_t src,
                                           uint32_t bytes, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;"
      :: "l"(dst), "r"(src), "r"(bytes), "l"(pol) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int kMode>
__global__ void __launch_bounds__(32)
    bulk_rows(Rows p, int rows_per_block, int slot_bytes, int n_slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, p.q - r0);
  if (nrows <= 0) return;
  const int cpr = static_cast<int>((p.row_bytes + slot_bytes - 1) /
                                   slot_bytes);
  const int units = nrows * cpr;          // (row, chunk) pairs, in order
  const uint32_t bars = smem_addr(smem);
  const uint32_t ring = bars + kBarBytes;
  const uint64_t hot_pol = evict_last();
  const uint64_t cold_pol = evict_first();
  if (lane == 0) {
    for (int s = 0; s < n_slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // Lane l holds the source of row 32 * batch + l of the block; lane 0
  // reads the one it loads next through a shuffle.  Called by the whole
  // warp with the same v, in increasing order.
  int batch = -1;
  const char* mine = nullptr;
  int mine_hot = 0;
  auto issue = [&](int v) {
    const int k = v / cpr;
    const int c = v - k * cpr;
    if ((k >> 5) != batch) {
      batch = k >> 5;
      const int kk = (batch << 5) + lane;
      if (kk < nrows) {
        bool hot;
        mine = source<kMode>(p, r0 + kk, hot);
        mine_hot = hot;
      }
    }
    const char* src = reinterpret_cast<const char*>(__shfl_sync(
        0xffffffffu, reinterpret_cast<unsigned long long>(mine), k & 31));
    const int hot = __shfl_sync(0xffffffffu, mine_hot, k & 31);
    if (lane == 0) {
      const long long off = static_cast<long long>(c) * slot_bytes;
      const auto bytes = static_cast<uint32_t>(
          min(static_cast<long long>(slot_bytes), p.row_bytes - off));
      const int s = v % n_slots;
      bulk_load(ring + s * slot_bytes, src + off, bytes, bars + 8 * s,
                hot ? hot_pol : cold_pol);
    }
  };

  for (int v = 0; v < min(n_slots, units); ++v) issue(v);
  for (int u = 0; u < units; ++u) {
    if (lane == 0) {
      const int s = u % n_slots;
      bar_wait(bars + 8 * s, (u / n_slots) & 1);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const int k = u / cpr;
      const long long off = static_cast<long long>(u - k * cpr) * slot_bytes;
      const auto bytes = static_cast<uint32_t>(
          min(static_cast<long long>(slot_bytes), p.row_bytes - off));
      bulk_store(p.out + (r0 + k) * p.row_bytes + off, ring + s * slot_bytes,
                 bytes, cold_pol);
      // the store kLag groups back has read its slot: that slot is free
      asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kLag)
                   : "memory");
    }
    __syncwarp();
    const int v = u - kLag + n_slots;     // the next unit of that slot
    if (u >= kLag && v < units) issue(v);
  }
  // the slots must outlive the stores' reads; the writes themselves are
  // complete when the grid is
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <int kMode>
cudaError_t launch_bulk(const Rows& p, cudaStream_t st) {
  static int blocks_per_sm[kMaxDevices];
  const int smem = kBarBytes + kRingBytes;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (blocks_per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(bulk_rows<kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    int bps = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps, bulk_rows<kMode>, 32, smem);
    if (e != cudaSuccess) return e;
    blocks_per_sm[dev] = min(max(bps, 1), kMaxBlocksPerSm);
  }
  const int slot = static_cast<int>(
      p.row_bytes < kSlotCap ? p.row_bytes : kSlotCap);
  const int n_slots = min(kMaxSlots, kRingBytes / slot);
  int grid = min(p.q, sms * blocks_per_sm[dev]);
  const int rows_per_block = (p.q + grid - 1) / grid;
  grid = (p.q + rows_per_block - 1) / rows_per_block;
  if (static_cast<long long>(rows_per_block) *
          ((p.row_bytes + slot - 1) / slot) > INT32_MAX)
    return cudaErrorInvalidValue;
  bulk_rows<kMode><<<grid, 32, smem, st>>>(p, rows_per_block, slot,
                                           n_slots);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_vector(const Rows& p, int unit, cudaStream_t st) {
  const int grid = (p.q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int block = 32 * kWarpsPerBlock;
  switch (unit) {
    case 8: vector_rows<kMode, uint2><<<grid, block, 0, st>>>(p); break;
    case 4: vector_rows<kMode, unsigned><<<grid, block, 0, st>>>(p); break;
    case 2:
      vector_rows<kMode, unsigned short><<<grid, block, 0, st>>>(p);
      break;
    case 1:
      vector_rows<kMode, unsigned char><<<grid, block, 0, st>>>(p);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch(const Rows& p, int unit, cudaStream_t st) {
  return unit == 16 ? launch_bulk<kMode>(p, st)
                    : launch_vector<kMode>(p, unit, st);
}

}  // namespace

// mode 0 (B4): out[i] = table[ids[i]]; mode 1 (B3): out[i] = hot[ids[i]];
// mode 2: the fused two-tier gather.  table [n, row_bytes] and hot
// [h, row_bytes] of any dtype, hot_rank [nr] int32, ids [q] int32 or
// (ids64) int64, out [q, row_bytes].  unit: 16 for the bulk path, else
// the vector path's word size (8, 4, 2 or 1), as copy_path chose it.
extern "C" int gather(int mode, const void* table, int n, const void* hot,
                      int h, const int* hot_rank, int nr, const void* ids,
                      int ids64, int q, long long row_bytes, int unit,
                      void* out, void* stream) {
  const Rows p{static_cast<const char*>(table), n,
               static_cast<const char*>(hot), h, hot_rank, nr, ids, ids64,
               q, row_bytes, static_cast<char*>(out)};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case kCold: e = launch<kCold>(p, unit, st); break;
    case kHot: e = launch<kHot>(p, unit, st); break;
    case kFused: e = launch<kFused>(p, unit, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
