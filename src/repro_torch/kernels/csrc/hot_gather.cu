// Kernels B3 and B4: the two row gathers of the splay vocab tier.
//
// B4 gather_rows replaces the Pallas _copy_kernel
// (src/repro/kernels/hot_gather.py:27): out[i] = table[ids[i]], one row
// streamed from device memory per id.
// B3 gather_hot replaces the Pallas _hot_kernel
// (src/repro/kernels/hot_gather.py:56): out[i] = hot_buf[ranks[i]].  On
// the TPU the whole [h, d] hot buffer is one VMEM block.  A Hopper block
// holds at most 227 KB of shared memory, and minitron-8b's hot buffer is
// 4096 x 4096 x 2 B = 33.5 MB, so here the buffer is "resident in L2"
// instead (50 MB): repeated hot rows are served from L2 by the cache's
// own replacement, not pinned.  Pinning it (an L2 persisting access
// window) is redesign work.
//
// Both are the same dtype-blind copy: one warp per id copies
// row_bytes bytes, as 16-byte vectors when the two base pointers and
// the row length allow it, else 8-, 4-, 2- or 1-byte words.  Index
// semantics follow the reference's gathers: a negative id wraps once
// (-1 -> n - 1), anything still outside [0, n - 1] clamps to it.
// Bound: bytes.  Each id reads one row and writes one row; the kernel
// keeps four vector loads in flight per lane before it stores them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

template <typename V>
__global__ void copy_rows(const char* __restrict__ src,
                          const int* __restrict__ ids, int n, int q,
                          long long row_bytes, char* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= q) return;
  int id = ids[row];
  if (id < 0) id += n;  // no overflow: id >= -2^31 and 0 < n < 2^31
  id = min(max(id, 0), n - 1);
  const V* s = reinterpret_cast<const V*>(src + id * row_bytes);
  V* o = reinterpret_cast<V*>(out + row * row_bytes);
  const long long nv = row_bytes / static_cast<long long>(sizeof(V));
  long long j = lane;
  for (; j + (kUnroll - 1) * 32 < nv; j += kUnroll * 32) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[j + u * 32];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) o[j + u * 32] = v[u];
  }
  for (; j < nv; j += 32) o[j] = s[j];
}

int launch(const void* src, const int* ids, int n, int q, long long row_bytes,
           void* out, void* stream) {
  const int grid = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int block = 32 * kWarpsPerBlock;
  const auto* s = static_cast<const char*>(src);
  auto* o = static_cast<char*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) {
    copy_rows<uint4><<<grid, block, 0, st>>>(s, ids, n, q, row_bytes, o);
  } else if (a % 8 == 0) {
    copy_rows<uint2><<<grid, block, 0, st>>>(s, ids, n, q, row_bytes, o);
  } else if (a % 4 == 0) {
    copy_rows<unsigned><<<grid, block, 0, st>>>(s, ids, n, q, row_bytes, o);
  } else if (a % 2 == 0) {
    copy_rows<unsigned short><<<grid, block, 0, st>>>(s, ids, n, q,
                                                      row_bytes, o);
  } else {
    copy_rows<unsigned char><<<grid, block, 0, st>>>(s, ids, n, q,
                                                     row_bytes, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B4: out[i] = table[ids[i]], table [n, row_bytes] (any dtype)
extern "C" int gather_rows(const void* table, const int* ids, int n, int q,
                           long long row_bytes, void* out, void* stream) {
  return launch(table, ids, n, q, row_bytes, out, stream);
}

// B3: out[i] = hot_buf[ranks[i]], hot_buf [h, row_bytes] (any dtype)
extern "C" int gather_hot(const void* hot_buf, const int* ranks, int h,
                          int q, long long row_bytes, void* out,
                          void* stream) {
  return launch(hot_buf, ranks, h, q, row_bytes, out, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
