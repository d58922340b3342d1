// hash_match: for each query node, the least property-table row whose eight
// key-hash lanes and owner equal the query's, else -1.
//
// Replaces the Pallas TPU kernel `hash_match_pallas` (src/repro/kernels/
// hash_match.py), which tiles the (nodes x rows) compare space and carries a
// running minimum across the row tiles in a revisited output block.  Here one
// thread owns one query and scans the table in ascending row order, so the
// first full match is the least row and no cross-block reduction exists.
//
// Bound on the H100: memory.  Each query reads 36 bytes and writes 4; the
// table (tens to a few hundred rows) is staged once per block in shared
// memory and read as broadcasts.  A query whose owner is -1 (the padding
// owner: not an object member) matches nothing and skips the scan.
//
// Lanes are compared as int32 views of the uint32 hash words: equality is
// bit-identical either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // table rows staged in shared memory per pass

__global__ void hash_match_kernel(const int4* __restrict__ q_lanes,  // (N, 8) as 2 x int4
                                  const int* __restrict__ q_owner,   // (N,)
                                  const int* __restrict__ t_lanes,   // (M, 8)
                                  const int* __restrict__ t_owner,   // (M,)
                                  int* __restrict__ out,             // (N,)
                                  int n, int m) {
  __shared__ int s_lanes[kChunk][8];
  __shared__ int s_owner[kChunk];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int owner = -1;
  int4 a = make_int4(0, 0, 0, 0), b = make_int4(0, 0, 0, 0);
  if (i < n) {
    owner = q_owner[i];
    a = q_lanes[2 * i];
    b = q_lanes[2 * i + 1];
  }
  int found = -1;
  bool done = owner == -1;

  for (int base = 0; base < m; base += kChunk) {
    // stop once every thread of the block has its answer
    if (__syncthreads_and(done)) break;
    const int rows = min(kChunk, m - base);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      s_owner[r] = t_owner[base + r];
#pragma unroll
      for (int l = 0; l < 8; ++l) s_lanes[r][l] = t_lanes[(base + r) * 8 + l];
    }
    __syncthreads();
    if (!done) {
      for (int r = 0; r < rows; ++r) {
        if (s_owner[r] == owner && s_lanes[r][0] == a.x && s_lanes[r][1] == a.y &&
            s_lanes[r][2] == a.z && s_lanes[r][3] == a.w && s_lanes[r][4] == b.x &&
            s_lanes[r][5] == b.y && s_lanes[r][6] == b.z && s_lanes[r][7] == b.w) {
          found = base + r;
          done = true;
          break;
        }
      }
    }
  }
  if (i < n) out[i] = found;
}

}  // namespace

extern "C" int hash_match(const void* q_lanes, const void* q_owner, const void* t_lanes,
                          const void* t_owner, void* out, int n, int m, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    hash_match_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(q_lanes), static_cast<const int*>(q_owner),
        static_cast<const int*>(t_lanes), static_cast<const int*>(t_owner),
        static_cast<int*>(out), n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
