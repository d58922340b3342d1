// hash_match: for each query node, the least property-table row whose eight
// key-hash lanes and owner equal the query's, else -1.  Every owner is an
// owner like any other: a query with owner -1 matches a table row with
// owner -1 (the JAX package's semantics; its wrapper pads the table with
// owner -9 rows, which this kernel never sees).
//
// Replaces the Pallas TPU kernel `hash_match_pallas` (src/repro/kernels/
// hash_match.py), which tiles the (nodes x rows) compare space into VMEM
// blocks and carries a running minimum across the row tiles in a revisited
// output block.
//
// Bound on the H100: memory, and at these sizes the latency of getting it
// in flight.  The table is small (M = 4..20 rows on the executor's paths,
// hundreds in the adversarial cases); a query needs its 4-byte owner and
// its 4-byte answer, and its 32 lane bytes only when some table row has
// its owner.  In the dense layout almost no query's owner occurs (only the
// nodes at the current depth have one >= 0), so the owners are most of the
// bytes.  The design:
//  - owner first: a query reads its owner, finds the least staged row with
//    that owner, and loads its lanes only if there is one; exact for every
//    owner, -1 included.  The owner load is issued before the table is
//    staged, so the two overlap;
//  - a persistent grid of a few blocks per SM walks query tiles
//    grid-stride; each block stages the table once (owners, and lanes as
//    int4 pairs) in shared memory for M up to kCap rows; a larger table is
//    walked in kCap-row chunks inside the same kernel, restaged per tile;
//  - one query per thread: on the card two or more a thread were no
//    faster (PERF.md);
//  - rows are scanned in ascending order from the first row with the
//    query's owner, comparing owner and lanes, so the first full match is
//    the least row; one coalesced 4-byte store per query.
//
// Lanes are compared as int32 views of the uint32 hash words: equality is
// bit-identical either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCap = 1024;  // table rows staged in shared memory (36 B each)

__device__ __forceinline__ bool lanes_equal(int4 a, int4 b, int4 ta, int4 tb) {
  return a.x == ta.x && a.y == ta.y && a.z == ta.z && a.w == ta.w && b.x == tb.x &&
         b.y == tb.y && b.z == tb.z && b.w == tb.w;
}

// table rows [base, base + rows) into shared memory
__device__ __forceinline__ void stage(const int4* __restrict__ t_lanes,
                                      const int* __restrict__ t_owner, int4* s_lanes,
                                      int* s_owner, int base, int rows) {
  for (int h = threadIdx.x; h < 2 * rows; h += blockDim.x) {
    s_lanes[h] = t_lanes[2 * static_cast<long long>(base) + h];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s_owner[r] = t_owner[base + r];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
hash_match_kernel(const int4* __restrict__ q_lanes,  // (N, 8) as 2 x int4
                  const int* __restrict__ q_owner,   // (N,)
                  const int4* __restrict__ t_lanes,  // (M, 8) as 2 x int4
                  const int* __restrict__ t_owner,   // (M,)
                  int* __restrict__ out,             // (N,)
                  int n, int m) {
  extern __shared__ int4 smem[];
  const int cap = min(m, kCap);
  int4* s_lanes = smem;                                   // 2 x int4 per row
  int* s_owner = reinterpret_cast<int*>(smem + 2 * cap);  // owner per row
  const bool resident = m <= kCap;  // the whole table staged once per block
  bool staged = false;

  // the loop bound is block-uniform: every thread reaches the barriers
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads; base < n;
       base += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const int owner = valid ? q_owner[i] : 0;
    int found = -1;
    bool loaded = false;
    int4 la = make_int4(0, 0, 0, 0), lb = la;
    for (int c0 = 0; c0 < m; c0 += kCap) {
      const int rows = min(kCap, m - c0);
      if (!staged) {  // block-uniform
        if (!resident) __syncthreads();  // every thread is done with the last chunk
        stage(t_lanes, t_owner, s_lanes, s_owner, c0, rows);
        staged = resident;
      }
      if (!valid || found >= 0) continue;
      // owner first: the least staged row carrying the query's owner
      int first = rows;
      for (int r = rows - 1; r >= 0; --r) first = s_owner[r] == owner ? r : first;
      if (first == rows) continue;
      if (!loaded) {  // lanes only where the owner occurs
        la = q_lanes[2 * i];
        lb = q_lanes[2 * i + 1];
        loaded = true;
      }
      for (int r = first; r < rows; ++r) {
        if (s_owner[r] == owner && lanes_equal(la, lb, s_lanes[2 * r], s_lanes[2 * r + 1])) {
          found = c0 + r;
          break;
        }
      }
    }
    if (valid) out[i] = found;
  }
}

}  // namespace

extern "C" int hash_match(const void* q_lanes, const void* q_owner, const void* t_lanes,
                          const void* t_owner, void* out, int n, int m, void* stream) {
  if (n > 0) {
    const int cap = m < kCap ? m : kCap;
    const size_t smem = static_cast<size_t>(cap) * (2 * sizeof(int4) + sizeof(int));
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_match_kernel, kThreads,
                                                          smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (n + static_cast<long long>(kThreads) - 1) / kThreads;
    const long long resident_blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(tiles < resident_blocks ? tiles : resident_blocks);
    hash_match_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(q_lanes), static_cast<const int*>(q_owner),
        static_cast<const int4*>(t_lanes), static_cast<const int*>(t_owner),
        static_cast<int*>(out), n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
