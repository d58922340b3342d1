// assertion_eval_window: the (N, W) int8 pass matrix of every document node
// against the assertion rows of its own owner-sorted CSR window.
//
// Replaces the Pallas TPU kernel `assertion_eval_window_pallas` (src/repro/
// kernels/assertion_eval.py, body `_assertion_window_kernel` plus the shared
// `_eval_rows`).  The TPU version relays the (N, W, 8) window hashes
// lane-major so every slice stays rank-2 in VMEM; here one thread owns one
// (node, slot) pair and reads its slot's 32 hash bytes directly.
//
// Bound on the H100: memory.  A slot reads 56 bytes of window operands and
// its node's 60 bytes (shared by the W threads of the node, so served from
// L1/L2 after the first), and writes one byte.  The op evaluation is the
// shared evaluator of eval_row.cuh (rounding and shift rules there); a
// masked slot (op -1) loads nothing else, and the operands only some ops
// read are loaded by those ops alone.

#include "eval_row.cuh"

namespace {

constexpr int kThreads = 256;

// operands read from device memory on demand
struct GlobalNode {
  const int* p_isint;
  const int* p_acq;
  const int2* p_prefix;
  const int4* p_hash;  // (N, 8) as 2 x int4
  long long i;
  __device__ int is_int() const { return p_isint[i]; }
  __device__ int acquired() const { return p_acq[i]; }
  __device__ int2 prefix() const { return p_prefix[i]; }
  __device__ void hash(int4& a, int4& b) const { a = p_hash[2 * i]; b = p_hash[2 * i + 1]; }
};

struct GlobalSlot {
  const int* w_i1;
  const int* w_u0;
  const int* w_u1;
  const int4* w_hash;  // (N, W, 8) as 2 x int4
  long long t;
  __device__ int i1() const { return w_i1[t]; }
  __device__ unsigned u0() const { return static_cast<unsigned>(w_u0[t]); }
  __device__ unsigned u1() const { return static_cast<unsigned>(w_u1[t]); }
  __device__ void hash(int4& a, int4& b) const { a = w_hash[2 * t]; b = w_hash[2 * t + 1]; }
};

__global__ void assertion_eval_window_kernel(
    const int* __restrict__ n_type, const int* __restrict__ n_isint,
    const float* __restrict__ n_num, const int* __restrict__ n_size,
    const int* __restrict__ n_acq,
    const int4* __restrict__ n_hash,    // (N, 8) as 2 x int4
    const int2* __restrict__ n_prefix,  // (N, 2)
    const int* __restrict__ w_op, const float* __restrict__ w_f0,
    const int* __restrict__ w_i0, const int* __restrict__ w_i1,
    const int* __restrict__ w_u0, const int* __restrict__ w_u1,
    const int4* __restrict__ w_hash,  // (N, W, 8) as 2 x int4
    int8_t* __restrict__ out,         // (N, W)
    long long total, int w) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long node = t / w;
  const int op = w_op[t];
  bool r = false;
  if (op >= 0 && op <= blaze::OBJ_HAS_SLOT) {
    r = blaze::eval_row(op, w_f0[t], w_i0[t], n_type[node], n_num[node], n_size[node],
                        GlobalNode{n_isint, n_acq, n_prefix, n_hash, node},
                        GlobalSlot{w_i1, w_u0, w_u1, w_hash, t});
  }
  out[t] = r ? 1 : 0;
}

}  // namespace

extern "C" int assertion_eval_window(const void* n_type, const void* n_isint, const void* n_num,
                                     const void* n_size, const void* n_acq, const void* n_hash,
                                     const void* n_prefix, const void* w_op, const void* w_f0,
                                     const void* w_i0, const void* w_i1, const void* w_u0,
                                     const void* w_u1, const void* w_hash, void* out, long long n,
                                     int w, void* stream) {
  const long long total = n * static_cast<long long>(w);
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    assertion_eval_window_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(n_type), static_cast<const int*>(n_isint),
        static_cast<const float*>(n_num), static_cast<const int*>(n_size),
        static_cast<const int*>(n_acq), static_cast<const int4*>(n_hash),
        static_cast<const int2*>(n_prefix), static_cast<const int*>(w_op),
        static_cast<const float*>(w_f0), static_cast<const int*>(w_i0),
        static_cast<const int*>(w_i1), static_cast<const int*>(w_u0),
        static_cast<const int*>(w_u1), static_cast<const int4*>(w_hash),
        static_cast<int8_t*>(out), total, w);
  }
  return static_cast<int>(cudaGetLastError());
}
