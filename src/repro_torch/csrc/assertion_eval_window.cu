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
// L1/L2 after the first), and writes one byte.  The op evaluation is a
// switch on the op code: only the selected op's arithmetic runs.
//
// Bit-exactness with the reference (jnp, float32):
//  - NUM_MULTIPLE uses float32 constants (1e-6f), floorf(q + 0.5f) and a
//    correctly rounded division; the build passes -fmad=false and no fast
//    math, so no product is contracted into an FMA.
//  - STR_PREFIX builds its masks in unsigned int and treats a shift of 32
//    or more as 0 (XLA's semantics; plain C++ leaves it undefined).
//  - OBJ_HAS_SLOT clamps its shift to 0..31; TYPE_MASK gives 0 for a node
//    type outside 0..31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// node type codes (core/nodetypes.py) and op codes (core/tape.py AOP)
constexpr int T_NULL = 1, T_BOOL = 2, T_NUM = 3, T_STR = 4, T_ARR = 5, T_OBJ = 6;
enum Op {
  TYPE_MASK = 0, NUM_GE = 1, NUM_GT = 2, NUM_LE = 3, NUM_LT = 4, NUM_MULTIPLE = 5,
  STR_MINLEN = 6, STR_MAXLEN = 7, ARR_MINLEN = 8, ARR_MAXLEN = 9, OBJ_MINPROPS = 10,
  OBJ_MAXPROPS = 11, STR_PREFIX = 12, STR_EQ = 13, CONST_NULL = 14, CONST_BOOL = 15,
  CONST_NUM = 16, STR_EQ_PRE = 17, OBJ_HAS_SLOT = 18,
};

// logical shifts with XLA's out-of-range rule: a shift by >= 32 gives 0
__device__ __forceinline__ unsigned shr(unsigned x, unsigned s) { return s >= 32u ? 0u : x >> s; }
__device__ __forceinline__ unsigned shl(unsigned x, unsigned s) { return s >= 32u ? 0u : x << s; }

// mask of the first `len` bytes of a big-endian word, 0 when len == 0
// (unsigned arithmetic: wraps as the reference's int32 does, never overflows)
__device__ __forceinline__ unsigned prefix_mask(int len) {
  const unsigned s = (4u - static_cast<unsigned>(len)) * 8u;
  return len == 0 ? 0u : shl(shr(0xFFFFFFFFu, s), s);
}

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
  if (op >= 0 && op <= OBJ_HAS_SLOT) {
    const int ntype = n_type[node];
    const bool is_num = ntype == T_NUM, is_str = ntype == T_STR;
    const bool is_arr = ntype == T_ARR, is_obj = ntype == T_OBJ;
    const float num = n_num[node];
    const int size = n_size[node];
    const float f0 = w_f0[t];
    const int i0 = w_i0[t];
    switch (op) {
      case TYPE_MASK: {
        const int type_bit = static_cast<int>(shl(1u, static_cast<unsigned>(ntype)));
        r = ((type_bit & i0) != 0) && (w_i1[t] == 0 || !is_num || n_isint[node] != 0);
        break;
      }
      case NUM_GE: r = !is_num || num >= f0; break;
      case NUM_GT: r = !is_num || num > f0; break;
      case NUM_LE: r = !is_num || num <= f0; break;
      case NUM_LT: r = !is_num || num < f0; break;
      case NUM_MULTIPLE: {
        const float q = __fdiv_rn(num, f0 == 0.0f ? 1.0f : f0);
        const float q_near = floorf(__fadd_rn(q, 0.5f));
        const float q_tol = fminf(__fmul_rn(1e-6f, fmaxf(fabsf(q), 1.0f)), 0.25f);
        r = !is_num || (f0 != 0.0f && fabsf(__fsub_rn(q, q_near)) <= q_tol);
        break;
      }
      case STR_MINLEN: r = !is_str || size >= i0; break;
      case STR_MAXLEN: r = !is_str || size <= i0; break;
      case ARR_MINLEN: r = !is_arr || size >= i0; break;
      case ARR_MAXLEN: r = !is_arr || size <= i0; break;
      case OBJ_MINPROPS: r = !is_obj || size >= i0; break;
      case OBJ_MAXPROPS: r = !is_obj || size <= i0; break;
      case STR_PREFIX: {
        const int len0 = min(i0, 4);
        const int len1 = max(static_cast<int>(static_cast<unsigned>(i0) - 4u), 0);
        const unsigned m0 = prefix_mask(len0), m1 = prefix_mask(len1);
        const int2 p = n_prefix[node];
        const bool eq = ((static_cast<unsigned>(p.x) & m0) == (static_cast<unsigned>(w_u0[t]) & m0)) &&
                        ((static_cast<unsigned>(p.y) & m1) == (static_cast<unsigned>(w_u1[t]) & m1));
        r = !is_str || (eq && size >= i0);
        break;
      }
      case STR_EQ:
      case STR_EQ_PRE: {
        const int4 na = n_hash[2 * node], nb = n_hash[2 * node + 1];
        const int4 wa = w_hash[2 * t], wb = w_hash[2 * t + 1];
        const bool heq = na.x == wa.x && na.y == wa.y && na.z == wa.z && na.w == wa.w &&
                         nb.x == wb.x && nb.y == wb.y && nb.z == wb.z && nb.w == wb.w;
        r = op == STR_EQ ? (is_str && heq) : (!is_str || heq);
        break;
      }
      case CONST_NULL: r = ntype == T_NULL; break;
      case CONST_BOOL: r = ntype == T_BOOL && num == f0; break;
      case CONST_NUM: r = is_num && num == f0; break;
      case OBJ_HAS_SLOT: {
        const int s = min(max(i0, 0), 31);
        r = !is_obj || ((n_acq[node] >> s) & 1) != 0;
        break;
      }
    }
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
