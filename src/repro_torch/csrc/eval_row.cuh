// eval_row.cuh: the assertion mini-ISA on one (node, assertion row) pair.
//
// The per-element body of `_eval_rows` (src/repro/kernels/assertion_eval.py),
// shared by the dense kernel (assertion_eval.cu) and the windowed kernel
// (assertion_eval_window.cu), so the 19 ops and their rounding and shift
// rules have one source.  The TPU version computes every op's candidate and
// selects by op code; here `eval_op<OP>` is one op, `with_op` dispatches a
// run-time op code to it once (for one element in the windowed kernel's
// `eval_row`, for a run of rows with the same op in the dense kernel).
// `load_node` loads the node columns a set of ops reads, for both kernels.
//
// Bit-exactness with the reference (jnp, float32):
//  - NUM_MULTIPLE uses float32 constants (1e-6f), floorf(q + 0.5f) and a
//    correctly rounded division; the build passes -fmad=false and no fast
//    math, so no product is contracted into an FMA.
//  - STR_PREFIX builds its masks in unsigned int and treats a shift of 32
//    or more as 0 (XLA's semantics; plain C++ leaves it undefined).
//  - OBJ_HAS_SLOT clamps its shift to 0..31; TYPE_MASK gives 0 for a node
//    type outside 0..31.
//  - An op code outside 0..18 (the padding op -1) gives false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blaze {

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

__device__ __forceinline__ bool hash_equal(int4 na, int4 nb, int4 wa, int4 wb) {
  return na.x == wa.x && na.y == wa.y && na.z == wa.z && na.w == wa.w && nb.x == wb.x &&
         nb.y == wb.y && nb.z == wb.z && nb.w == wb.w;
}

// A compile-time op code.
template <int OP>
struct OpTag {
  static constexpr int value = OP;
};

// Calls f(OpTag<op>{}) for an op code 0..18 and returns true; any other
// code (the padding op -1) calls nothing and returns false.  A caller that
// evaluates many elements under one op dispatches once for all of them.
template <class F>
__device__ __forceinline__ bool with_op(int op, F&& f) {
  switch (op) {
    case TYPE_MASK: f(OpTag<TYPE_MASK>{}); return true;
    case NUM_GE: f(OpTag<NUM_GE>{}); return true;
    case NUM_GT: f(OpTag<NUM_GT>{}); return true;
    case NUM_LE: f(OpTag<NUM_LE>{}); return true;
    case NUM_LT: f(OpTag<NUM_LT>{}); return true;
    case NUM_MULTIPLE: f(OpTag<NUM_MULTIPLE>{}); return true;
    case STR_MINLEN: f(OpTag<STR_MINLEN>{}); return true;
    case STR_MAXLEN: f(OpTag<STR_MAXLEN>{}); return true;
    case ARR_MINLEN: f(OpTag<ARR_MINLEN>{}); return true;
    case ARR_MAXLEN: f(OpTag<ARR_MAXLEN>{}); return true;
    case OBJ_MINPROPS: f(OpTag<OBJ_MINPROPS>{}); return true;
    case OBJ_MAXPROPS: f(OpTag<OBJ_MAXPROPS>{}); return true;
    case STR_PREFIX: f(OpTag<STR_PREFIX>{}); return true;
    case STR_EQ: f(OpTag<STR_EQ>{}); return true;
    case CONST_NULL: f(OpTag<CONST_NULL>{}); return true;
    case CONST_BOOL: f(OpTag<CONST_BOOL>{}); return true;
    case CONST_NUM: f(OpTag<CONST_NUM>{}); return true;
    case STR_EQ_PRE: f(OpTag<STR_EQ_PRE>{}); return true;
    case OBJ_HAS_SLOT: f(OpTag<OBJ_HAS_SLOT>{}); return true;
    default: return false;
  }
}

// One (node, row) verdict under the op code OP (0..18).  The operands most
// ops read come by value; the others are read through the accessors, only
// by the ops that need them, so a caller reading device memory loads them
// lazily:
//   node.is_int(), node.acquired() -> int; node.prefix() -> int2;
//   node.hash(a, b) and row.hash(a, b) fill two int4 with the 8 lanes;
//   row.i1() -> int; row.u0(), row.u1() -> unsigned.
template <int OP, class Node, class Row>
__device__ __forceinline__ bool eval_op(float f0, int i0, int ntype, float num, int size,
                                        const Node& node, const Row& row) {
  [[maybe_unused]] const bool is_num = ntype == T_NUM, is_str = ntype == T_STR;
  [[maybe_unused]] const bool is_arr = ntype == T_ARR, is_obj = ntype == T_OBJ;
  if constexpr (OP == TYPE_MASK) {
    const int type_bit = static_cast<int>(shl(1u, static_cast<unsigned>(ntype)));
    return ((type_bit & i0) != 0) && (row.i1() == 0 || !is_num || node.is_int() != 0);
  } else if constexpr (OP == NUM_GE) {
    return !is_num || num >= f0;
  } else if constexpr (OP == NUM_GT) {
    return !is_num || num > f0;
  } else if constexpr (OP == NUM_LE) {
    return !is_num || num <= f0;
  } else if constexpr (OP == NUM_LT) {
    return !is_num || num < f0;
  } else if constexpr (OP == NUM_MULTIPLE) {
    const float q = __fdiv_rn(num, f0 == 0.0f ? 1.0f : f0);
    const float q_near = floorf(__fadd_rn(q, 0.5f));
    const float q_tol = fminf(__fmul_rn(1e-6f, fmaxf(fabsf(q), 1.0f)), 0.25f);
    return !is_num || (f0 != 0.0f && fabsf(__fsub_rn(q, q_near)) <= q_tol);
  } else if constexpr (OP == STR_MINLEN) {
    return !is_str || size >= i0;
  } else if constexpr (OP == STR_MAXLEN) {
    return !is_str || size <= i0;
  } else if constexpr (OP == ARR_MINLEN) {
    return !is_arr || size >= i0;
  } else if constexpr (OP == ARR_MAXLEN) {
    return !is_arr || size <= i0;
  } else if constexpr (OP == OBJ_MINPROPS) {
    return !is_obj || size >= i0;
  } else if constexpr (OP == OBJ_MAXPROPS) {
    return !is_obj || size <= i0;
  } else if constexpr (OP == STR_PREFIX) {
    if (!is_str) return true;
    const int len0 = min(i0, 4);
    const int len1 = max(static_cast<int>(static_cast<unsigned>(i0) - 4u), 0);
    const unsigned m0 = prefix_mask(len0), m1 = prefix_mask(len1);
    const int2 p = node.prefix();
    const bool eq = ((static_cast<unsigned>(p.x) & m0) == (row.u0() & m0)) &&
                    ((static_cast<unsigned>(p.y) & m1) == (row.u1() & m1));
    return eq && size >= i0;
  } else if constexpr (OP == STR_EQ || OP == STR_EQ_PRE) {
    int4 na, nb, wa, wb;
    node.hash(na, nb);
    row.hash(wa, wb);
    const bool heq = hash_equal(na, nb, wa, wb);
    return OP == STR_EQ ? (is_str && heq) : (!is_str || heq);
  } else if constexpr (OP == CONST_NULL) {
    return ntype == T_NULL;
  } else if constexpr (OP == CONST_BOOL) {
    return ntype == T_BOOL && num == f0;
  } else if constexpr (OP == CONST_NUM) {
    return is_num && num == f0;
  } else {
    static_assert(OP == OBJ_HAS_SLOT, "op code outside 0..18");
    const int s = min(max(i0, 0), 31);
    return !is_obj || ((node.acquired() >> s) & 1) != 0;
  }
}

// One (node, row) verdict for a run-time op code; false outside 0..18.
template <class Node, class Row>
__device__ __forceinline__ bool eval_row(int op, float f0, int i0, int ntype, float num,
                                         int size, const Node& node, const Row& row) {
  bool pass = false;
  with_op(op, [&](auto tag) {
    pass = eval_op<decltype(tag)::value>(f0, i0, ntype, num, size, node, row);
  });
  return pass;
}

// The node columns each op reads, as a bit per op code (type is read by
// every op): a kernel ORs op_bit() over the ops it will evaluate for a
// node and loads only those columns.
__host__ __device__ constexpr unsigned op_bit(int op) { return 1u << op; }
constexpr unsigned kReadsIsInt = op_bit(TYPE_MASK);
constexpr unsigned kReadsNum = op_bit(NUM_GE) | op_bit(NUM_GT) | op_bit(NUM_LE) |
                               op_bit(NUM_LT) | op_bit(NUM_MULTIPLE) | op_bit(CONST_BOOL) |
                               op_bit(CONST_NUM);
constexpr unsigned kReadsSize = op_bit(STR_MINLEN) | op_bit(STR_MAXLEN) | op_bit(ARR_MINLEN) |
                                op_bit(ARR_MAXLEN) | op_bit(OBJ_MINPROPS) |
                                op_bit(OBJ_MAXPROPS) | op_bit(STR_PREFIX);
constexpr unsigned kReadsAcq = op_bit(OBJ_HAS_SLOT);
constexpr unsigned kReadsPrefix = op_bit(STR_PREFIX);
constexpr unsigned kReadsHash = op_bit(STR_EQ) | op_bit(STR_EQ_PRE);

// node operands held in registers
struct RegNode {
  int ntype, isint, size, acq;
  float num;
  int2 pfx;
  int4 ha, hb;
  __device__ int is_int() const { return isint; }
  __device__ int acquired() const { return acq; }
  __device__ int2 prefix() const { return pfx; }
  __device__ void hash(int4& a, int4& b) const { a = ha; b = hb; }
};

// node i's columns that the ops in `used` read; the others, and every
// column of a node that is not `live`, stay 0
__device__ __forceinline__ RegNode load_node(
    const int* __restrict__ n_type, const int* __restrict__ n_isint,
    const float* __restrict__ n_num, const int* __restrict__ n_size,
    const int* __restrict__ n_acq, const int4* __restrict__ n_hash,
    const int2* __restrict__ n_prefix, long long i, bool live, unsigned used) {
  RegNode v{0, 0, 0, 0, 0.0f, make_int2(0, 0), make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  if (!live || !used) return v;
  v.ntype = n_type[i];
  if (used & kReadsIsInt) v.isint = n_isint[i];
  if (used & kReadsNum) v.num = n_num[i];
  if (used & kReadsSize) v.size = n_size[i];
  if (used & kReadsAcq) v.acq = n_acq[i];
  if (used & kReadsPrefix) v.pfx = n_prefix[i];
  if (used & kReadsHash) {
    v.ha = n_hash[2 * i];
    v.hb = n_hash[2 * i + 1];
  }
  return v;
}

}  // namespace blaze
