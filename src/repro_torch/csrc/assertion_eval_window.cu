// assertion_eval_window: the (N, W) int8 pass matrix of every document node
// against the assertion rows of its own location's CSR window, read from the
// tape itself.
//
// Replaces the Pallas TPU kernel `assertion_eval_window_pallas` (src/repro/
// kernels/assertion_eval.py, body `_assertion_window_kernel` plus the shared
// `_eval_rows`) together with the window gather in front of it: the JAX
// executor gathers each node's window operands into (N, W) and (N, W, 8)
// arrays, and the TPU kernel reads them back (the hash relaid lane-major so
// every VMEM slice stays rank-2).  Here a thread indexes the tape directly.
//
// Slot j of node i: with (start, len) = (loc_start, loc_len)[loc[i]], the
// evaluator on (node i, tape row start + j) for j < len, else 0.  A node
// with loc < 0 (untracked, invalid, frontier) has no window; a row index
// outside 0..A-1 is clamped into it, as the gather does.
//
// Bound on the H100: few bytes (4 B of loc and W output bytes a node, the
// node columns its window's ops read, the tape once), so what bounds it is
// latency -- three dependent loads a node (loc, its window's range, the node
// columns) -- and the evaluator's 19-way op dispatch per slot, which
// diverges where a warp's nodes sit at different locations.  The design:
//  - one thread per node walks its <= W slots, so each node column is
//    loaded once, into registers, and only when some op of the node's
//    window reads it (a first pass over the window's op codes); a node
//    without a live window loads nothing but its loc;
//  - a persistent grid walks 256-node tiles; for A <= kRowCap each block
//    stages the tape's rows (56 B each) in shared memory once, after
//    issuing its first tile's loc loads so the two round trips overlap;
//    larger tapes (the pre-gathered adapter's N*W rows among them) are read
//    in place through the read-only cache;
//  - each tile's bytes are collected in shared memory and written with
//    coalesced 16-byte stores (the buffer aligned to the output's 16-byte
//    chunks, partial chunks at either end stored byte by byte); W above
//    kSlotCap is done in passes of kSlotCap slots with per-byte stores.
// The evaluator and the node loader are shared with the dense kernel
// (eval_row.cuh), with its rounding and shift rules.

#include "eval_row.cuh"

namespace {

constexpr int kThreads = 256;  // nodes per tile, one a thread
constexpr int kRowCap = 512;   // tape rows staged in shared memory (56 B each)
constexpr int kSlotCap = 64;   // window slots a pass collects in shared memory

using blaze::RegNode;

struct TapeCols {
  const int* op;
  const float* f0;
  const int* i0;
  const int* i1;
  const int* u0;
  const int* u1;
  const int4* hash;  // (A, 8) as 2 x int4
};

// a tape row staged in shared memory
struct SharedRow {
  const int4* s_head;  // (op, f0 bits, i0, i1) per row
  const int2* s_u;     // (u0, u1) per row
  const int4* s_hash;  // 2 x int4 per row
  int r;
  __device__ int i1() const { return s_head[r].w; }
  __device__ unsigned u0() const { return static_cast<unsigned>(s_u[r].x); }
  __device__ unsigned u1() const { return static_cast<unsigned>(s_u[r].y); }
  __device__ void hash(int4& a, int4& b) const { a = s_hash[2 * r]; b = s_hash[2 * r + 1]; }
};

// a tape row read in place through the read-only cache
struct GlobalRow {
  const TapeCols& t;
  int r;
  __device__ int i1() const { return __ldg(t.i1 + r); }
  __device__ unsigned u0() const { return static_cast<unsigned>(__ldg(t.u0 + r)); }
  __device__ unsigned u1() const { return static_cast<unsigned>(__ldg(t.u1 + r)); }
  __device__ void hash(int4& a, int4& b) const {
    a = __ldg(t.hash + 2 * r);
    b = __ldg(t.hash + 2 * r + 1);
  }
};

// The tape's rows as the kernel reads them: Rows<true> staged in shared
// memory, Rows<false> in place.
template <bool kStaged>
struct Rows;

template <>
struct Rows<true> {
  const int4* s_head;
  const int2* s_u;
  const int4* s_hash;
  __device__ int op(int r) const { return s_head[r].x; }
  __device__ bool eval(int r, const RegNode& v) const {
    const int4 h = s_head[r];
    return blaze::eval_row(h.x, __int_as_float(h.y), h.z, v.ntype, v.num, v.size, v,
                           SharedRow{s_head, s_u, s_hash, r});
  }
};

template <>
struct Rows<false> {
  TapeCols t;
  __device__ int op(int r) const { return __ldg(t.op + r); }
  __device__ bool eval(int r, const RegNode& v) const {
    return blaze::eval_row(__ldg(t.op + r), __ldg(t.f0 + r), __ldg(t.i0 + r), v.ntype, v.num,
                           v.size, v, GlobalRow{t, r});
  }
};

__host__ __device__ constexpr int slots_per_pass(int w) { return w < kSlotCap ? w : kSlotCap; }

// shared-memory bytes: the staged rows (head 16 B, hash 32 B, u0/u1 8 B a
// row), a pass's output bytes and 32 bytes of alignment slack
__host__ __device__ constexpr size_t smem_bytes(int staged_rows, int w) {
  return static_cast<size_t>(staged_rows) * (3 * sizeof(int4) + sizeof(int2)) +
         static_cast<size_t>(kThreads) * slots_per_pass(w) + 32;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) assertion_eval_window_kernel(
    const int* __restrict__ loc,  // (N,)
    const int* __restrict__ n_type, const int* __restrict__ n_isint,
    const float* __restrict__ n_num, const int* __restrict__ n_size,
    const int* __restrict__ n_acq,
    const int4* __restrict__ n_hash,    // (N, 8) as 2 x int4
    const int2* __restrict__ n_prefix,  // (N, 2)
    const int* __restrict__ loc_start, const int* __restrict__ loc_len, int n_loc,
    TapeCols tape, int a,
    int8_t* __restrict__ out,  // (N, W), 16-byte aligned
    int n, int w) {
  extern __shared__ int4 smem[];
  const int staged_rows = kStaged ? a : 0;
  const int slots = slots_per_pass(w);
  int4* s_head = smem;
  int4* s_hash = s_head + staged_rows;
  int8_t* s_out = reinterpret_cast<int8_t*>(s_hash + 2 * staged_rows);
  int2* s_u = reinterpret_cast<int2*>(s_out + static_cast<size_t>(kThreads) * slots + 32);
  Rows<kStaged> rows;
  if constexpr (kStaged) {
    rows = Rows<true>{s_head, s_u, s_hash};
  } else {
    rows = Rows<false>{tape};
  }

  const int tiles = (n - 1) / kThreads + 1;
  bool staged = !kStaged;
  // the loop bounds are block-uniform: every thread reaches the barriers
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t * kThreads;
    const int nodes = min(kThreads, n - n0);
    const long long i = n0 + static_cast<int>(threadIdx.x);
    const int l = static_cast<int>(threadIdx.x) < nodes ? loc[i] : -1;
    if (kStaged && !staged) {  // once per block, while the loc loads are in flight
      for (int r = threadIdx.x; r < a; r += kThreads) {
        s_head[r] = make_int4(tape.op[r], __float_as_int(tape.f0[r]), tape.i0[r], tape.i1[r]);
        s_u[r] = make_int2(tape.u0[r], tape.u1[r]);
        s_hash[2 * r] = tape.hash[2 * r];
        s_hash[2 * r + 1] = tape.hash[2 * r + 1];
      }
      __syncthreads();
      staged = true;
    }

    // the node's window; slot j reads row clamp(start + j, 0, A - 1)
    long long start = 0;
    int len = 0;
    if (l >= 0 && l < n_loc && a > 0) {
      start = __ldg(loc_start + l);
      len = min(__ldg(loc_len + l), w);
    }
    auto row_of = [&](int j) {
      const long long r = start + j;
      return static_cast<int>(r < 0 ? 0 : (r >= a ? a - 1 : r));
    };
    unsigned used = 0;  // the ops of the window, for the node columns they read
    for (int j = 0; j < len; ++j) {
      const int op = rows.op(row_of(j));
      if (op >= 0 && op <= blaze::OBJ_HAS_SLOT) used |= blaze::op_bit(op);
    }
    const RegNode node = blaze::load_node(n_type, n_isint, n_num, n_size, n_acq, n_hash,
                                          n_prefix, i, len > 0, used);

    // slots [c0, c0 + cs) of the tile's nodes: byte (node jj, slot c0 + s)
    // at s_out[pre + jj * cs + s]; `pre` aligns a whole-row pass to the
    // output's 16-byte chunks.  Bytes of threads past the tile's end land
    // in the buffer's slack or are overwritten, and are never stored.
    for (int c0 = 0; c0 < w; c0 += slots) {
      const int cs = min(slots, w - c0);
      const bool contiguous = cs == w;
      const long long g0 = static_cast<long long>(n0) * w + c0;
      const int pre = contiguous ? static_cast<int>(g0 & 15) : 0;
      int8_t* dst = s_out + pre + threadIdx.x * cs;
      for (int s = 0; s < cs; ++s) {
        const int j = c0 + s;
        dst[s] = j < len && rows.eval(row_of(j), node) ? 1 : 0;
      }
      __syncthreads();
      if (contiguous) {
        // one contiguous output range [g0, g0 + nodes * w)
        const int end = pre + nodes * w;
        int8_t* base = out + (g0 - pre);  // 16-byte aligned
        for (int c = threadIdx.x; c < (end + 15) / 16; c += kThreads) {
          const int lo = 16 * c;
          if (lo >= pre && lo + 16 <= end) {
            *reinterpret_cast<int4*>(base + lo) = *reinterpret_cast<const int4*>(s_out + lo);
          } else {
            for (int b = max(lo, pre); b < min(lo + 16, end); ++b) base[b] = s_out[b];
          }
        }
      } else {
        // `nodes` runs of `cs` bytes, W bytes apart
        for (int e = threadIdx.x; e < nodes * cs; e += kThreads) {
          const int jj = e / cs;
          out[g0 + static_cast<long long>(jj) * w + (e - jj * cs)] = s_out[e];
        }
      }
      __syncthreads();  // the buffer is free for the next pass
    }
  }
}

template <bool kStaged>
cudaError_t launch(const void* loc, const void* const* node, const void* loc_start,
                   const void* loc_len, int n_loc, const TapeCols& tape, int a, void* out,
                   int n, int w, cudaStream_t stream) {
  const size_t smem = smem_bytes(kStaged ? a : 0, w);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, assertion_eval_window_kernel<kStaged>, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(n) - 1) / kThreads + 1;
  const long long resident_blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < resident_blocks ? tiles : resident_blocks);
  assertion_eval_window_kernel<kStaged><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(loc), static_cast<const int*>(node[0]),
      static_cast<const int*>(node[1]), static_cast<const float*>(node[2]),
      static_cast<const int*>(node[3]), static_cast<const int*>(node[4]),
      static_cast<const int4*>(node[5]), static_cast<const int2*>(node[6]),
      static_cast<const int*>(loc_start), static_cast<const int*>(loc_len), n_loc, tape, a,
      static_cast<int8_t*>(out), n, w);
  return cudaSuccess;
}

}  // namespace

extern "C" int assertion_eval_window(const void* loc, const void* n_type, const void* n_isint,
                                     const void* n_num, const void* n_size, const void* n_acq,
                                     const void* n_hash, const void* n_prefix,
                                     const void* loc_start, const void* loc_len, int n_loc,
                                     const void* a_op, const void* a_f0, const void* a_i0,
                                     const void* a_i1, const void* a_u0, const void* a_u1,
                                     const void* a_hash, int a, void* out, int n, int w,
                                     void* stream) {
  if (n > 0 && w > 0) {
    const void* node[] = {n_type, n_isint, n_num, n_size, n_acq, n_hash, n_prefix};
    const TapeCols tape{static_cast<const int*>(a_op), static_cast<const float*>(a_f0),
                        static_cast<const int*>(a_i0), static_cast<const int*>(a_i1),
                        static_cast<const int*>(a_u0), static_cast<const int*>(a_u1),
                        static_cast<const int4*>(a_hash)};
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        a <= kRowCap
            ? launch<true>(loc, node, loc_start, loc_len, n_loc, tape, a, out, n, w, s)
            : launch<false>(loc, node, loc_start, loc_len, n_loc, tape, a, out, n, w, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
