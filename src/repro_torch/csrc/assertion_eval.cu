// assertion_eval: the dense (N, A) int8 pass matrix of every document node
// against every assertion row of the tape (the executor's dense layout).
//
// Replaces the Pallas TPU kernel `assertion_eval_pallas` (src/repro/kernels/
// assertion_eval.py, body `_assertion_kernel` plus the shared `_eval_rows`).
// The TPU version walks (256, 256) VMEM blocks of the (nodes x rows) space,
// computes every op's candidate for every element and selects by op code;
// its wrapper pads N and A to block multiples with op -1 rows.
//
// Bound on the H100: memory -- the N*A output bytes and the node columns
// the rows' ops read, each once -- with the op dispatch close behind: a
// branch tree over 19 op codes for every element costs more issue time
// than the bytes take.  The design keeps every warp on one op at a time,
// dispatches per run of rows, and keeps every access wide:
//  - a thread owns kNodesPerThread nodes of a kTile-node tile and walks
//    the staged rows in the same order as the rest of its block, each row's
//    operands read once for its nodes;
//  - the rows are staged once per block in shared memory and read as
//    broadcasts, sorted by op code (stably) while staging, so a tile's rows
//    form at most 20 runs (19 ops and op -1): the evaluator (eval_row.cuh) is
//    dispatched once per run and each step of a run is that op's body
//    alone, with no divergence; each result goes to the row's own column;
//  - while staging, the block collects which ops occur, and a node column
//    is loaded (coalesced, into registers) only when some staged op reads
//    it, so the 32 hash bytes and the 8 prefix bytes of a node move only
//    for rows that compare them; the loads are issued as soon as the op set
//    is known, so their round trip overlaps the rest of the staging;
//  - a persistent grid walks the tiles; each tile's nodes x A bytes are
//    collected in shared memory and then written with coalesced 16-byte
//    stores.  When the block covers all rows (A <= kRowCap) the tile is one
//    contiguous range of the row-major output: the buffer is laid out from
//    the 16-byte boundary below the range's start and the partial chunks at
//    either end are stored byte by byte.  Wider tapes are cut into
//    kRowCap-row tiles, each restaged, with per-byte stores.
// The ragged edges of N and A are masked here; no padding is added.
// Rounding and shift rules are the evaluator's (eval_row.cuh).

#include "eval_row.cuh"

namespace {

constexpr int kTile = 256;                 // nodes per tile
constexpr int kNodesPerThread = 2;         // nodes a thread evaluates per row step
constexpr int kThreads = kTile / kNodesPerThread;
constexpr int kRowCap = 128;               // assertion rows staged per block
constexpr int kNoOp = blaze::OBJ_HAS_SLOT + 1;  // sort key of an op outside 0..18

using blaze::load_node;
using blaze::op_bit;
using blaze::RegNode;

// row operands staged in shared memory, at the row's place `q` in op order
struct StagedRow {
  int i1_;
  const int2* s_u;     // (u0, u1) per row
  const int4* s_hash;  // 2 x int4 per row
  int q;
  __device__ int i1() const { return i1_; }
  __device__ unsigned u0() const { return static_cast<unsigned>(s_u[q].x); }
  __device__ unsigned u1() const { return static_cast<unsigned>(s_u[q].y); }
  __device__ void hash(int4& a, int4& b) const { a = s_hash[2 * q]; b = s_hash[2 * q + 1]; }
};

// shared-memory bytes for a block staging `cap` rows: per row the head
// (16 B), hash (32 B), u0/u1 (8 B), sort key, op and run end (12 B); the
// tile's output bytes and 32 bytes of alignment slack
__host__ __device__ constexpr size_t smem_bytes(int cap) {
  return static_cast<size_t>(cap) * (3 * sizeof(int4) + sizeof(int2) + 3 * sizeof(int)) +
         static_cast<size_t>(kTile) * cap + 32;
}

__global__ void __launch_bounds__(kThreads) assertion_eval_kernel(
    const int* __restrict__ n_type, const int* __restrict__ n_isint,
    const float* __restrict__ n_num, const int* __restrict__ n_size,
    const int* __restrict__ n_acq,
    const int4* __restrict__ n_hash,    // (N, 8) as 2 x int4
    const int2* __restrict__ n_prefix,  // (N, 2)
    const int* __restrict__ a_op, const float* __restrict__ a_f0,
    const int* __restrict__ a_i0, const int* __restrict__ a_i1,
    const int* __restrict__ a_u0, const int* __restrict__ a_u1,
    const int4* __restrict__ a_hash,  // (A, 8) as 2 x int4
    int8_t* __restrict__ out,         // (N, A), 16-byte aligned
    int n, int a) {
  extern __shared__ int4 smem[];
  __shared__ unsigned s_used;
  const int cap = min(a, kRowCap);
  // the staged rows sorted by op code (stable): s_head[q] = (row, f0 bits,
  // i0, i1), s_op[q] its op, s_end[q] the end of its run of equal ops
  int4* s_head = smem;
  int4* s_hash = s_head + cap;  // 2 x int4 per row
  int8_t* s_out = reinterpret_cast<int8_t*>(s_hash + 2 * cap);  // the tile's bytes
  int2* s_u = reinterpret_cast<int2*>(s_out + static_cast<size_t>(kTile) * cap + 32);
  int* s_key = reinterpret_cast<int*>(s_u + cap);  // sort key by original row
  int* s_op = s_key + cap;
  int* s_end = s_op + cap;

  const int node_tiles = (n - 1) / kTile + 1;
  const int row_tiles = (a - 1) / kRowCap + 1;
  const long long tiles = static_cast<long long>(node_tiles) * row_tiles;
  int staged = -1;
  unsigned used = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = static_cast<int>(t / node_tiles);
    const int nt = static_cast<int>(t - static_cast<long long>(rt) * node_tiles);
    const int a0 = rt * kRowCap;
    const int rows = min(kRowCap, a - a0);
    const int n0 = nt * kTile;
    const int nodes = min(kTile, n - n0);

    // block-uniform: the rows are staged once per block unless A > kRowCap
    const bool restage = rt != staged;
    if (restage) {  // first the ops, to know which node columns to load
      if (threadIdx.x == 0) s_used = 0;
      __syncthreads();  // the previous rows are no longer read
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const int op = a_op[a0 + r];
        const int key = op >= 0 && op <= blaze::OBJ_HAS_SLOT ? op : kNoOp;
        s_key[r] = key;
        if (key != kNoOp) atomicOr(&s_used, op_bit(key));
      }
      __syncthreads();
      used = s_used;
    }
    // the node loads are issued before the rest of the staging, so their
    // round trip overlaps it
    RegNode node[kNodesPerThread];
#pragma unroll
    for (int v = 0; v < kNodesPerThread; ++v) {
      const int j = threadIdx.x + v * kThreads;
      node[v] = load_node(n_type, n_isint, n_num, n_size, n_acq, n_hash, n_prefix, n0 + j,
                          j < nodes, used);
    }
    if (restage) {  // then each row's operands at its rank in op order
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const int key = s_key[r];
        int rank = 0, end = 0;
        for (int x = 0; x < rows; ++x) {
          const int kx = s_key[x];
          rank += kx < key || (kx == key && x < r);
          end += kx <= key;
        }
        const long long k = a0 + r;
        s_head[rank] = make_int4(r, __float_as_int(a_f0[k]), a_i0[k], a_i1[k]);
        s_u[rank] = make_int2(a_u0[k], a_u1[k]);
        s_hash[2 * rank] = a_hash[2 * k];
        s_hash[2 * rank + 1] = a_hash[2 * k + 1];
        s_op[rank] = key;
        s_end[rank] = end;
      }
      __syncthreads();
      staged = rt;
    }

    // byte (j, r) of the tile sits at s_out[pre + j * rows + r]; `pre`
    // aligns a contiguous tile's buffer to the output's 16-byte chunks
    const bool contiguous = rows == a;
    const long long g0 = static_cast<long long>(n0) * a + a0;
    const int pre = contiguous ? static_cast<int>(g0 & 15) : 0;
    // one dispatch per run of equal ops, the same runs for every thread;
    // bytes of nodes past the tile's end land in the buffer's slack or are
    // overwritten, and are never stored
    int8_t* dst = s_out + pre + threadIdx.x * rows;
    const int stride = kThreads * rows;
    for (int p = 0; p < rows;) {
      const int end = s_end[p];
      const bool live = blaze::with_op(s_op[p], [&](auto tag) {
        for (int q = p; q < end; ++q) {
          const int4 h = s_head[q];
          const StagedRow row{h.w, s_u, s_hash, q};
#pragma unroll
          for (int v = 0; v < kNodesPerThread; ++v) {
            dst[v * stride + h.x] =
                blaze::eval_op<decltype(tag)::value>(__int_as_float(h.y), h.z, node[v].ntype,
                                                     node[v].num, node[v].size, node[v], row)
                    ? 1
                    : 0;
          }
        }
      });
      if (!live) {  // op -1 rows
        for (int q = p; q < end; ++q) {
#pragma unroll
          for (int v = 0; v < kNodesPerThread; ++v) dst[v * stride + s_head[q].x] = 0;
        }
      }
      p = end;
    }
    __syncthreads();

    if (contiguous) {
      // one contiguous output range [g0, g0 + nodes * a)
      const int end = pre + nodes * a;
      int8_t* base = out + (g0 - pre);  // 16-byte aligned
      for (int c = threadIdx.x; c < (end + 15) / 16; c += blockDim.x) {
        const int lo = 16 * c;
        if (lo >= pre && lo + 16 <= end) {
          *reinterpret_cast<int4*>(base + lo) = *reinterpret_cast<const int4*>(s_out + lo);
        } else {
          for (int b = max(lo, pre); b < min(lo + 16, end); ++b) base[b] = s_out[b];
        }
      }
    } else {
      // a row tile: `nodes` runs of `rows` bytes, A bytes apart
      for (int e = threadIdx.x; e < nodes * rows; e += blockDim.x) {
        const int jj = e / rows;
        out[g0 + static_cast<long long>(jj) * a + (e - jj * rows)] = s_out[e];
      }
    }
    __syncthreads();  // the buffer is free for the next tile
  }
}

}  // namespace

extern "C" int assertion_eval(const void* n_type, const void* n_isint, const void* n_num,
                              const void* n_size, const void* n_acq, const void* n_hash,
                              const void* n_prefix, const void* a_op, const void* a_f0,
                              const void* a_i0, const void* a_i1, const void* a_u0,
                              const void* a_u1, const void* a_hash, void* out, int n, int a,
                              void* stream) {
  if (n > 0 && a > 0) {
    const size_t smem = smem_bytes(a < kRowCap ? a : kRowCap);
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assertion_eval_kernel,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = static_cast<long long>((n - 1) / kTile + 1) *
                            ((a - 1) / kRowCap + 1);
    const long long resident_blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(tiles < resident_blocks ? tiles : resident_blocks);
    assertion_eval_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(n_type), static_cast<const int*>(n_isint),
        static_cast<const float*>(n_num), static_cast<const int*>(n_size),
        static_cast<const int*>(n_acq), static_cast<const int4*>(n_hash),
        static_cast<const int2*>(n_prefix), static_cast<const int*>(a_op),
        static_cast<const float*>(a_f0), static_cast<const int*>(a_i0),
        static_cast<const int*>(a_i1), static_cast<const int*>(a_u0),
        static_cast<const int*>(a_u1), static_cast<const int4*>(a_hash),
        static_cast<int8_t*>(out), n, a);
  }
  return static_cast<int>(cudaGetLastError());
}
