// assertion_eval: the dense (N, A) int8 pass matrix of every document node
// against every assertion row of the tape (the executor's dense layout).
//
// Replaces the Pallas TPU kernel `assertion_eval_pallas` (src/repro/kernels/
// assertion_eval.py, body `_assertion_kernel` plus the shared `_eval_rows`).
// The TPU version walks (256, 256) VMEM blocks of the (nodes x rows) space,
// computes every op's candidate for every element and selects by op code; its
// wrapper pads N and A to block multiples with op -1 rows.  Here a block owns
// a tile of kNodeTile nodes x kRowTile rows: it stages both tiles' operands in
// shared memory (60 bytes a node, 56 a row), then its threads walk the tile
// with the row index fastest, so neighbouring threads store neighbouring
// bytes of one output row.  The ragged edges of N and A are masked here; no
// padding is added.  The op evaluation is the shared evaluator of
// eval_row.cuh (rounding and shift rules there).
//
// Bound on the H100: memory.  The N*A output bytes dominate what must move
// (plus 60 bytes a node and 56 a row, each read once); each element costs
// one switch-selected op of about ten instructions.

#include "eval_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNodeTile = 64;   // nodes staged per block
constexpr int kRowTile = 128;   // assertion rows staged per block
constexpr int kMaxRowTiles = 65535;  // grid.y limit

// operands staged in shared memory
struct TileNode {
  const int* s_isint;
  const int* s_acq;
  const int2* s_prefix;
  const int4* s_hash;  // 2 x int4 per node
  int j;
  __device__ int is_int() const { return s_isint[j]; }
  __device__ int acquired() const { return s_acq[j]; }
  __device__ int2 prefix() const { return s_prefix[j]; }
  __device__ void hash(int4& a, int4& b) const { a = s_hash[2 * j]; b = s_hash[2 * j + 1]; }
};

struct TileRow {
  const int* s_i1;
  const int* s_u0;
  const int* s_u1;
  const int4* s_hash;  // 2 x int4 per row
  int r;
  __device__ int i1() const { return s_i1[r]; }
  __device__ unsigned u0() const { return static_cast<unsigned>(s_u0[r]); }
  __device__ unsigned u1() const { return static_cast<unsigned>(s_u1[r]); }
  __device__ void hash(int4& a, int4& b) const { a = s_hash[2 * r]; b = s_hash[2 * r + 1]; }
};

__global__ void assertion_eval_kernel(
    const int* __restrict__ n_type, const int* __restrict__ n_isint,
    const float* __restrict__ n_num, const int* __restrict__ n_size,
    const int* __restrict__ n_acq,
    const int4* __restrict__ n_hash,    // (N, 8) as 2 x int4
    const int2* __restrict__ n_prefix,  // (N, 2)
    const int* __restrict__ a_op, const float* __restrict__ a_f0,
    const int* __restrict__ a_i0, const int* __restrict__ a_i1,
    const int* __restrict__ a_u0, const int* __restrict__ a_u1,
    const int4* __restrict__ a_hash,  // (A, 8) as 2 x int4
    int8_t* __restrict__ out,         // (N, A)
    int n, int a) {
  __shared__ int sn_type[kNodeTile], sn_isint[kNodeTile], sn_size[kNodeTile], sn_acq[kNodeTile];
  __shared__ float sn_num[kNodeTile];
  __shared__ int2 sn_prefix[kNodeTile];
  __shared__ int4 sn_hash[2 * kNodeTile];
  __shared__ int sa_op[kRowTile], sa_i0[kRowTile], sa_i1[kRowTile], sa_u0[kRowTile],
      sa_u1[kRowTile];
  __shared__ float sa_f0[kRowTile];
  __shared__ int4 sa_hash[2 * kRowTile];

  const int n0 = blockIdx.x * kNodeTile;
  const int a0 = blockIdx.y * kRowTile;
  const int nodes = min(kNodeTile, n - n0);
  const int rows = min(kRowTile, a - a0);
  for (int j = threadIdx.x; j < nodes; j += blockDim.x) {
    const int i = n0 + j;
    sn_type[j] = n_type[i];
    sn_isint[j] = n_isint[i];
    sn_num[j] = n_num[i];
    sn_size[j] = n_size[i];
    sn_acq[j] = n_acq[i];
    sn_prefix[j] = n_prefix[i];
  }
  for (int h = threadIdx.x; h < 2 * nodes; h += blockDim.x) {
    sn_hash[h] = n_hash[2 * static_cast<long long>(n0) + h];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int k = a0 + r;
    sa_op[r] = a_op[k];
    sa_f0[r] = a_f0[k];
    sa_i0[r] = a_i0[k];
    sa_i1[r] = a_i1[k];
    sa_u0[r] = a_u0[k];
    sa_u1[r] = a_u1[k];
  }
  for (int h = threadIdx.x; h < 2 * rows; h += blockDim.x) {
    sa_hash[h] = a_hash[2 * a0 + h];
  }
  __syncthreads();

  const int elems = nodes * rows;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int j = e / rows;
    const int r = e - j * rows;
    const bool pass = blaze::eval_row(
        sa_op[r], sa_f0[r], sa_i0[r], sn_type[j], sn_num[j], sn_size[j],
        TileNode{sn_isint, sn_acq, sn_prefix, sn_hash, j},
        TileRow{sa_i1, sa_u0, sa_u1, sa_hash, r});
    out[static_cast<long long>(n0 + j) * a + a0 + r] = pass ? 1 : 0;
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
    const int row_tiles = (a - 1) / kRowTile + 1;
    if (row_tiles > kMaxRowTiles) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n - 1) / kNodeTile + 1, row_tiles);
    assertion_eval_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
