// The per-edge sparse Clebsch-Gordan tensor product of the `pallas` backend
// for Hopper (sm_90a), float32, and its weight gradient:
//
//   sparse_tp        out[e, kU+u] = sum_n c_n w[p_n, u] a[e, i_nU+u] b[e, j_nU+u]
//   sparse_tp_gradw  gw[p, u]     = sum_e sum_{n: p_n=p} c_n a[e, i_nU+u] b[e, j_nU+u] g[e, k_nU+u]
//
// The `pallas` backend (`tp_kernel_backend="pallas"`) sums the environment
// first (on the center kernels, csrc/center_readout.cu) and then contracts
// two per-edge arrays: nothing is gathered by center here, every row of a, b,
// g and out belongs to one edge.
// The entry table (i, j, k, p, c) is the caller's: the layer's own, or one of
// its role permutations (the transposes of the derivative family,
// allegro_tpu_torch/ops/tp_primitives.py), so a, b and out may have any of
// the layer's dims in any order. Layout: per-edge arrays are row-major with
// the flat dim-major track (column i*U+u is basis dim i, channel u), w and gw
// are [P, U]. Padded edges are rows like any other: the caller's cotangents
// are zero there. Every sum runs in a fixed order (no atomics), so two
// identical calls give identical bits. Each kernel runs on the caller's
// stream and allocates nothing; each entry point returns cudaGetLastError().

#include "common.cu"

namespace {

constexpr int kTpThreads = kEdgeWarps * kWarp;  // threads per block of sparse_tp
constexpr int kMaxTpDim = 32;                   // basis dims of a, b, out (l_max 3, both parities)
constexpr int kMaxTpPaths = 255;                // paths: p is packed into 8 bits
constexpr int kGradwMaxBlocks = 1024;           // blocks of gradw's first pass

// The entry table in shared memory with (i, j, k, p) packed into one word,
// so each entry is one broadcast load of the index and one of c.
__device__ __forceinline__ void load_packed_entries(const int* __restrict__ eidx,
                                                    const float* __restrict__ ecoef,
                                                    int n_entries, unsigned* s_ent,
                                                    float* s_coef) {
  for (int t = threadIdx.x; t < n_entries; t += blockDim.x) {
    const int* r = eidx + 4 * t;
    s_ent[t] = (unsigned)r[0] | ((unsigned)r[1] << 8) | ((unsigned)r[2] << 16) |
               ((unsigned)r[3] << 24);
    s_coef[t] = ecoef[t];
  }
}

// ---------------------------------------------------------------------------
// sparse_tp
// Replaces allegro_tpu/ops/pallas_contract.py:_tp_kernel (_run_tp, lowered
// through ops/tp_primitives.py:tp): the forward of the `pallas` backend and,
// on the permuted tables, both input transposes.
// Bound: one read each of a [E, d1*U] and b [E, d2*U] and one write of out
// [E, d3*U] (3 x 119 MB at layer 0 of the 4,096-atom crystal, ~0.107 ms at
// 3.35 TB/s); the ~3 FLOPs per entry, edge and channel are an order of
// magnitude below that. Design: one thread per (edge, channel), consecutive
// channels on consecutive lanes, so every row load and store is coalesced; a
// grid-stride loop over a persistent grid loads the table and w [P, U] into
// shared memory once per block. The table's indices are run-time values, so
// a register array indexed by them would spill to local memory: each thread
// keeps its a and b rows and its d3 accumulators in its own shared-memory
// column (stride = block size: no bank conflicts). Entries sorted by (i, j)
// form each product a_i * b_j once, as the TPU kernel does.
// ---------------------------------------------------------------------------
__global__ void sparse_tp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 const float* __restrict__ w, const int* __restrict__ eidx,
                                 const float* __restrict__ ecoef, int n_entries, long long n_edges,
                                 int d1, int d2, int d3, int U, int P, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  unsigned* s_ent = reinterpret_cast<unsigned*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_ent + n_entries);
  float* s_w = s_coef + n_entries;  // [P*U]
  float* s_a = s_w + P * U;         // [d1][T]
  float* s_b = s_a + d1 * T;        // [d2][T]
  float* s_o = s_b + d2 * T;        // [d3][T]
  load_packed_entries(eidx, ecoef, n_entries, s_ent, s_coef);
  for (int q = tid; q < P * U; q += T) s_w[q] = w[q];
  __syncthreads();
  const long long work = n_edges * U;
  for (long long t = (long long)blockIdx.x * T + tid; t < work; t += (long long)gridDim.x * T) {
    const long long e = t / U;
    const int u = (int)(t - e * U);
    const float* ae = a + e * d1 * U + u;
    const float* be = b + e * d2 * U + u;
    for (int i = 0; i < d1; ++i) s_a[i * T + tid] = ae[i * U];
    for (int j = 0; j < d2; ++j) s_b[j * T + tid] = be[j * U];
    for (int k = 0; k < d3; ++k) s_o[k * T + tid] = 0.f;
    unsigned cur = 0xffffffffu;
    float ab = 0.f;
    for (int n = 0; n < n_entries; ++n) {
      const unsigned q = s_ent[n];
      if ((q & 0xffffu) != cur) {  // uniform across the block: every thread walks the same table
        cur = q & 0xffffu;
        ab = s_a[(q & 0xffu) * T + tid] * s_b[((q >> 8) & 0xffu) * T + tid];
      }
      const int k = (q >> 16) & 0xffu, p = q >> 24;
      s_o[k * T + tid] += s_coef[n] * s_w[p * U + u] * ab;
    }
    float* oe = out + e * d3 * U + u;
    for (int k = 0; k < d3; ++k) oe[k * U] = s_o[k * T + tid];
  }
}

// ---------------------------------------------------------------------------
// sparse_tp_gradw
// Replaces allegro_tpu/ops/pallas_contract.py:_gradw_kernel (_run_gradw,
// lowered through ops/tp_primitives.py:tp_gradw): the weight transpose of
// sparse_tp, whose own transposes are sparse_tp on permuted tables.
// Bound: one read each of a, b and g (3 x 119 MB at layer 0 of the 4,096-atom
// crystal, ~0.107 ms); the output [P, U] is tiny. Design: a reduction of all
// edges into [P, U]. The TPU kernel carries the sum from one grid step to the
// next; here a fixed grid of blocks (a function of E only) each sums a fixed,
// strided share of the edges and writes its partial [P, U], and a second
// launch adds the partials in block order. A block is U x (edges per step)
// threads, so each thread keeps one channel u for the whole pass and
// accumulates its P sums in its own shared-memory column; the block's columns
// of one channel are added in a fixed order at the end. No float atomics: two
// identical calls give identical bits.
// ---------------------------------------------------------------------------
__global__ void sparse_tp_gradw_partial_kernel(const float* __restrict__ a,
                                               const float* __restrict__ b,
                                               const float* __restrict__ g,
                                               const int* __restrict__ eidx,
                                               const float* __restrict__ ecoef, int n_entries,
                                               long long n_edges, int d1, int d2, int d3, int U,
                                               int P, float* __restrict__ partial) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int epb = T / U, slot = tid / U, u = tid - slot * U;
  unsigned* s_ent = reinterpret_cast<unsigned*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_ent + n_entries);
  float* s_a = s_coef + n_entries;  // [d1][T]
  float* s_b = s_a + d1 * T;        // [d2][T]
  float* s_g = s_b + d2 * T;        // [d3][T]
  float* s_acc = s_g + d3 * T;      // [P][T]
  load_packed_entries(eidx, ecoef, n_entries, s_ent, s_coef);
  for (int p = 0; p < P; ++p) s_acc[p * T + tid] = 0.f;
  __syncthreads();
  for (long long e = (long long)blockIdx.x * epb + slot; e < n_edges;
       e += (long long)gridDim.x * epb) {
    const float* ae = a + e * d1 * U + u;
    const float* be = b + e * d2 * U + u;
    const float* ge = g + e * d3 * U + u;
    for (int i = 0; i < d1; ++i) s_a[i * T + tid] = ae[i * U];
    for (int j = 0; j < d2; ++j) s_b[j * T + tid] = be[j * U];
    for (int k = 0; k < d3; ++k) s_g[k * T + tid] = ge[k * U];
    unsigned cur = 0xffffffffu;
    float ab = 0.f;
    for (int n = 0; n < n_entries; ++n) {
      const unsigned q = s_ent[n];
      if ((q & 0xffffu) != cur) {
        cur = q & 0xffffu;
        ab = s_a[(q & 0xffu) * T + tid] * s_b[((q >> 8) & 0xffu) * T + tid];
      }
      const int k = (q >> 16) & 0xffu, p = q >> 24;
      s_acc[p * T + tid] += s_coef[n] * ab * s_g[k * T + tid];
    }
  }
  __syncthreads();
  const int PU = P * U;
  for (int q = tid; q < PU; q += T) {
    const int p = q / U, uu = q - p * U;
    float s = 0.f;
    for (int sl = 0; sl < epb; ++sl) s += s_acc[p * T + sl * U + uu];
    partial[(long long)blockIdx.x * PU + q] = s;
  }
}

// Checks the sizes both kernels take; 0 or a CUDA error code.
int check_tp_dims(int d1, int d2, int d3, int P) {
  if (d1 < 1 || d2 < 1 || d3 < 1 || d1 > kMaxTpDim || d2 > kMaxTpDim || d3 > kMaxTpDim ||
      P < 1 || P > kMaxTpPaths)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

int atpt_sparse_tp(const float* a, const float* b, const float* w, const int* eidx,
                   const float* ecoef, int n_entries, long long n_edges, int d1, int d2, int d3,
                   int U, int P, float* out, void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P)) return rc;
  const int T = kTpThreads;
  size_t smem = (size_t)n_entries * 2 * sizeof(float) + (size_t)P * U * sizeof(float) +
                (size_t)(d1 + d2 + d3) * T * sizeof(float);
  if (smem > smem_optin()) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem(sparse_tp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(sparse_tp_kernel, T, smem, n_edges * U, T);
  sparse_tp_kernel<<<blocks, T, smem, (cudaStream_t)stream>>>(a, b, w, eidx, ecoef, n_entries,
                                                              n_edges, d1, d2, d3, U, P, out);
  return (int)cudaGetLastError();
}

// partial: scratch [n_blocks, P, U]; n_blocks <= kGradwMaxBlocks, chosen by
// the caller from E alone, so the order of the sums does not depend on the card.
int atpt_sparse_tp_gradw(const float* a, const float* b, const float* g, const int* eidx,
                         const float* ecoef, int n_entries, long long n_edges, int d1, int d2,
                         int d3, int U, int P, int n_blocks, float* partial, float* gw,
                         void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P)) return rc;
  if (U < 1 || U > 1024 || n_blocks < 1 || n_blocks > kGradwMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const int T = U * (U < kTpThreads ? kTpThreads / U : 1);
  size_t smem = (size_t)n_entries * 2 * sizeof(float) +
                (size_t)(d1 + d2 + d3 + P) * T * sizeof(float);
  if (smem > smem_optin()) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem(sparse_tp_gradw_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sparse_tp_gradw_partial_kernel<<<n_blocks, T, smem, (cudaStream_t)stream>>>(
      a, b, g, eidx, ecoef, n_entries, n_edges, d1, d2, d3, U, P, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PU = P * U;
  partials_reduce_kernel<<<(PU + 255) / 256, 256, 0, (cudaStream_t)stream>>>(partial, n_blocks,
                                                                            PU, gw);
  return (int)cudaGetLastError();
}

}  // extern "C"
