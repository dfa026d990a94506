// Center gather / scatter and the fused energy readout for Hopper (sm_90a), float32.
//
// Four kernels of the inference force call (`tp_kernel_backend="fused_infer"`
// with precomputed statics). Each replaces one Pallas TPU kernel of
// allegro_tpu/ops/fused_tp.py and computes the same function in atom space:
//
//   center_gather  out[e, c] = a[idx[e], c]           (0 where idx[e] >= n_atoms)
//   center_sum     s[a, c]   = sum_{k in [row_ptr[a], row_ptr[a+1])} v[perm[k], c]
//                  (also in fixed chunks, for a few long segments)
//   readout_sum    E[a]      = sum_{c(e)=a} silu(sum_i p_i[e] @ W0_i) @ w1
//   readout_bwd    dp_i[e]   = (E_ct[c(e)] * w1 * silu'(pre_e)) @ W0_i^T
//
// Layout (the JAX package's contract): per-edge arrays are row-major; edges
// are sorted by center, `row_ptr[a]` is the first edge of atom a, and padded
// edges carry the sentinel center n_atoms, after row_ptr[n_atoms]. center_sum
// also serves the neighbor side: `perm` lists the edges sorted by neighbor
// (stable, sentinels last) and `row_ptr` is then the CSR over that order.
// The readout's inputs are the scalar-track pieces, given as a table of row
// pointers with their row strides, never concatenated.
//
// Every per-atom sum adds its CSR segment in a fixed order (no atomics), so
// results are deterministic. Each kernel runs on the caller's stream and
// allocates nothing; each entry point returns cudaGetLastError().

#include "common.cu"

namespace {

constexpr int kThreads = 256;
constexpr int kNarrow = 4;    // the widest row the narrow forms take (positions, energies)
constexpr int kSumLanes = 16;  // lanes per atom of center_sum's narrow form

// A row of C floats as cv = C / 4 float4s (16-byte loads and stores) where C
// % 4 == 0 and the bases are 16-byte aligned, else as C floats.
__device__ __forceinline__ void vadd(float& s, float x) { s += x; }
__device__ __forceinline__ void vadd(float4& s, const float4& x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}
template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
// bf16 rows (a bfloat16 model's) for the gather, a copy: pairs where they can
template <>
__device__ __forceinline__ __nv_bfloat162 vzero<__nv_bfloat162>() {
  return __floats2bfloat162_rn(0.f, 0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 vzero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Lanes per row of cv vectors for the per-row forms: the whole row up to a
// warp, else the largest divisor of cv in [16, 32] (no idle lane: 24 for
// the 72 float4s of a 288-wide row), else 32.
inline int row_lanes(int cv) {
  if (cv <= kWarp) return cv;
  for (int t = kWarp; t >= kWarp / 2; --t)
    if (cv % t == 0) return t;
  return kWarp;
}

// Adds the blockDim.y values of each x lane (one a thread, through red:
// blockDim.x * blockDim.y V) in a fixed pairwise tree; the sum is returned
// to every thread. All of the block's threads must call it.
template <typename V>
__device__ V block_sum_y(V s, V* red) {
  const int x = threadIdx.x, y = threadIdx.y, tx = blockDim.x, ty = blockDim.y;
  red[y * tx + x] = s;
  __syncthreads();
  int h = 1;
  while (2 * h < ty) h *= 2;
  for (; h > 0; h >>= 1) {
    if (y < h && y + h < ty) vadd(red[y * tx + x], red[(y + h) * tx + x]);
    __syncthreads();
  }
  const V out = red[x];
  __syncthreads();  // red is free for the next call
  return out;
}

// ---------------------------------------------------------------------------
// center_gather
// Replaces allegro_tpu/ops/fused_tp.py:_center_broadcast_kernel
// (center_broadcast_call). Bound: the write of out [E, C] (the reads of a
// [n_atoms, C] and of the index are a few percent of it, and a stays in L2).
// The TPU needed a one-hot MXU product (with a bf16 split to stay exact);
// here a copy, exact by construction, split by the row's width:
//   - narrow rows (C <= kNarrow: positions, energies): a warp per 32
//     edges reads their indices once, a lane each, and stores the warp's C
//     x 32 outputs as C coalesced 128-byte rows, each float's index shuffled
//     from its edge's lane (center_gather_narrow_kernel);
//   - wide rows (the pallas env sums, a class lookup), on either side: a
//     group of row_lanes lanes per edge reads the index once and copies the
//     row, as float4 where it can (see vadd), the table's rows from L2
//     (center_gather_rows_kernel). On an H100 at C = 288 and 256 it ran as
//     fast as a form that stored each atom's row to its edge range on the
//     center side (PERF.md), so that form is not kept.
// Each grid is sized to its work; every offset is 64-bit (E x C passes 2^31
// at 100k atoms and C = 1,024).
// ---------------------------------------------------------------------------
__global__ void center_gather_narrow_kernel(const float* __restrict__ a,
                                            const int* __restrict__ idx, long long n_edges,
                                            int n_atoms, int C, float* __restrict__ out) {
  // a warp per 32 edges: lane l reads edge e0 + l's index, then stores the
  // floats l, l + 32, ... of the warp's C x 32 contiguous outputs, each
  // float's index taken from its edge's lane by a shuffle
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp * kWarp;
  const int lane = threadIdx.x % kWarp;
  const int mine = e0 + lane < n_edges ? idx[e0 + lane] : n_atoms;
  const long long n_out = min((long long)kWarp, n_edges - e0) * C;
#pragma unroll
  for (int j = 0; j < kNarrow; ++j) {
    if (j >= C) break;
    const int f = lane + kWarp * j, edge = f / C;
    const int i = __shfl_sync(0xffffffffu, mine, edge);
    if (f < n_out)
      out[e0 * C + f] = i >= 0 && i < n_atoms ? a[(long long)i * C + f - edge * C] : 0.f;
  }
}

template <typename V>
__global__ void center_gather_rows_kernel(const V* __restrict__ a, const int* __restrict__ idx,
                                          long long n_edges, int n_atoms, int cv,
                                          V* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (e >= n_edges) return;
  const int i = idx[e];
  const bool real = i >= 0 && i < n_atoms;
  for (int q = threadIdx.x; q < cv; q += blockDim.x)
    out[e * cv + q] = real ? a[(long long)i * cv + q] : vzero<V>();
}

// ---------------------------------------------------------------------------
// center_sum
// Replaces allegro_tpu/ops/fused_tp.py:_center_sum_kernel (center_sum_call).
// Bound: one read of v [E, C] (through perm on the neighbor side). The TPU
// summed one-hot window products into two rank-window partials; here CSR
// segment sums in a fixed order (no atomics: two identical calls give the
// same bits), split by the row's width:
//   - narrow rows (C <= kNarrow: the force scatters, the energy sum):
//     kSumLanes lanes per atom; lane j adds the segment's rows j, j +
//     kSumLanes, ... in order (each row's perm[k] read once), so a warp's
//     loads cover consecutive rows of two atoms, and the lanes' sums meet in
//     a fixed xor butterfly (center_sum_narrow_kernel). On an H100 at the
//     flagship's shapes 16 lanes ran faster than 8 and 32 (PERF.md);
//   - wide rows (the pallas env sums, C = d2 U): a thread per (atom, vector)
//     adds its segment's rows in edge order, as float4 where it can, the
//     same per-column order as a scalar walk (center_sum_segments_kernel);
//   - chunked (a parameter table's class CSR: a few rows of 10^4-10^5
//     positions each) in two passes, below.
// Atoms without edges get 0; positions after row_ptr[n_atoms] are not read.
// ---------------------------------------------------------------------------
__global__ void center_sum_narrow_kernel(const float* __restrict__ v,
                                         const int* __restrict__ row_ptr,
                                         const int* __restrict__ perm, int n_atoms, int C,
                                         float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long atom = t / kSumLanes;
  const int lane = (int)(t % kSumLanes);
  float s[kNarrow] = {};
  if (atom < n_atoms) {
    const int k1 = row_ptr[atom + 1];
#pragma unroll 4
    for (int k = row_ptr[atom] + lane; k < k1; k += kSumLanes) {
      const long long r = perm ? perm[k] : k;
#pragma unroll
      for (int c = 0; c < kNarrow; ++c)
        if (c < C) s[c] += v[r * C + c];
    }
  }
  // every lane of the warp takes part (blockDim.x is a multiple of 32)
#pragma unroll
  for (int m = kSumLanes / 2; m > 0; m >>= 1)
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], m);
  if (atom < n_atoms && lane == 0)
#pragma unroll
    for (int c = 0; c < kNarrow; ++c)
      if (c < C) out[atom * C + c] = s[c];
}

template <typename V>
__global__ void center_sum_segments_kernel(const V* __restrict__ v,
                                           const int* __restrict__ row_ptr,
                                           const int* __restrict__ perm, int n_atoms, int cv,
                                           V* __restrict__ out) {
  const int atom = blockIdx.x * blockDim.y + threadIdx.y;
  if (atom >= n_atoms) return;
  const int k0 = row_ptr[atom], k1 = row_ptr[atom + 1];
  for (int q = threadIdx.x; q < cv; q += blockDim.x) {
    V s = vzero<V>();
#pragma unroll 4
    for (int k = k0; k < k1; ++k) vadd(s, v[(perm ? (long long)perm[k] : k) * cv + q]);
    out[(long long)atom * cv + q] = s;
  }
}

// center_sum over a class CSR, in two passes and no buffer to clear. Pass 1
// (center_sum_chunks_kernel): block (i, y) takes CSR positions [i chunk,
// (i + 1) chunk) and the y-th slice of blockDim.x vectors of the columns;
// for each row r whose segment meets the chunk (rows in order), its y
// lanes add the piece's positions lo + y, lo + y + blockDim.y, ... in
// order, block_sum_y adds the lanes, and the sum goes to partial[i + r]:
// row r's pieces take the consecutive entries [first(r) + r, last(r) + r]
// (first and last its chunks), and no two pieces share one, so pass 1
// writes every entry pass 2 reads. Pass 2 (center_sum_partials_kernel):
// block (r, y) adds row r's entries the same way (0 for an empty row). A
// fixed order, no atomics; each chunk's rows are read once, coalesced
// along the row, with each row's perm[k] read once.
template <typename V>
__global__ void center_sum_chunks_kernel(const V* __restrict__ v,
                                         const int* __restrict__ row_ptr,
                                         const int* __restrict__ perm, int n_rows, int cv,
                                         int chunk, V* __restrict__ partial) {
  __shared__ V red[kThreads];
  const long long k0 = (long long)blockIdx.x * chunk;
  const int end = row_ptr[n_rows];
  if (k0 >= end) return;
  const int k1 = (int)min(k0 + chunk, (long long)end);
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  int r = 0, hi = n_rows;  // the last row whose segment starts at or before k0
  while (hi - r > 1) {
    const int mid = (r + hi) / 2;
    if (row_ptr[mid] <= k0) r = mid;
    else hi = mid;
  }
  for (; r < n_rows && row_ptr[r] < k1; ++r) {
    const int lo = max(row_ptr[r], (int)k0), up = min(row_ptr[r + 1], k1);
    if (lo >= up) continue;  // an empty row (the whole block skips it)
    V s = vzero<V>();
    if (q < cv)
      for (int k = lo + threadIdx.y; k < up; k += blockDim.y)
        vadd(s, v[(perm ? (long long)perm[k] : k) * cv + q]);
    s = block_sum_y(s, red);
    if (threadIdx.y == 0 && q < cv) partial[(blockIdx.x + (long long)r) * cv + q] = s;
  }
}

template <typename V>
__global__ void center_sum_partials_kernel(const V* __restrict__ partial,
                                           const int* __restrict__ row_ptr, int cv, int chunk,
                                           V* __restrict__ out) {
  __shared__ V red[kThreads];
  const int r = blockIdx.x, q = blockIdx.y * blockDim.x + threadIdx.x;
  const int b = row_ptr[r], e = row_ptr[r + 1];
  V s = vzero<V>();
  if (b < e && q < cv)
    for (long long p = b / chunk + r + threadIdx.y; p <= (e - 1) / chunk + r; p += blockDim.y)
      vadd(s, partial[p * cv + q]);
  s = block_sum_y(s, red);
  if (threadIdx.y == 0 && q < cv) out[(long long)r * cv + q] = s;
}

template <typename V>
int launch_center_gather(const float* a, const int* idx, long long n_edges, int n_atoms, int cv,
                         float* out, cudaStream_t stream) {
  const int tx = row_lanes(cv), ty = kThreads / tx;
  center_gather_rows_kernel<V><<<(unsigned)((n_edges + ty - 1) / ty), dim3(tx, ty), 0, stream>>>(
      reinterpret_cast<const V*>(a), idx, n_edges, n_atoms, cv, reinterpret_cast<V*>(out));
  return (int)cudaGetLastError();
}

template <typename V>
int launch_center_sum(const float* v, const int* row_ptr, const int* perm, int n_atoms, int cv,
                      float* out, cudaStream_t stream) {
  const int tx = min(cv, kThreads), ty = kThreads / tx;
  center_sum_segments_kernel<V><<<(n_atoms + ty - 1) / ty, dim3(tx, ty), 0, stream>>>(
      reinterpret_cast<const V*>(v), row_ptr, perm, n_atoms, cv, reinterpret_cast<V*>(out));
  return (int)cudaGetLastError();
}

template <typename V>
int launch_center_sum_chunked(const float* v, const int* row_ptr, const int* perm, int n_rows,
                              int cv, long long n_pos, int chunk, float* partial, float* out,
                              cudaStream_t stream) {
  const int tx = row_lanes(cv), ty = kThreads / tx;
  const unsigned slices = (unsigned)((cv + tx - 1) / tx);
  const long long n_chunks = (n_pos + chunk - 1) / chunk;
  if (n_chunks > 0)
    center_sum_chunks_kernel<V><<<dim3((unsigned)n_chunks, slices), dim3(tx, ty), 0, stream>>>(
        reinterpret_cast<const V*>(v), row_ptr, perm, n_rows, cv, chunk,
        reinterpret_cast<V*>(partial));
  center_sum_partials_kernel<V><<<dim3(n_rows, slices), dim3(tx, ty), 0, stream>>>(
      reinterpret_cast<const V*>(partial), row_ptr, cv, chunk, reinterpret_cast<V*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// readout_sum
// Replaces allegro_tpu/ops/fused_tp.py:_readout_sum_kernel (readout_sum_call).
// Bound: the one read of the pieces [E, K] (79.5 MB at the flagship, ~0.0238
// ms at 3.35 TB/s) and K*H FMAs per edge (6,144 at K = 192, H = 32; ~0.019 ms
// at 67 TFLOP/s): the two are close, so the loads have to overlap the math.
// The hidden activations and the per-edge energies never reach device
// memory, as on the TPU. Design: a register-tiled product, as readout_bwd's
// first, on atom-aligned edge ranges, a persistent grid of kRsThreads-thread
// blocks:
//   - block b of G owns the atoms whose first edge lies in [b E' / G, (b + 1)
//     E' / G), E' = row_ptr[n_atoms] (the last block also those at E', the
//     atoms without edges at the end), found by a search of the whole block
//     in row_ptr (two rounds of one load each at 4,096 atoms), and walks
//     their edges in tiles of kRows = kRsThreads / kRsCols * 4 (128 edges):
//     the ranges balance edges, not atoms, so unequal segments do not
//     unbalance the grid, and each atom is summed by one block in edge
//     order, in one launch, with no partials;
//   - a tile's piece rows stream in by cp.async in stages of kRsStage
//     columns of K (16-byte copies where a piece allows, else 4-byte ones)
//     into a ring of kRsBufs small buffers, the next stage loading while
//     this one's product runs; so the block's shared memory is W0^T, staged
//     once (read in W0's own order) and zero-padded as [Hr][ldK], and the
//     ring, and three blocks fit on an SM at the flagship;
//   - pre = A W0 by common.cu's mma_rows, exact FP32 FMAs, 4 rows x 8 columns
//     of each 32-column chunk of H a thread (kRsCols = 4 threads a row
//     group), so 12 float4 reads from shared memory feed 128 FMAs (8 feed
//     64 in readout_bwd's 4 x 4 at H = 32); a warp whose rows all lie
//     past the tile's edges skips it. Then each thread's share of each of
//     its rows' energy, sum_j silu(pre) w1[h] (pre itself without a hidden
//     layer, w1 = e_0), added over the chunks in order and across the row's
//     threads by a fixed xor butterfly;
//   - the tile's per-edge energies go to shared memory (kRows floats), and a
//     thread per atom of the tile adds its rows in edge order onto its
//     running sum; the sum of the atom that crosses into the next tile
//     carries over in shared memory, and energy[a] is written once, when its
//     last edge is added.
// Atoms without edges get 0; nothing past row_ptr[n_atoms] is read. No TF32
// and no tensor cores (precision "highest"). Where shared memory does not
// hold W0^T and the ring (wide K), the launcher takes blocks of half, then a
// quarter of the threads. Every per-edge energy is the same sum whichever
// tile holds its row, and every atom's one block adds them in edge order:
// two identical calls give identical bits, whatever the grid. No atomics.
// Measured on an H100 and not kept (PERF.md, PR 14): a tile's rows staged
// whole (64 edges, 4 x 4 or 4 x 8 micro-tiles, 32-edge tiles), staged by
// piece into the whole-K tile, 8 x 8 micro-tiles, 64-column stages, three
// buffers: all as fast or slower.
// ---------------------------------------------------------------------------
constexpr int kRsThreads = 128;  // threads per block
constexpr int kRsCols = 4;       // column groups: threads per row group of 4 rows, 32 / kRsCols
                                 // columns each
constexpr int kRsStage = 32;     // columns of K a stage loads (its buffers' stride: kRsStage + 4)
constexpr int kRsBufs = 2;       // stage buffers: a step loads kRsBufs - 1 steps ahead
constexpr int kRsMinBlocks = 3;  // blocks an SM holds (their shared memory fits three at the
                                 // flagship): without it ptxas caps the registers at 128 and spills

// Shared-memory layout of readout_sum, offsets in floats (multiples of 4).
struct RsLayout {
  int ldK;                           // stride of W0^T's K-wide rows
  int w0t, w1, a, en, carry, total;  // W0^T [Hr][ldK], w1 [Hr], the stage buffers
                                     // [kRsBufs][rows][kRsStage + 4], the tile's energies
                                     // [rows], the carried atom sum (two slots)
};

__host__ __device__ inline RsLayout rs_layout(int K, int H, int rows) {
  RsLayout L;
  L.ldK = tile_ld(K);
  const int Hr = round_up(H, kWarp);
  int o = 0;
  L.w0t = o;
  o += Hr * L.ldK;
  L.w1 = o;
  o += Hr;
  L.a = o;
  o += kRsBufs * rows * (kRsStage + 4);
  L.en = o;
  o += rows;
  L.carry = o;
  o += 4;
  L.total = round_up(o, 4);
  return L;
}

// The first atom a in [lo, hi) with row_ptr[a] >= e (hi if none), searched
// by the block's kT threads together (every thread calls it, with the same
// arguments): each round probes kT evenly spaced atoms of the range, so
// 4,096 atoms take two rounds of one load each.
template <int kT>
__device__ __forceinline__ int block_first_atom(const int* __restrict__ row_ptr, int lo, int hi,
                                                long long e) {
  while (lo < hi) {  // the atom lies in [lo, hi]
    const int stride = (hi - lo + kT - 1) / kT;
    const int p = lo + (int)threadIdx.x * stride;
    // probes 0 .. c - 1 lie before e: the atom is in (probe c - 1, probe c]
    const int c = __syncthreads_count(p < hi && __ldg(row_ptr + p) < e);
    const int next_hi = min(hi, lo + c * stride);
    lo = c == 0 ? lo : lo + (c - 1) * stride + 1;
    hi = next_hi;
  }
  return lo;
}

// Columns [c0, c1) of K (at most kRsStage; c0 a multiple of 4) of rows [e0,
// e0 + rows) of the pieces into the stage buffer S (stride kRsStage + 4) by
// cp.async, 16 bytes where the piece allows, else 4; where c1 - c0 is not a
// multiple of 4, the columns up to the next one are set to zero.
template <int kThreads, int kRows>
__device__ __forceinline__ void rs_load_stage(const Pieces& P, long long e0, int rows, int c0,
                                              int c1, float* S, int tid) {
  constexpr int ld = kRsStage + 4;
  for (int i = 0; i < P.n; ++i) {
    const int lo = max(c0, P.off[i]), hi = min(c1, P.off[i] + P.dim[i]);
    if (lo >= hi) continue;
    float* dst = S + (lo - c0);
    const int w = hi - lo;
    if (P.bf16 >> i & 1) {  // a bf16 piece: plain loads, widened
      load_bf16_rows<kThreads>(piece_bf16(P, i) + e0 * P.stride[i] + (lo - P.off[i]),
                               P.stride[i], rows, w, dst, ld, tid);
      continue;
    }
    const float* src = P.ptr[i] + e0 * P.stride[i] + (lo - P.off[i]);
    if (piece_vec4(P.ptr[i], P.stride[i], P.dim[i], P.off[i])) {  // then lo, hi multiples of 4
      const int w4 = w / 4;
      for (int q = tid; q < rows * w4; q += kThreads) {
        const int m = q / w4, k = 4 * (q - m * w4);
        cp_async16(dst + m * ld + k, src + m * P.stride[i] + k);
      }
    } else {
      for (int q = tid; q < rows * w; q += kThreads) {
        const int m = q / w, k = q - m * w;
        cp_async4(dst + m * ld + k, src + m * P.stride[i] + k);
      }
    }
  }
  const int w = c1 - c0, pad = round_up(w, 4) - w;
  for (int q = tid; q < kRows * pad; q += kThreads) {
    const int m = q / pad;
    S[m * ld + w + (q - m * pad)] = 0.f;
  }
}

// silu(x) = x sigmoid(x): expf, then the correctly rounded reciprocal and one
// multiply (one rounding more than x / (1 + e^-x), in fewer instructions).
__device__ __forceinline__ float rs_silu(float x) { return x * __frcp_rn(1.f + expf(-x)); }

template <bool kSilu, int kT>
__global__ void __launch_bounds__(kT, kRsMinBlocks) readout_sum_kernel(
    Pieces P, const float* __restrict__ w0, const float* __restrict__ w1,
    const int* __restrict__ row_ptr, int n_atoms, int K, int H, RsLayout L,
    float* __restrict__ energy) {
  extern __shared__ float smem[];
  constexpr int kCx = kRsCols, TM = 4;  // mma_rows's 4 rows a thread
  constexpr int TN = kWarp / kCx;        // a thread's columns of a 32-column chunk of H
  constexpr int kRows = kT / kCx * TM;
  constexpr int ldS = kRsStage + 4;
  constexpr unsigned kMask = kT >= kWarp ? 0xffffffffu : (1u << (kT & 31)) - 1u;  // a warp's lanes
  const int tid = threadIdx.x, ty = tid / kCx, tx = tid % kCx, m0 = ty * TM;
  // the first row of the thread's warp: a warp whose rows all lie past the
  // tile's edges skips the product (warp-uniform, so its shuffles stay whole)
  const int warp_row = (tid / kWarp) * kWarp / kCx * TM;
  float* W0t = smem + L.w0t;
  float* W1 = smem + L.w1;
  float* A = smem + L.a;  // stage buffer b at A + b * kRows * ldS
  float* En = smem + L.en;
  float* carry = smem + L.carry;
  // the block's atoms [a_first, a_end) and their edges [eb, ee)
  const long long n_edges = __ldg(row_ptr + n_atoms);
  const long long lo = (long long)blockIdx.x * n_edges / gridDim.x;
  const long long hi = (long long)(blockIdx.x + 1) * n_edges / gridDim.x;
  const int a_first = block_first_atom<kT>(row_ptr, 0, n_atoms, lo);
  const int a_end =
      blockIdx.x + 1 == gridDim.x ? n_atoms : block_first_atom<kT>(row_ptr, a_first, n_atoms, hi);
  const long long eb = __ldg(row_ptr + a_first), ee = __ldg(row_ptr + a_end);
  // a tile's steps: each 32-column chunk of H over each stage of K; the
  // block's step g runs on buffer g % kRsBufs while steps up to g +
  // kRsBufs - 1 load
  const int n_st = max((K + kRsStage - 1) / kRsStage, 1), n_ch = (H + 31) / 32;
  const int steps = n_st * n_ch;
  const auto load_step = [&](int g) {
    const long long e0 = eb + (long long)(g / steps) * kRows;
    const int c0 = (g % steps) % n_st * kRsStage;
    if (e0 < ee && K > 0)
      rs_load_stage<kT, kRows>(P, e0, (int)min((long long)kRows, ee - e0), c0,
                               min(K, c0 + kRsStage), A + (g % kRsBufs) * kRows * ldS, tid);
    cp_async_commit();
  };
  // the block's first steps load while the weights are staged
  for (int g = 0; g + 1 < kRsBufs; ++g) load_step(g);
  // W0^T: W0 read in its own order (coalesced), then the padding zeroed
  const int Hr = round_up(H, kWarp);
#pragma unroll 4
  for (int q = tid; q < K * H; q += kT) {
    const int k = q / H;
    W0t[(q - k * H) * L.ldK + k] = __ldg(w0 + q);
  }
  for (int q = tid; q < Hr * L.ldK; q += kT) {
    const int h = q / L.ldK, k = q - h * L.ldK;
    if (h >= H || k >= K) W0t[q] = 0.f;
  }
  for (int h = tid; h < Hr; h += kT)
    W1[h] = h >= H ? 0.f : kSilu ? w1[h] : (h == 0 ? 1.f : 0.f);
  int a_lo = a_first;  // the block's first atom whose energy is not written yet
  int slot = 0;        // the carry slot this tile reads
  int g = 0;           // the block's step count
  for (long long e0 = eb; e0 < ee; e0 += kRows) {
    const long long e1 = min(e0 + kRows, ee);
    const bool busy = warp_row < e1 - e0;
    float en[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) en[i] = 0.f;
    for (int c = 0; c < n_ch; ++c) {
      float acc[4][8];
      zero_acc(acc);
      for (int s = 0; s < n_st; ++s, ++g) {
        cp_async_wait<kRsBufs - 2>();
        __syncthreads();  // step g is in, and every thread is done with step g - 1's buffer
        load_step(g + kRsBufs - 1);
        const int c0 = s * kRsStage;
        if (busy && K > 0)
          mma_rows<TN, kCx>(A + (g % kRsBufs) * kRows * ldS + m0 * ldS, ldS,
                            W0t + (32 * c + tx) * L.ldK + c0, L.ldK,
                            round_up(min(K, c0 + kRsStage) - c0, 4), acc);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {  // the thread's shares of its rows' energies
        const float w = W1[32 * c + tx + kCx * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) en[i] = fmaf(kSilu ? rs_silu(acc[i][j]) : acc[i][j], w, en[i]);
      }
    }
    if (busy) {  // the row's shares, added by a fixed xor butterfly
#pragma unroll
      for (int o = 1; o < kCx; o <<= 1)
#pragma unroll
        for (int i = 0; i < TM; ++i) en[i] += __shfl_xor_sync(kMask, en[i], o);
      if (tx == 0)
#pragma unroll
        for (int i = 0; i < TM; ++i) En[m0 + i] = en[i];
    }
    __syncthreads();  // the energies are in
    // a thread per atom with an edge before e1: its rows of the tile, in edge order
    const int a_hi = block_first_atom<kT>(row_ptr, a_lo, a_end, e1);
    for (int a = a_lo + tid; a < a_hi; a += kT) {
      const long long s0 = __ldg(row_ptr + a), s1 = __ldg(row_ptr + a + 1);
      float s = s0 < e0 ? carry[slot] : 0.f;
      const int r1 = (int)(min(s1, e1) - e0);
      for (int r = (int)(max(s0, e0) - e0); r < r1; ++r) s += En[r];
      if (s1 <= e1)
        energy[a] = s;
      else
        carry[slot ^ 1] = s;  // the last atom, which crosses into the next tile
    }
    a_lo = a_hi > a_lo && __ldg(row_ptr + a_hi) > e1 ? a_hi - 1 : a_hi;
    slot ^= 1;
  }
  for (int a = a_lo + tid; a < a_end; a += kT) energy[a] = 0.f;  // without edges, at E'
  cp_async_wait<0>();
}

template <bool kSilu, int kT>
int launch_readout_sum(const Pieces& P, const float* w0, const float* w1, const int* row_ptr,
                       int n_atoms, int K, int H, float* energy, cudaStream_t stream) {
  const RsLayout L = rs_layout(K, H, kT / kRsCols * 4);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = readout_sum_kernel<kSilu, kT>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(kernel, kT, smem, n_atoms, 1);
  kernel<<<blocks, kT, smem, stream>>>(P, w0, w1, row_ptr, n_atoms, K, H, L, energy);
  return (int)cudaGetLastError();
}

// The widest block whose shared memory (W0^T with the stage buffers) fits in
// ``limit`` bytes: kRsThreads threads, then half, then a quarter (a quarter
// where none fits: its launch then fails). The model's routing rule
// (ops/smem_fit.py) holds the same choice, through atpt_readout_sum_smem.
inline int rs_threads(int K, int H, size_t limit) {
  for (int threads = kRsThreads; threads > kRsThreads / 4; threads /= 2)
    if ((size_t)rs_layout(K, H, threads / kRsCols * 4).total * sizeof(float) <= limit)
      return threads;
  return kRsThreads / 4;
}

template <bool kSilu>
int launch_readout_sum_fit(const Pieces& P, const float* w0, const float* w1, const int* row_ptr,
                           int n_atoms, int K, int H, float* energy, cudaStream_t stream) {
  const int threads = rs_threads(K, H, smem_optin());
  if (threads == kRsThreads)
    return launch_readout_sum<kSilu, kRsThreads>(P, w0, w1, row_ptr, n_atoms, K, H, energy,
                                                 stream);
  if (threads == kRsThreads / 2)
    return launch_readout_sum<kSilu, kRsThreads / 2>(P, w0, w1, row_ptr, n_atoms, K, H, energy,
                                                     stream);
  return launch_readout_sum<kSilu, kRsThreads / 4>(P, w0, w1, row_ptr, n_atoms, K, H, energy,
                                                   stream);
}

// ---------------------------------------------------------------------------
// readout_bwd
// Replaces allegro_tpu/ops/fused_tp.py:_readout_bwd_kernel (readout_bwd_call).
// Bound: the read of the pieces and the write of their cotangents [E, K]
// (79.5 MB each way at the flagship: K = 192, ~0.048 ms at 3.35 TB/s) and
// 2*K*H FMAs per edge (~0.038 ms at 67 TFLOP/s, H = 32): the two are close,
// so the loads and stores have to overlap the math. Design: a register-tiled
// GEMM chain on tiles of kRows edges, a persistent grid of blocks of
// 2 * kRows threads, as many as fit on the card, each walking its tiles:
//   pre = A W0      (common.cu's mma_rows as csrc/mega.cu runs it: 4 x 8 micro-
//                    tiles, 4 x 4 on a last chunk of 32 hidden units)
//   dh  = y[c(e)] w1 silu'(pre), in the same registers, stored as dh^T
//   dA  = dh W0^T   (a thread keeps dh of its 4 rows for 32 hidden units in
//                    registers, so each float4 of W0^T feeds 16 FMAs; mma_cols'
//                    4 x 8 tiles feed 10.7 and were slower on an H100)
// A block stages W0^T once, zero-padded, as [Hr][ldK]: both products read
// its rows without bank conflicts. A tile's piece rows come in by cp.async
// (16-byte copies where a piece's pointer, stride and width allow, else
// 4-byte ones) with its centers; each thread gathers y at the centers of its
// 4 rows while the first product runs. Once dh^T is stored the piece rows
// are dead, so the next tile's rows load into the same buffer during this
// tile's second product: one buffer keeps two blocks on an SM at the
// flagship, whose loads and math overlap each other's (a second buffer,
// loaded during the whole of this tile's math, leaves one block per SM and
// was slower on an H100). dA leaves straight from the registers: each output
// element is stored once, as a float4 of 4 consecutive columns of one row
// where every output piece allows, else column by column; no
// read-modify-write.
// Without a hidden layer (H = 1, w1 = e_0) dh is y[c(e)] and the pieces are
// not read. A sentinel edge gets dh = 0, so a zero row, whatever its pieces
// hold. Exact FP32 FMAs: no TF32, no tensor cores (precision "highest").
// Where shared memory does not hold W0^T and a 64-edge tile (wide K), the
// launcher takes tiles of 32, then 16 edges. Every output element is one
// thread's sum in a fixed order: no atomics.
// ---------------------------------------------------------------------------

// Shared-memory layout of readout_bwd, offsets in floats (multiples of 4).
struct RbLayout {
  int ldK, ldM;  // strides of K-wide rows and of kRows-wide rows
  int w0t, w1, a, dht, c, total;  // W0^T [Hr][ldK], w1 [Hr], the piece rows [kRows][ldK]
                                  // (with a hidden layer), dh^T [round_up(H, 4)][ldM],
                                  // the centers [kRows]
};

__host__ __device__ inline RbLayout rb_layout(int K, int H, int rows, bool hidden) {
  RbLayout L;
  L.ldK = tile_ld(K);
  L.ldM = rows + 4;
  const int Hr = round_up(H, kWarp);
  int o = 0;
  L.w0t = o;
  o += Hr * L.ldK;
  L.w1 = o;
  o += Hr;
  L.a = o;
  o += hidden ? rows * L.ldK : 0;
  L.dht = o;
  o += round_up(H, 4) * L.ldM;
  L.c = o;
  o += rows;
  L.total = round_up(o, 4);
  return L;
}

// Rows [e0, e0 + kRows) of the pieces (with a hidden layer) and their
// centers into the tile, by cp.async; rows past n_edges are left as they are.
template <bool kSilu, int kRows>
__device__ __forceinline__ void rb_load_tile(const Pieces& P, const int* __restrict__ centers,
                                             long long e0, long long n_edges, float* A, int ldK,
                                             int* Tc) {
  if (kSilu) load_piece_rows<kRows, 2 * kRows>(P, e0, n_edges, A, ldK, threadIdx.x);
  for (int q = threadIdx.x; q < kRows && e0 + q < n_edges; q += 2 * kRows)
    cp_async4(reinterpret_cast<float*>(Tc + q), reinterpret_cast<const float*>(centers + e0 + q));
}

// Row e's output columns [c, c + 4) from v: one float4 store where every
// output piece allows (vec: then K and every piece's offset are multiples of
// 4, so the 4 columns lie in one piece), else one store per column below K.
__device__ __forceinline__ void rb_store4(const OutPieces& D, long long e, int c, int K,
                                          float4 v, bool vec) {
  if (vec) {
    int i = 0;
    while (i + 1 < D.n && D.off[i + 1] <= c) ++i;
    *reinterpret_cast<float4*>(D.ptr[i] + e * D.stride[i] + (c - D.off[i])) = v;
    return;
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (c + q >= K) break;
    int i = 0;
    while (i + 1 < D.n && D.off[i + 1] <= c + q) ++i;
    D.ptr[i][e * D.stride[i] + (c + q - D.off[i])] = f[q];
  }
}

template <bool kSilu, int kRows>
__global__ void __launch_bounds__(2 * kRows) readout_bwd_kernel(
    Pieces P, OutPieces D, bool vec_out, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ y, const int* __restrict__ centers,
    long long n_edges, int n_atoms, int K, int H, RbLayout L) {
  extern __shared__ float smem[];
  constexpr int T = 2 * kRows;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8, m0 = ty * 4;
  float* W0t = smem + L.w0t;
  float* W1 = smem + L.w1;
  float* A = smem + L.a;
  float* DhT = smem + L.dht;
  int* Tc = reinterpret_cast<int*>(smem + L.c);
  const long long n_tiles = (n_edges + kRows - 1) / kRows;
  // the block's first tile loads while the weights are staged
  if (blockIdx.x < n_tiles)
    rb_load_tile<kSilu, kRows>(P, centers, (long long)blockIdx.x * kRows, n_edges, A, L.ldK, Tc);
  cp_async_commit();
  const int Hr = round_up(H, kWarp);
  for (int q = tid; q < Hr * L.ldK; q += T) {
    const int h = q / L.ldK, k = q - h * L.ldK;
    W0t[q] = (h < H && k < K) ? w0[(long long)k * H + h] : 0.f;
  }
  for (int h = tid; h < Hr; h += T) W1[h] = (kSilu && h < H) ? w1[h] : 0.f;
  if (kSilu) {  // the piece rows' padding columns stay zero (cp.async fills [0, K))
    const int pad = L.ldK - K;
    for (int q = tid; q < kRows * pad; q += T) {
      const int m = q / pad;
      A[m * L.ldK + K + (q - m * pad)] = 0.f;
    }
  }
  const int Kd = round_up(K, 4);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long e0 = tile * kRows;
    cp_async_wait<0>();
    __syncthreads();  // the tile's rows are in, and the last tile's dh^T is read
    float ye[4];      // y at the centers of the thread's rows, 0 on sentinel edges
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = e0 + m0 + i < n_edges ? Tc[m0 + i] : -1;
      ok[i] = c >= 0 && c < n_atoms;
      ye[i] = ok[i] ? __ldg(y + c) : 0.f;
    }
    if (kSilu) {
      // pre = A W0, leaving the registers as dh^T
      col_chunks(H, [&](auto tn, int h0) {
        constexpr int TN = decltype(tn)::value;
        float acc[4][8];
        zero_acc(acc);
        mma_rows<TN>(A + m0 * L.ldK, L.ldK, W0t + (h0 + tx) * L.ldK, L.ldK, Kd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int h = h0 + tx + 8 * j;
          if (h >= H) continue;
          float dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i] = ok[i] ? ye[i] * W1[h] * silu_grad(acc[i][j]) : 0.f;
          *reinterpret_cast<float4*>(DhT + h * L.ldM + m0) = make_float4(dv[0], dv[1], dv[2], dv[3]);
        }
      });
    } else if (tx == 0) {
      *reinterpret_cast<float4*>(DhT + m0) = make_float4(ye[0], ye[1], ye[2], ye[3]);
    }
    __syncthreads();  // dh^T is stored: the piece rows and centers are free
    if (tile + gridDim.x < n_tiles)
      rb_load_tile<kSilu, kRows>(P, centers, (tile + gridDim.x) * kRows, n_edges, A, L.ldK, Tc);
    cp_async_commit();
    // dA = dh W0^T, from the registers to the output pieces: dh of the
    // thread's 4 rows for 32 hidden units at a time in registers (zero past
    // H, as W0^T's rows are), the thread's column groups 4 tx + 32 n, one
    // float4 of W0^T's row per hidden unit feeding 16 FMAs
    float dh[4][kWarp];
    const auto load_dh = [&](int hc) {
#pragma unroll
      for (int h = 0; h < kWarp; ++h) {
        const float* row = DhT + (hc + h) * L.ldM + m0;
        const float4 v = hc + h < H ? *reinterpret_cast<const float4*>(row)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        dh[0][h] = v.x;
        dh[1][h] = v.y;
        dh[2][h] = v.z;
        dh[3][h] = v.w;
      }
    };
    load_dh(0);
    for (int c = 4 * tx; c < K; c += 4 * 8) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int hc = 0; hc < H; hc += kWarp) {
        if (H > kWarp) load_dh(hc);  // more than 32 hidden units: reloaded per column group
#pragma unroll
        for (int h = 0; h < kWarp; ++h) {
          const float4 w = *reinterpret_cast<const float4*>(W0t + (hc + h) * L.ldK + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i].x = fmaf(dh[i][h], w.x, a[i].x);
            a[i].y = fmaf(dh[i][h], w.y, a[i].y);
            a[i].z = fmaf(dh[i][h], w.z, a[i].z);
            a[i].w = fmaf(dh[i][h], w.w, a[i].w);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long e = e0 + m0 + i;
        if (e >= n_edges) break;
        rb_store4(D, e, c, K, a[i], vec_out);
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kSilu, int kRows>
int launch_readout_bwd(const Pieces& P, const OutPieces& D, bool vec_out, const float* w0,
                       const float* w1, const float* y, const int* centers, long long n_edges,
                       int n_atoms, int K, int H, cudaStream_t stream) {
  const RbLayout L = rb_layout(K, H, kRows, kSilu);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = readout_bwd_kernel<kSilu, kRows>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks =
      persistent_blocks(kernel, 2 * kRows, smem, (n_edges + kRows - 1) / kRows, 1);
  kernel<<<blocks, 2 * kRows, smem, stream>>>(P, D, vec_out, w0, w1, y, centers, n_edges,
                                              n_atoms, K, H, L);
  return (int)cudaGetLastError();
}

// The widest tile whose shared memory fits in ``limit`` bytes: 64 edges, then
// 32, then 16 (16 where none fits: its launch then fails). The model's
// routing rule (ops/smem_fit.py) holds the same choice, through
// atpt_readout_bwd_smem.
inline int rb_rows(int K, int H, bool hidden, size_t limit) {
  for (int rows = 64; rows > 16; rows /= 2)
    if ((size_t)rb_layout(K, H, rows, hidden).total * sizeof(float) <= limit) return rows;
  return 16;
}

template <bool kSilu>
int launch_readout_bwd_fit(const Pieces& P, const OutPieces& D, bool vec_out, const float* w0,
                           const float* w1, const float* y, const int* centers, long long n_edges,
                           int n_atoms, int K, int H, cudaStream_t stream) {
  const int rows = rb_rows(K, H, kSilu, smem_optin());
  if (rows == 64)
    return launch_readout_bwd<kSilu, 64>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K,
                                         H, stream);
  if (rows == 32)
    return launch_readout_bwd<kSilu, 32>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K,
                                         H, stream);
  return launch_readout_bwd<kSilu, 16>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K, H,
                                       stream);
}

}  // namespace

// The bfloat16 forms of center_gather and center_sum (a bfloat16 model's
// positions, the pallas env sums and edge energies). The gather is the
// per-row form on bf16 pairs (one bf16 where C is odd or a base is not
// 4-byte aligned), a copy. The sum: the simple schedule, a thread per
// (atom, column) adding its segment in edge order in float and storing the
// sum once, rounded to bfloat16 (JAX's bf16 result of a float32-computed
// sum). The sum's order is fixed, so two calls give the same bits; no
// atomics.
__global__ void center_sum_bf16_kernel(const __nv_bfloat16* __restrict__ v,
                                       const int* __restrict__ row_ptr,
                                       const int* __restrict__ perm, int n_atoms, int C,
                                       __nv_bfloat16* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)n_atoms * C) return;
  const long long atom = q / C;
  const int c = (int)(q - atom * C), k1 = row_ptr[atom + 1];
  float s = 0.f;
  for (int k = row_ptr[atom]; k < k1; ++k)
    s += __bfloat162float(v[(perm ? (long long)perm[k] : k) * C + c]);
  out[q] = __float2bfloat16_rn(s);
}

extern "C" {

int atpt_center_gather_bf16(const void* a, const int* idx, long long n_edges, int n_atoms, int C,
                            void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto* af = static_cast<const float*>(a);
  auto* of = static_cast<float*>(out);
  if (C % 2 == 0 && ((uintptr_t)a & 3) == 0 && ((uintptr_t)out & 3) == 0)
    return launch_center_gather<__nv_bfloat162>(af, idx, n_edges, n_atoms, C / 2, of, st);
  return launch_center_gather<__nv_bfloat16>(af, idx, n_edges, n_atoms, C, of, st);
}

int atpt_center_sum_bf16(const void* v, const int* row_ptr, const int* perm, int n_atoms, int C,
                         void* out, void* stream) {
  const long long n = (long long)n_atoms * C;
  center_sum_bf16_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(v), row_ptr, perm, n_atoms, C,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

int atpt_center_gather(const float* a, const int* idx, long long n_edges, int n_atoms, int C,
                       float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= kNarrow) {
    center_gather_narrow_kernel<<<(unsigned)((n_edges + kThreads - 1) / kThreads), kThreads, 0,
                                  st>>>(a, idx, n_edges, n_atoms, C, out);
    return (int)cudaGetLastError();
  }
  if (C % 4 == 0 && aligned16(a) && aligned16(out))
    return launch_center_gather<float4>(a, idx, n_edges, n_atoms, C / 4, out, st);
  return launch_center_gather<float>(a, idx, n_edges, n_atoms, C, out, st);
}

int atpt_center_sum(const float* v, const int* row_ptr, const int* perm, int n_atoms, int C,
                    float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= kNarrow) {
    const long long threads = (long long)n_atoms * kSumLanes;
    center_sum_narrow_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                               st>>>(v, row_ptr, perm, n_atoms, C, out);
    return (int)cudaGetLastError();
  }
  if (C % 4 == 0 && aligned16(v) && aligned16(out))
    return launch_center_sum<float4>(v, row_ptr, perm, n_atoms, C / 4, out, st);
  return launch_center_sum<float>(v, row_ptr, perm, n_atoms, C, out, st);
}

int atpt_center_sum_chunked(const float* v, const int* row_ptr, const int* perm, int n_rows,
                            int C, long long n_pos, int chunk, float* partial, float* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 4 == 0 && aligned16(v) && aligned16(partial) && aligned16(out))
    return launch_center_sum_chunked<float4>(v, row_ptr, perm, n_rows, C / 4, n_pos, chunk,
                                             partial, out, st);
  return launch_center_sum_chunked<float>(v, row_ptr, perm, n_rows, C, n_pos, chunk, partial,
                                          out, st);
}

// bf16_pieces: bit i, piece i is __nv_bfloat16 (a bfloat16 model's), widened
// as it is staged; w0, w1 and energy are float either way.
int atpt_readout_sum_mixed(const float* const* piece_ptrs, const long long* piece_strides,
                           const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                           const int* row_ptr, int n_atoms, int H, float* energy,
                           int bf16_pieces, void* stream) {
  Pieces P;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0 || H < 1 || n_atoms < 1) return (int)cudaErrorInvalidValue;
  P.n = n_pieces;
  P.bf16 = (unsigned)bf16_pieces;
  cudaStream_t st = (cudaStream_t)stream;
  if (w1) return launch_readout_sum_fit<true>(P, w0, w1, row_ptr, n_atoms, K, H, energy, st);
  return launch_readout_sum_fit<false>(P, w0, w1, row_ptr, n_atoms, K, H, energy, st);
}

int atpt_readout_sum(const float* const* piece_ptrs, const long long* piece_strides,
                     const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                     const int* row_ptr, int n_atoms, int H, float* energy, void* stream) {
  return atpt_readout_sum_mixed(piece_ptrs, piece_strides, piece_dims, n_pieces, w0, w1, row_ptr,
                                n_atoms, H, energy, 0, stream);
}

// bf16_pieces: as atpt_readout_sum_mixed's; the dpieces are float either way.
int atpt_readout_bwd_mixed(const float* const* piece_ptrs, const long long* piece_strides,
                           float* const* dpiece_ptrs, const long long* dpiece_strides,
                           const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                           const float* y, const int* centers, long long n_edges, int n_atoms,
                           int H, int bf16_pieces, void* stream) {
  Pieces P;
  OutPieces D;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0 || H < 1 || n_edges < 1) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;  // no output column
  P.n = D.n = n_pieces;
  P.bf16 = (unsigned)bf16_pieces;
  bool vec_out = true;
  for (int i = 0; i < n_pieces; ++i) {
    D.ptr[i] = dpiece_ptrs[i];
    D.stride[i] = dpiece_strides[i];
    D.dim[i] = P.dim[i];
    D.off[i] = P.off[i];
    vec_out = vec_out && piece_vec4(D.ptr[i], D.stride[i], D.dim[i], D.off[i]);
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (w1)
    return launch_readout_bwd_fit<true>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K,
                                        H, st);
  return launch_readout_bwd_fit<false>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K, H,
                                       st);
}

int atpt_readout_bwd(const float* const* piece_ptrs, const long long* piece_strides,
                     float* const* dpiece_ptrs, const long long* dpiece_strides,
                     const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                     const float* y, const int* centers, long long n_edges, int n_atoms, int H,
                     void* stream) {
  return atpt_readout_bwd_mixed(piece_ptrs, piece_strides, dpiece_ptrs, dpiece_strides,
                                piece_dims, n_pieces, w0, w1, y, centers, n_edges, n_atoms, H, 0,
                                stream);
}

// The bytes of shared memory the launchers above request for a readout of
// input width K and hidden width H (H = 1 and hidden = 0 without a hidden
// layer) on a card whose blocks may opt into ``limit`` bytes: the layout
// they choose, or their smallest where none fits (more than ``limit``: the
// launch is refused). ops/smem_fit.py computes the same on the host, and
// chip_smoke.py holds the two together.
long long atpt_readout_sum_smem(int K, int H, long long limit) {
  return (long long)rs_layout(K, H, rs_threads(K, H, (size_t)limit) / kRsCols * 4).total *
         (long long)sizeof(float);
}

long long atpt_readout_bwd_smem(int K, int H, int hidden, long long limit) {
  return (long long)rb_layout(K, H, rb_rows(K, H, hidden != 0, (size_t)limit), hidden != 0)
             .total * (long long)sizeof(float);
}

}  // extern "C"
