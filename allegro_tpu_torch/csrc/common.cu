// Device helpers shared by the kernels of csrc/*.cu: cp.async copies, the
// sparse Clebsch-Gordan table in shared memory, the register-tiled products
// of the tiled GEMM chains (csrc/mega.cu, readout_sum and readout_bwd in
// csrc/center_readout.cu) with their piece-row loader, and launch-size
// helpers.
//
// The other sources include this file once each, and everything here has
// internal linkage, so each gets its own copy. The build compiles every
// csrc/*.cu, this one too: on its own it defines no symbol.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = kWarp + 1;        // row stride of a warp's 32 x 32 tile: no bank conflicts
constexpr int kMaxPieces = 16;
constexpr int kEdgeWarps = 4;           // warps per block of the per-edge TP kernels
constexpr int kSegmentWarps = 8;        // warps per block of the per-atom-segment kernels
constexpr size_t kSmemLimit = 48 * 1024;

// Asynchronous copies from device to shared memory (cp.async): 4 bytes, or
// 16 aligned bytes; a thread's copies since its last commit form one group,
// and cp_async_wait<n> waits until at most n of its groups are in flight.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies the entry table into shared memory: idx[4n] = (i, j, k, p), coef[n].
__device__ __forceinline__ void load_entries(const int* __restrict__ eidx,
                                             const float* __restrict__ ecoef, int n_entries,
                                             int* s_idx, float* s_coef) {
  for (int t = threadIdx.x; t < 4 * n_entries; t += blockDim.x) s_idx[t] = eidx[t];
  for (int t = threadIdx.x; t < n_entries; t += blockDim.x) s_coef[t] = ecoef[t];
}

// The tensor track's two storage types (the model's `tensor_dtype`): float,
// or __nv_bfloat16 (the bf16 track). A kernel that reads the track widens
// each element to float and computes in float; one that writes it rounds
// once, to nearest even (what `astype(bfloat16)` does), from its float sum.
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v rounded to bf16 and back: the env weights of the bf16 track (JAX's
// `wexp.astype(bfloat16).astype(float32)` inside kernels 7 and 8).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float silu_grad(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
}

// An MLP's input blocks: piece i holds columns [off[i], off[i]+dim[i]) of the
// (virtual) concatenated input; row e of piece i starts at element e *
// stride[i] of ptr[i]. Bit i of bf16 (a bfloat16 model's pieces): piece i's
// elements are __nv_bfloat16 (ptr[i] then holds their address), widened to
// float as they are staged.
struct Pieces {
  const float* ptr[kMaxPieces];
  long long stride[kMaxPieces];
  int dim[kMaxPieces];
  int off[kMaxPieces];
  int n;
  unsigned bf16 = 0;
};

__device__ __forceinline__ const __nv_bfloat16* piece_bf16(const Pieces& P, int i) {
  return reinterpret_cast<const __nv_bfloat16*>(P.ptr[i]);
}

// rows x d bf16 elements (row stride ``stride``) into the float tile dst
// (row stride ld), widened, by the kThreads threads of index tid: plain
// loads (cp.async copies bytes and cannot widen), bf16 pairs where the rows
// allow, four loads in flight a thread.
template <int kThreads>
__device__ __forceinline__ void load_bf16_rows(const __nv_bfloat16* __restrict__ src,
                                               long long stride, int rows, int d, float* dst,
                                               int ld, int tid) {
  if ((d & 1) == 0 && (stride & 1) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    const int d2 = d / 2;
#pragma unroll 4
    for (int q = tid; q < rows * d2; q += kThreads) {
      const int m = q / d2, k = 2 * (q - m * d2);
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + m * stride + k));
      dst[m * ld + k] = v.x;
      dst[m * ld + k + 1] = v.y;
    }
    return;
  }
#pragma unroll 4
  for (int q = tid; q < rows * d; q += kThreads) {
    const int m = q / d, k = q - m * d;
    dst[m * ld + k] = __bfloat162float(src[m * stride + k]);
  }
}

struct OutPieces {
  float* ptr[kMaxPieces];
  long long stride[kMaxPieces];
  int dim[kMaxPieces];
  int off[kMaxPieces];
  int n;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// Register-tiled products in shared memory, exact FP32 FMAs, for a block
// whose thread tid is (ty, tx) = (tid / 8, tid % 8): row group ty owns 4 rows
// of a tile, column group tx 8 columns of a chunk of kMmaCols (TN = 8) or 4 of
// a last chunk of 32 (TN = 4), so each float4 read from shared memory feeds 8
// or more FMAs. Rows of a stored operand that threads read strided have a
// stride of 4 mod 32 floats (tile_ld), so those float4 reads are free of
// bank conflicts.
// ---------------------------------------------------------------------------
constexpr int kMmaCols = 64;  // columns per chunk: 8 column groups of 8

// A row stride of 4 mod 32 floats: 8 threads reading rows r, r+1, ... of it
// as float4 hit 8 distinct bank quads.
__host__ __device__ inline int tile_ld(int width) { return round_up(width, kWarp) + 4; }

template <int TN>
__device__ __forceinline__ void fma_rows(const float4 (&x)[4], const float4 (&y)[TN],
                                         float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
      acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
      acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
      acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
    }
}

template <int TN, int kStep>
__device__ __forceinline__ void load_rows(const float* X, int ldx, const float* Y, int ldy, int k,
                                          float4 (&x)[4], float4 (&y)[TN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(X + i * ldx + k);
#pragma unroll
  for (int j = 0; j < TN; ++j) y[j] = *reinterpret_cast<const float4*>(Y + j * kStep * ldy + k);
}

// acc[i][j] += sum_k X[i][k] Y[kStep j][k] over Kd (a multiple of 4): the
// thread's 4 rows of X (stride ldx) against its TN rows of Y, kStep apart
// (stride ldy): 8 column groups unless the kernel has fewer.
template <int TN, int kStep = 8>
__device__ __forceinline__ void mma_rows(const float* X, int ldx, const float* Y, int ldy, int Kd,
                                         float (&acc)[4][8]) {
#pragma unroll 2
  for (int k = 0; k < Kd; k += 4) {
    float4 x[4], y[TN];
    load_rows<TN, kStep>(X, ldx, Y, ldy, k, x, y);
    fma_rows<TN>(x, y, acc);
  }
}

template <int TN>
__device__ __forceinline__ void load_cols(const float* Lt, int ldl, const float* R, int ldr,
                                          int k, float4 (&a)[4], float4 (&b)[4][2]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s] = *reinterpret_cast<const float4*>(Lt + (k + s) * ldl);
    b[s][0] = *reinterpret_cast<const float4*>(R + (k + s) * ldr);
    if (TN == 8) b[s][1] = *reinterpret_cast<const float4*>(R + (k + s) * ldr + 32);
  }
}

template <int TN>
__device__ __forceinline__ void fma_cols(const float4 (&a)[4], const float4 (&b)[4][2], int n,
                                         float (&acc)[4][8]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s >= n) break;
    const float av[4] = {a[s].x, a[s].y, a[s].z, a[s].w};
    const float bv[8] = {b[s][0].x, b[s][0].y, b[s][0].z, b[s][0].w,
                         b[s][1].x, b[s][1].y, b[s][1].z, b[s][1].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k Lt[k][i] R[k][j'] over Kd: the thread's 4 contiguous
// columns of Lt (row stride ldl) against its TN columns of R, 4 k's at a
// time; j' = j for j < 4 and j + 28 for the last 4 (TN = 8), so the 8
// threads of a quarter warp, whose R starts 4 columns apart, read distinct
// banks. Lt and R must have round_up(Kd, 4) readable rows (the tail rows are
// multiplied by nothing).
template <int TN>
__device__ __forceinline__ void mma_cols(const float* Lt, int ldl, const float* R, int ldr, int Kd,
                                         float (&acc)[4][8]) {
  float4 a[4], b[4][2];
  b[0][1] = b[1][1] = b[2][1] = b[3][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < Kd; k += 4) {
    load_cols<TN>(Lt, ldl, R, ldr, k, a, b);
    fma_cols<TN>(a, b, Kd - k, acc);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// f(TN, c0) over the column chunks of [0, width): kMmaCols columns (8 a
// thread) while they last, then 32 (4 a thread), so no thread idles on a wide
// tail.
template <class F>
__device__ __forceinline__ void col_chunks(int width, F&& f) {
  int c0 = 0;
  for (; c0 + kMmaCols <= width; c0 += kMmaCols) f(std::integral_constant<int, 8>(), c0);
  for (; c0 < width; c0 += kMmaCols / 2) f(std::integral_constant<int, 4>(), c0);
}

// Whether piece i's rows can be copied 16 bytes at a time into a tile whose
// piece columns start at its offset: its pointer, row stride, width and
// offset all 16-byte multiples.
__host__ __device__ inline bool piece_vec4(const float* ptr, long long stride, int dim, int off) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && (stride & 3) == 0 && (dim & 3) == 0 &&
         (off & 3) == 0;
}

// Rows [e0, end) (at most kRows) of each piece into the tile A (row stride
// ld) by cp.async, by the kThreads threads of index tid: 16-byte copies where
// the piece allows (piece_vec4), else 4-byte ones, a warp per row; a bf16
// piece by plain loads widened to float (the caller's cp_async_wait and
// __syncthreads cover both).
template <int kRows, int kThreads>
__device__ __forceinline__ void load_piece_rows(const Pieces& P, long long e0, long long end,
                                                float* A, int ld, int tid) {
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int rows = (int)min((long long)kRows, end - e0);
  for (int i = 0; i < P.n; ++i) {
    float* dst = A + P.off[i];
    const int d = P.dim[i];
    if (P.bf16 >> i & 1) {
      load_bf16_rows<kThreads>(piece_bf16(P, i) + e0 * P.stride[i], P.stride[i], rows, d, dst,
                               ld, tid);
      continue;
    }
    const float* src = P.ptr[i] + e0 * P.stride[i];
    if (piece_vec4(P.ptr[i], P.stride[i], d, P.off[i])) {
      const int d4 = d / 4;
      for (int q = tid; q < rows * d4; q += kThreads) {
        const int m = q / d4, k = 4 * (q - m * d4);
        cp_async16(dst + m * ld + k, src + m * P.stride[i] + k);
      }
    } else {
      for (int m = warp; m < rows; m += kThreads / kWarp)
        for (int k = lane; k < d; k += kWarp)
          cp_async4(dst + m * ld + k, src + m * P.stride[i] + k);
    }
  }
}

// The second pass of a reduction over edges without float atomics: out[t] =
// sum over b of partial[b, t], added in block order, one thread per output.
__global__ void partials_reduce_kernel(const float* __restrict__ partial, int n_blocks, int n,
                                       float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long long)b * n + t];
  out[t] = s;
}


int grid_for(long long work, int per_block, int max_blocks) {
  long long b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < max_blocks ? b : max_blocks);
}

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The most dynamic shared memory one block may opt into (227 KB on Hopper).
size_t smem_optin() {
  int dev = 0, n = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)n;
}

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Checks that ``smem`` bytes of dynamic shared memory fit on the card and
// opts ``kernel`` into them (needed above 48 KB); an error code otherwise.
template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem > smem_optin()) return cudaErrorInvalidConfiguration;
  return set_smem(kernel, smem);
}

// The warps of a per-atom-segment block beside ``fixed`` bytes of shared
// memory at ``per_warp`` bytes each: as many as fit in 48 KB, at most
// ``max_warps``; where not even one fits there, as many as fit in ``optin``
// bytes, the card's opt-in maximum (the launcher then opts in with
// prepare_smem). 0 when none fits at all. *smem gets the bytes to launch with.
int fit_warps(size_t fixed, size_t per_warp, int max_warps, size_t optin, size_t* smem) {
  size_t limit = kSmemLimit;
  if (fixed + per_warp > limit) limit = optin;
  if (fixed + per_warp > limit) return 0;
  size_t warps = (limit - fixed) / per_warp;
  if (warps > (size_t)max_warps) warps = max_warps;
  *smem = fixed + warps * per_warp;
  return (int)warps;
}

// A persistent grid: as many blocks as fit on the card at once, at most one
// per ``per_block`` work items.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem, long long work, int per_block) {
  int per_sm = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess || per_sm < 1)
    per_sm = 1;
  return grid_for(work, per_block, per_sm * sm_count());
}

int fill_pieces(const float* const* ptrs, const long long* strides, const int* dims, int n,
                const float** ptr, long long* stride, int* dim, int* off) {
  if (n < 1 || n > kMaxPieces) return -1;
  int k = 0;
  for (int i = 0; i < n; ++i) {
    ptr[i] = ptrs[i];
    stride[i] = strides[i];
    dim[i] = dims[i];
    off[i] = k;
    k += dims[i];
  }
  return k;
}

}  // namespace
