// Device helpers shared by the kernels of csrc/*.cu: warp reductions,
// cp.async copies, the sparse Clebsch-Gordan table in shared memory, the
// per-edge MLP of a tile of 32 edges (lane = edge) with its backward, and
// launch-size helpers.
//
// The other sources include this file once each, and everything here has
// internal linkage, so each gets its own copy. The build compiles every
// csrc/*.cu, this one too: on its own it defines no symbol.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = kWarp + 1;        // row stride of a warp's 32 x 32 tile: no bank conflicts
constexpr int kMaxPieces = 16;
constexpr int kEdgeWarps = 4;           // warps per block of the per-edge TP kernels
constexpr int kSegmentWarps = 8;        // warps per block of the per-atom-segment kernels
constexpr size_t kSmemLimit = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float silu_grad(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
}

// An MLP's input blocks: piece i holds columns [off[i], off[i]+dim[i]) of the
// (virtual) concatenated input; row e of piece i starts at ptr[i] + e * stride[i].
struct Pieces {
  const float* ptr[kMaxPieces];
  long long stride[kMaxPieces];
  int dim[kMaxPieces];
  int off[kMaxPieces];
  int n;
};

struct OutPieces {
  float* ptr[kMaxPieces];
  long long stride[kMaxPieces];
  int dim[kMaxPieces];
  int off[kMaxPieces];
  int n;
};

// ---------------------------------------------------------------------------
// The first layer of a per-edge MLP for a tile of 32 edges, one warp, lane =
// edge: lane l gets pre[j] = sum_k x[e0+l, k] W[k, h0+j] for a chunk of 32
// output units. The pieces are read 32 x 32 at a time into the warp's
// shared-memory tile, one coalesced 128-byte row piece per load, and each lane
// then reads its own row of the tile. W sits in shared memory as [K][ldw]
// with ldw a multiple of 32 and zero padding, so its reads are float4
// broadcasts (every lane reads the same row) and need no guards. Rows of the
// tile past the n edges of the tile are zero.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void hidden_chunk(const Pieces& P, long long e0, int n,
                                             const float* __restrict__ s_w, int ldw, int h0,
                                             float* tile, int lane, float (&pre)[kWarp]) {
#pragma unroll
  for (int j = 0; j < kWarp; ++j) pre[j] = 0.f;
  for (int i = 0; i < P.n; ++i) {
    const int d = P.dim[i];
    const float* base = P.ptr[i];
    const long long stride = P.stride[i];
    for (int k0 = 0; k0 < d; k0 += kWarp) {
      const int k = k0 + lane;
#pragma unroll
      for (int r = 0; r < kWarp; ++r)  // 32 independent loads in flight
        tile[r * kTile + lane] = (r < n && k < d) ? __ldg(base + (e0 + r) * stride + k) : 0.f;
      __syncwarp();
      const int kc = min(kWarp, d - k0);
      const float* wrow = s_w + (long long)(P.off[i] + k0) * ldw + h0;
      for (int kk = 0; kk < kc; ++kk, wrow += ldw) {
        const float x = tile[lane * kTile + kk];
#pragma unroll
        for (int j = 0; j < kWarp; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(wrow + j);
          pre[j] = fmaf(x, w.x, pre[j]);
          pre[j + 1] = fmaf(x, w.y, pre[j + 1]);
          pre[j + 2] = fmaf(x, w.z, pre[j + 2]);
          pre[j + 3] = fmaf(x, w.w, pre[j + 3]);
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// The transpose of hidden_chunk: with lane l holding dh[j], the cotangent of
// output unit h0+j of edge e0+l, adds sum_j dh[j] W[k, h0+j] into row e0+l,
// column k of the output pieces (``first``: store instead of add). 32 columns
// k at a time go through the warp's tile, which the warp then writes out as
// coalesced row pieces.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void backprop_chunk(const OutPieces& D, long long e0, int n,
                                               const float* __restrict__ s_w, int ldw, int h0,
                                               const float (&dh)[kWarp], float* tile, int lane,
                                               bool first) {
  for (int i = 0; i < D.n; ++i) {
    const int d = D.dim[i];
    float* base = D.ptr[i];
    const long long stride = D.stride[i];
    for (int k0 = 0; k0 < d; k0 += kWarp) {
      const int kc = min(kWarp, d - k0);
      const float* wrow = s_w + (long long)(D.off[i] + k0) * ldw + h0;
      for (int kk = 0; kk < kc; ++kk, wrow += ldw) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kWarp; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(wrow + j);
          s = fmaf(dh[j], w.x, s);
          s = fmaf(dh[j + 1], w.y, s);
          s = fmaf(dh[j + 2], w.z, s);
          s = fmaf(dh[j + 3], w.w, s);
        }
        tile[lane * kTile + kk] = s;
      }
      __syncwarp();
      if (lane < kc) {
        for (int r = 0; r < n; ++r) {
          float* o = base + (e0 + r) * stride + k0 + lane;
          *o = first ? tile[r * kTile + lane] : *o + tile[r * kTile + lane];
        }
      }
      __syncwarp();
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

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

int grid_for(long long work, int per_block, int max_blocks) {
  long long b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < max_blocks ? b : max_blocks);
}

int edge_blocks(long long n_edges) {
  long long b = (n_edges + kEdgeWarps - 1) / kEdgeWarps;
  return (int)(b < (1LL << 30) ? b : (1LL << 30));
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
// ``max_warps``; where not even one fits there, as many as fit in the card's
// opt-in maximum (the launcher then opts in with prepare_smem). 0 when none
// fits at all. *smem gets the bytes to launch with.
int fit_warps(size_t fixed, size_t per_warp, int max_warps, size_t* smem) {
  size_t limit = kSmemLimit;
  if (fixed + per_warp > limit) limit = smem_optin();
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
