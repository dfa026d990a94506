// Center gather / scatter and the fused energy readout for Hopper (sm_90a), float32.
//
// Four kernels of the inference force call (`tp_kernel_backend="fused_infer"`
// with precomputed statics). Each replaces one Pallas TPU kernel of
// allegro_tpu/ops/fused_tp.py and computes the same function in atom space:
//
//   center_gather  out[e, c] = a[idx[e], c]           (0 where idx[e] >= n_atoms)
//   center_sum     s[a, c]   = sum_{k in [row_ptr[a], row_ptr[a+1])} v[perm[k], c]
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
// Every per-atom sum runs in edge order within its CSR segment (no atomics),
// so results are deterministic. Each kernel runs on the caller's stream and
// allocates nothing; each entry point returns cudaGetLastError().

#include "common.cu"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// center_gather
// Replaces allegro_tpu/ops/fused_tp.py:_center_broadcast_kernel
// (center_broadcast_call). Bound: the write of out [E, C] and the reads of
// idx; the rows of a [n_atoms, C] stay in L1/L2. The TPU needed a one-hot
// MXU product (with a bf16 split to stay exact); here the gather is a plain
// indexed load, exact by construction. One thread per output element.
// ---------------------------------------------------------------------------
__global__ void center_gather_kernel(const float* __restrict__ a, const int* __restrict__ idx,
                                     long long n_edges, int n_atoms, int C,
                                     float* __restrict__ out) {
  const long long total = n_edges * C;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long e = t / C;
    const int c = (int)(t - e * C);
    const int i = idx[e];
    out[t] = (i >= 0 && i < n_atoms) ? a[(long long)i * C + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// center_sum
// Replaces allegro_tpu/ops/fused_tp.py:_center_sum_kernel (center_sum_call).
// Bound: one read of v [E, C] (through perm on the neighbor side). The TPU
// summed one-hot window products into two rank-window partials; here a CSR
// segment sum: one thread per (atom, column) adds its segment in edge order,
// a register accumulation with no atomics and no second pass.
// ---------------------------------------------------------------------------
__global__ void center_sum_kernel(const float* __restrict__ v, const int* __restrict__ row_ptr,
                                  const int* __restrict__ perm, int n_atoms, int C,
                                  float* __restrict__ out) {
  const long long total = (long long)n_atoms * C;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int a = (int)(t / C);
    const int c = (int)(t - (long long)a * C);
    float s = 0.f;
    const int end = row_ptr[a + 1];
    for (int k = row_ptr[a]; k < end; ++k) {
      const long long r = perm ? perm[k] : k;
      s += v[r * C + c];
    }
    out[t] = s;
  }
}

// W0 [K, H] → shared [K][Hp] (zero-padded columns), w1 [H] → shared [Hp]
// (zero-padded; without a hidden layer w1 is the unit vector e_0).
__device__ __forceinline__ void load_mlp(const float* __restrict__ w0,
                                         const float* __restrict__ w1, int K, int H, int Hp,
                                         float* s_w0, float* s_w1) {
  for (int t = threadIdx.x; t < K * Hp; t += blockDim.x) {
    const int k = t / Hp, h = t - k * Hp;
    s_w0[t] = h < H ? w0[(long long)k * H + h] : 0.f;
  }
  for (int h = threadIdx.x; h < Hp; h += blockDim.x)
    s_w1[h] = w1 ? (h < H ? w1[h] : 0.f) : (h == 0 ? 1.f : 0.f);
}

// Shared memory of the readout kernels: W0, w1 and one tile per warp.
size_t readout_smem(int K, int Hp, int warps) {
  return ((size_t)K * Hp + Hp + (size_t)warps * kWarp * kTile) * sizeof(float);
}

// ---------------------------------------------------------------------------
// readout_sum
// Replaces allegro_tpu/ops/fused_tp.py:_readout_sum_kernel (readout_sum_call).
// Bound: the one read of the pieces [E, K] (79.5 MB at the flagship) and
// K*H FMAs per edge (6,144 at K = 192, H = 32); the hidden activation and the
// per-edge energy never reach device memory, as on the TPU. Design: W0 and
// w1 in shared memory once per block; one warp per atom, lane = edge of the
// atom's segment (32 at a time, through hidden_chunk's tile), each thread
// keeping its edge's 32 hidden pre-activations in registers, so each
// shared-memory float4 read feeds 4 FMAs of the lane. The per-edge energies
// are then added in edge order by warp shuffles. Exact FP32 FMAs: no TF32,
// no tensor cores (precision "highest").
// ---------------------------------------------------------------------------
template <bool kSilu>
__global__ void __launch_bounds__(kThreads, 2) readout_sum_kernel(Pieces P, const float* __restrict__ w0,
                                   const float* __restrict__ w1, const int* __restrict__ row_ptr,
                                   int n_atoms, int K, int H, int Hp,
                                   float* __restrict__ energy) {
  extern __shared__ float smem[];
  float* s_w0 = smem;
  float* s_w1 = s_w0 + (long long)K * Hp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  float* tile = s_w1 + Hp + warp * kWarp * kTile;
  load_mlp(w0, w1, K, H, Hp, s_w0, s_w1);
  __syncthreads();
  float pre[kWarp];
  for (int a = blockIdx.x * wpb + warp; a < n_atoms; a += gridDim.x * wpb) {
    const int start = row_ptr[a], end = row_ptr[a + 1];
    float total = 0.f;
    for (int e0 = start; e0 < end; e0 += kWarp) {
      const int n = min(kWarp, end - e0);
      float en = 0.f;
      for (int h0 = 0; h0 < Hp; h0 += kWarp) {
        hidden_chunk(P, e0, n, s_w0, Hp, h0, tile, lane, pre);
#pragma unroll
        for (int j = 0; j < kWarp; ++j)
          en = fmaf(kSilu ? silu(pre[j]) : pre[j], s_w1[h0 + j], en);
      }
      for (int l = 0; l < n; ++l) total += __shfl_sync(0xffffffffu, en, l);
    }
    if (lane == 0) energy[a] = total;
  }
}

// ---------------------------------------------------------------------------
// readout_bwd
// Replaces allegro_tpu/ops/fused_tp.py:_readout_bwd_kernel (readout_bwd_call).
// Bound: the read of the pieces and the write of their cotangents [E, K]
// (79.5 MB each way at the flagship) and 2*K*H FMAs per edge. Design: one
// warp per tile of 32 edges, lane = edge. Each lane gathers the per-atom
// energy cotangent y[c(e)] itself (no separate gather launch, as in the TPU
// kernel), recomputes the pre-activation of a chunk of 32 hidden units in
// registers (hidden_chunk), forms dh = y * w1 * silu'(pre) there, and
// computes dp[e, k] = sum_h dh[h] W0[k, h] for 32 columns k at a time into
// the warp's tile, which the warp then writes out as coalesced row pieces. A
// second chunk of hidden units (H > 32) adds into those rows. Sentinel edges
// get zero rows.
// ---------------------------------------------------------------------------
template <bool kSilu>
__global__ void __launch_bounds__(kThreads, 2) readout_bwd_kernel(Pieces P, OutPieces D, const float* __restrict__ w0,
                                   const float* __restrict__ w1, const float* __restrict__ y,
                                   const int* __restrict__ centers, long long n_edges,
                                   int n_atoms, int K, int H, int Hp) {
  extern __shared__ float smem[];
  float* s_w0 = smem;
  float* s_w1 = s_w0 + (long long)K * Hp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  float* tile = s_w1 + Hp + warp * kWarp * kTile;
  load_mlp(w0, w1, K, H, Hp, s_w0, s_w1);
  __syncthreads();
  float dh[kWarp];
  for (long long e0 = ((long long)blockIdx.x * wpb + warp) * kWarp; e0 < n_edges;
       e0 += (long long)gridDim.x * wpb * kWarp) {
    const int n = (int)min((long long)kWarp, n_edges - e0);
    const int c = lane < n ? centers[e0 + lane] : n_atoms;
    const bool valid = c >= 0 && c < n_atoms;
    const float ye = valid ? y[c] : 0.f;
    for (int h0 = 0; h0 < Hp; h0 += kWarp) {
      if (kSilu) {
        hidden_chunk(P, e0, n, s_w0, Hp, h0, tile, lane, dh);
#pragma unroll
        for (int j = 0; j < kWarp; ++j)
          dh[j] = valid ? ye * s_w1[h0 + j] * silu_grad(dh[j]) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < kWarp; ++j) dh[j] = ye * s_w1[h0 + j];
      }
      backprop_chunk(D, e0, n, s_w0, Hp, h0, dh, tile, lane, h0 == 0);
    }
  }
}

}  // namespace

extern "C" {

int atpt_center_gather(const float* a, const int* idx, long long n_edges, int n_atoms, int C,
                       float* out, void* stream) {
  const int blocks = grid_for(n_edges * C, kThreads, 8 * sm_count());
  center_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, idx, n_edges, n_atoms,
                                                                      C, out);
  return (int)cudaGetLastError();
}

int atpt_center_sum(const float* v, const int* row_ptr, const int* perm, int n_atoms, int C,
                    float* out, void* stream) {
  const int blocks = grid_for((long long)n_atoms * C, kThreads, 8 * sm_count());
  center_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(v, row_ptr, perm, n_atoms, C,
                                                                   out);
  return (int)cudaGetLastError();
}

int atpt_readout_sum(const float* const* piece_ptrs, const long long* piece_strides,
                     const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                     const int* row_ptr, int n_atoms, int H, float* energy, void* stream) {
  Pieces P;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0) return (int)cudaErrorInvalidValue;
  P.n = n_pieces;
  const int Hp = (H + kWarp - 1) / kWarp * kWarp;
  const size_t smem = readout_smem(K, Hp, kThreads / kWarp);
  const int blocks = grid_for(n_atoms, kThreads / kWarp, 4 * sm_count());
  if (w1) {
    cudaError_t err = set_smem(readout_sum_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    readout_sum_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        P, w0, w1, row_ptr, n_atoms, K, H, Hp, energy);
  } else {
    cudaError_t err = set_smem(readout_sum_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    readout_sum_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        P, w0, w1, row_ptr, n_atoms, K, H, Hp, energy);
  }
  return (int)cudaGetLastError();
}

int atpt_readout_bwd(const float* const* piece_ptrs, const long long* piece_strides,
                     float* const* dpiece_ptrs, const long long* dpiece_strides,
                     const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                     const float* y, const int* centers, long long n_edges, int n_atoms, int H,
                     void* stream) {
  Pieces P;
  OutPieces D;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0) return (int)cudaErrorInvalidValue;
  P.n = D.n = n_pieces;
  for (int i = 0; i < n_pieces; ++i) {
    D.ptr[i] = dpiece_ptrs[i];
    D.stride[i] = dpiece_strides[i];
    D.dim[i] = P.dim[i];
    D.off[i] = P.off[i];
  }
  const int Hp = (H + kWarp - 1) / kWarp * kWarp;
  const size_t smem = readout_smem(K, Hp, kThreads / kWarp);
  const int blocks = grid_for(n_edges, kThreads, 4 * sm_count());
  if (w1) {
    cudaError_t err = set_smem(readout_bwd_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    readout_bwd_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        P, D, w0, w1, y, centers, n_edges, n_atoms, K, H, Hp);
  } else {
    cudaError_t err = set_smem(readout_bwd_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    readout_bwd_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        P, D, w0, w1, y, centers, n_edges, n_atoms, K, H, Hp);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
