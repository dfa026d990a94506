// Allegro tensor-product kernels of the trainable backend for Hopper
// (sm_90a), float32.
//
// The trainable backend (`tp_kernel_backend="fused"`) runs env_scatter
// (csrc/fused_tp.cu) and gather_tp (csrc/sparse_tp.cu) forward, and its
// derivatives are the closed family of allegro_tpu/ops/fused_primitives.py:
// every transpose is again one of the family with permuted roles, so the
// double backward of force training stays on the kernels. This file holds
// three of the members; gather_dw, the weight transpose, walks compiled CG
// paths in csrc/sparse_tp.cu. Each replaces one Pallas TPU kernel of
// allegro_tpu/ops/fused_tp.py and computes its function in atom space
// instead of the TPU's rank windows:
//
//   tp_scatter   denv[a, jU+u] = sum_{c(e)=a} sum_n c_n w[p_n,u] x[e, i_nU+u] g[e, k_nU+u]
//   unweight_sh  dsh[e, j]     = sum_u t[c(e), jU+u] wexp[e, irr(j)U+u]
//   unweight_w   dwexp[e, rU+u] = sum_{j: irr(j)=r} t[c(e), jU+u] sh[e, j]
//
// The entry table (i, j, k, p, c) is whatever the caller passes: the layer's
// own, or its role swap (i, j, k) -> (k, j, i) for the x-transposes, so the
// dims (d1 of x, d3 of g) may come in either order. Layout, sentinels and the
// CSR row pointer as in fused_tp.cu: padded edges carry the center n_atoms,
// add nothing to a per-atom or per-path sum and read zeros from per-atom
// arrays. Every sum runs in a fixed order (no atomics), so two identical
// calls give identical results. Each kernel runs on the caller's stream and
// allocates nothing; each entry point returns cudaGetLastError().

#include "common.cu"

namespace {

// ---------------------------------------------------------------------------
// tp_scatter
// Replaces allegro_tpu/ops/fused_tp.py:_tp_scatter_kernel (tp_scatter_call).
// Bound: one read each of x [E, d1*U] and g [E, d3*U] (2 x 116 MB at layer 0
// of the 100k-edge training batch, ~71 us at 3.35 TB/s). Design: the denv half
// of bwd_fused. One block per atom segment; each warp takes every W-th edge of
// the segment (lane = channel) and accumulates into its own shared-memory row
// of denv; the rows are summed across warps in a fixed order, so the result is
// deterministic without atomics. Sentinel edges lie after row_ptr[n_atoms] and
// belong to no segment.
// ---------------------------------------------------------------------------
__global__ void tp_scatter_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                  const float* __restrict__ w, const int* __restrict__ row_ptr,
                                  const int* __restrict__ eidx, const float* __restrict__ ecoef,
                                  int n_entries, int d1, int d2, int d3, int U,
                                  float* __restrict__ denv) {
  extern __shared__ unsigned char smem[];
  const int a = blockIdx.x;
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_idx + 4 * n_entries);
  const int wpb = blockDim.x / kWarp;
  const int d2U = d2 * U;
  float* s_den = s_coef + n_entries;  // [wpb][d2*U]
  load_entries(eidx, ecoef, n_entries, s_idx, s_coef);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float* pden = s_den + warp * d2U;
  for (int col = lane; col < d2U; col += kWarp) pden[col] = 0.f;
  __syncthreads();
  const int start = row_ptr[a], end = row_ptr[a + 1];
  for (int e = start + warp; e < end; e += wpb) {
    const float* xe = x + (long long)e * d1 * U;
    const float* ge = g + (long long)e * d3 * U;
    for (int u = lane; u < U; u += kWarp) {
      for (int n = 0; n < n_entries; ++n) {
        const int i = s_idx[4 * n], j = s_idx[4 * n + 1], k = s_idx[4 * n + 2],
                  p = s_idx[4 * n + 3];
        pden[j * U + u] += s_coef[n] * w[p * U + u] * xe[i * U + u] * ge[k * U + u];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d2U; col += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < wpb; ++q) s += s_den[q * d2U + col];
    denv[(long long)a * d2U + col] = s;
  }
}

// ---------------------------------------------------------------------------
// unweight_sh
// Replaces allegro_tpu/ops/fused_tp.py:_gather_unweight_sh_kernel
// (gather_unweight_sh_call): the sh-transpose of env_scatter.
// Bound: one read of wexp [E, n_irr*U] (39 MB at the training batch, ~12 us);
// t rows are shared by the edges of an atom (L1/L2). Design: the dsh half of
// unweight_both as its own launch: one warp per edge, lane = channel, each
// dsh[e, j] a warp shuffle reduction over u.
// ---------------------------------------------------------------------------
__global__ void unweight_sh_kernel(const float* __restrict__ t, const float* __restrict__ wexp,
                                   const int* __restrict__ centers,
                                   const int* __restrict__ dim_to_irr, long long n_edges,
                                   int n_atoms, int d2, int n_irr, int U,
                                   float* __restrict__ dsh) {
  extern __shared__ unsigned char smem[];
  int* s_irr = reinterpret_cast<int*>(smem);
  for (int q = threadIdx.x; q < d2; q += blockDim.x) s_irr[q] = dim_to_irr[q];
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  for (long long e = (long long)blockIdx.x * wpb + warp; e < n_edges;
       e += (long long)gridDim.x * wpb) {
    const int c = centers[e];
    const bool valid = c >= 0 && c < n_atoms;
    const float* te = t + (valid ? (long long)c * d2 * U : 0);
    const float* we = wexp + e * n_irr * U;
    for (int j = 0; j < d2; ++j) {
      const int r = s_irr[j];
      float s = 0.f;
      if (valid)
        for (int u = lane; u < U; u += kWarp) s += te[j * U + u] * we[r * U + u];
      s = warp_sum(s);
      if (lane == 0) dsh[e * d2 + j] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// unweight_w
// Replaces allegro_tpu/ops/fused_tp.py:_gather_unweight_w_kernel
// (gather_unweight_w_call): the wexp-transpose of env_scatter.
// Bound: one write of dwexp [E, n_irr*U] (39 MB, ~12 us); t rows from L1/L2.
// Design: the dwexp half of unweight_both as its own launch: one warp per
// edge, lane = channel, each output element a sum over the dims of its irrep.
// ---------------------------------------------------------------------------
__global__ void unweight_w_kernel(const float* __restrict__ t, const float* __restrict__ sh,
                                  const int* __restrict__ centers,
                                  const int* __restrict__ dim_to_irr, long long n_edges,
                                  int n_atoms, int d2, int n_irr, int U,
                                  float* __restrict__ dwexp) {
  extern __shared__ unsigned char smem[];
  int* s_irr = reinterpret_cast<int*>(smem);
  for (int q = threadIdx.x; q < d2; q += blockDim.x) s_irr[q] = dim_to_irr[q];
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  const long long nU = (long long)n_irr * U;
  for (long long e = (long long)blockIdx.x * wpb + warp; e < n_edges;
       e += (long long)gridDim.x * wpb) {
    const int c = centers[e];
    const bool valid = c >= 0 && c < n_atoms;
    const float* te = t + (valid ? (long long)c * d2 * U : 0);
    const float* se = sh + e * d2;
    for (int u = lane; u < U; u += kWarp) {
      for (int r = 0; r < n_irr; ++r) {
        float s = 0.f;
        if (valid)
          for (int j = 0; j < d2; ++j)
            if (s_irr[j] == r) s += te[j * U + u] * se[j];
        dwexp[e * nU + r * U + u] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

int atpt_tp_scatter(const float* x, const float* g, const float* w, const int* row_ptr,
                    const int* eidx, const float* ecoef, int n_entries, int n_atoms, int d1,
                    int d2, int d3, int U, float* denv, void* stream) {
  size_t fixed = (size_t)n_entries * 5 * sizeof(float);
  size_t per_warp = (size_t)d2 * U * sizeof(float);
  size_t smem = 0;
  const int warps = fit_warps(fixed, per_warp, kSegmentWarps, &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = prepare_smem(tp_scatter_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tp_scatter_kernel<<<n_atoms, warps * kWarp, smem, (cudaStream_t)stream>>>(
      x, g, w, row_ptr, eidx, ecoef, n_entries, d1, d2, d3, U, denv);
  return (int)cudaGetLastError();
}

int atpt_unweight_sh(const float* t, const float* wexp, const int* centers,
                     const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr,
                     int U, float* dsh, void* stream) {
  unweight_sh_kernel<<<edge_blocks(n_edges), kEdgeWarps * kWarp, (size_t)d2 * sizeof(int),
                       (cudaStream_t)stream>>>(t, wexp, centers, dim_to_irr, n_edges, n_atoms,
                                               d2, n_irr, U, dsh);
  return (int)cudaGetLastError();
}

int atpt_unweight_w(const float* t, const float* sh, const int* centers, const int* dim_to_irr,
                    long long n_edges, int n_atoms, int d2, int n_irr, int U, float* dwexp,
                    void* stream) {
  unweight_w_kernel<<<edge_blocks(n_edges), kEdgeWarps * kWarp, (size_t)d2 * sizeof(int),
                      (cudaStream_t)stream>>>(t, sh, centers, dim_to_irr, n_edges, n_atoms, d2,
                                              n_irr, U, dwexp);
  return (int)cudaGetLastError();
}

}  // extern "C"
