// Allegro tensor-product layer kernels for Hopper (sm_90a), float32.
//
// The four kernels of one Allegro layer on the inference backend
// (`tp_kernel_backend="fused_infer"` without the mega kernels). Each replaces
// one Pallas TPU kernel of allegro_tpu/ops/fused_tp.py and computes the same
// function, in atom space instead of the TPU's rank-window space:
//
//   env_scatter   env[a, jU+u] = sum_{c(e)=a} sh[e,j] * wexp[e, irr(j)U+u]
//   gather_tp     out[e, kU+u] = sum_n c_n w[p_n,u] x[e, i_nU+u] env[c(e), j_nU+u]
//                 (optionally also ts[e, u] = out[e, u], the leading 0e block)
//   bwd_fused     dx[e, iU+u]  = sum_n c_n w[p_n,u] g[e, k_nU+u] env[c(e), j_nU+u]
//                 denv[a, jU+u] = sum_{c(e)=a} sum_n c_n w[p_n,u] x[e, i_nU+u] g[e, k_nU+u]
//                 (optionally with g[e, u] += gts[e, u], the cotangent of ts)
//   unweight_both dsh[e, j]   = sum_u t[c(e), jU+u] * wexp[e, irr(j)U+u]
//                 dwexp[e, rU+u] = sum_{j: irr(j)=r} t[c(e), jU+u] * sh[e, j]
//
// Layout (the JAX package's contract): per-edge arrays are row-major with
// the flat dim-major tensor track (column i*U+u is basis dim i, channel u);
// edges are sorted by center, and the CSR row pointer `row_ptr[a]` is the
// first edge of atom a. Padded edges carry the sentinel center n_atoms: they
// add nothing to any per-atom sum and read zeros from per-atom arrays.
// The sparse Clebsch-Gordan table (i, j, k, p, c) is a small device array
// (83 rows at the flagship width), copied into shared memory per block.
//
// Every sum runs in a fixed order (no atomics), so results are deterministic.
// Each kernel is launched on the caller's stream and allocates nothing; each
// entry point returns cudaGetLastError() after its launch.

#include "common.cu"

namespace {

// ---------------------------------------------------------------------------
// env_scatter
// Replaces allegro_tpu/ops/fused_tp.py:_env_scatter_kernel (env_scatter_call).
// Bound: device-memory reads of wexp [E, n_irr*U] (each element read once per
// basis dim of its irrep, from L1) and one write of env [N, d2*U]. Design:
// one block per atom walks its CSR segment; threads own output columns, so
// the segment sum is a register accumulation in edge order, with no atomics
// and no second pass.
// ---------------------------------------------------------------------------
__global__ void env_scatter_kernel(const float* __restrict__ sh, const float* __restrict__ wexp,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ dim_to_irr, int d2, int n_irr, int U,
                                   float* __restrict__ env) {
  const int a = blockIdx.x;
  const int start = row_ptr[a], end = row_ptr[a + 1];
  const int cols = d2 * U;
  const long long wstride = (long long)n_irr * U;
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    const int j = col / U, u = col - j * U;
    const int wcol = dim_to_irr[j] * U + u;
    float s = 0.f;
    for (int e = start; e < end; ++e) s += sh[(long long)e * d2 + j] * wexp[e * wstride + wcol];
    env[(long long)a * cols + col] = s;
  }
}

// ---------------------------------------------------------------------------
// gather_tp
// Replaces allegro_tpu/ops/fused_tp.py:_gather_tp_raw_kernel (gather_tp_raw_call).
// Bound: one read of x [E, d1*U] and one write of out [E, d3*U]; env rows are
// re-read by the ~25 edges of each atom and stay in L1/L2. Design: one warp
// per edge, lane = channel u (U = 32 is exactly one warp; other U loop in
// chunks of 32), so every load and store is a coalesced 128-byte row piece.
// The k-accumulators live in shared memory, one slot per lane. With ``ts``
// (the split scalar output), block k = 0 is also written to its own [E, U]
// array, so the latent MLP reads a contiguous [E, U] and its cotangent stays
// a separate [E, U] array instead of a zero-padded [E, d3*U] one.
// ---------------------------------------------------------------------------
__global__ void gather_tp_kernel(const float* __restrict__ x, const float* __restrict__ env,
                                 const float* __restrict__ w, const int* __restrict__ centers,
                                 const int* __restrict__ eidx, const float* __restrict__ ecoef,
                                 int n_entries, long long n_edges, int n_atoms, int d1, int d2,
                                 int d3, int U, float* __restrict__ out,
                                 float* __restrict__ ts) {
  extern __shared__ unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_idx + 4 * n_entries);
  float* s_acc = s_coef + n_entries;
  load_entries(eidx, ecoef, n_entries, s_idx, s_coef);
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  float* acc = s_acc + warp * d3 * kWarp;
  for (long long e = (long long)blockIdx.x * wpb + warp; e < n_edges;
       e += (long long)gridDim.x * wpb) {
    const int c = centers[e];
    const bool valid = c >= 0 && c < n_atoms;
    const float* xe = x + e * d1 * U;
    const float* ee = env + (valid ? (long long)c * d2 * U : 0);
    float* oe = out + e * d3 * U;
    float* tse = ts ? ts + e * U : nullptr;
    for (int u0 = 0; u0 < U; u0 += kWarp) {
      const int u = u0 + lane;
      const bool act = u < U;
      for (int k = 0; k < d3; ++k) acc[k * kWarp + lane] = 0.f;
      if (act && valid) {
        for (int n = 0; n < n_entries; ++n) {
          const int i = s_idx[4 * n], j = s_idx[4 * n + 1], k = s_idx[4 * n + 2],
                    p = s_idx[4 * n + 3];
          acc[k * kWarp + lane] += s_coef[n] * w[p * U + u] * xe[i * U + u] * ee[j * U + u];
        }
      }
      if (act) {
        for (int k = 0; k < d3; ++k) oe[k * U + u] = acc[k * kWarp + lane];
        if (tse) tse[u] = acc[lane];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_fused
// Replaces allegro_tpu/ops/fused_tp.py:_bwd_fused_raw_kernel (bwd_fused_raw_call),
// without the weight gradient (inference scope, as on the TPU).
// Bound: one read each of x [E, d1*U] and g [E, d3*U], one write of dx
// [E, d1*U]. Design: one block per atom segment, so dx and denv come from
// one pass over the edges, as on the TPU. Each warp takes every W-th edge of
// the segment (lane = channel), writes dx[e] and accumulates its share of
// denv in its own shared-memory row; the rows are summed across warps in a
// fixed order, so denv is deterministic without atomics. Block n_atoms
// zeroes dx on the sentinel (padded) edges, which belong to no segment.
// ``gts`` (the cotangent of the split scalar output) is added to g's block
// k = 0 as it is read, as the TPU kernel folds it in VMEM; the kernel is
// instantiated with and without it, so the entry loop without it carries no
// extra select.
// ---------------------------------------------------------------------------
template <bool kGts>
__global__ void bwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                 const float* __restrict__ gts, const float* __restrict__ env, const float* __restrict__ w,
                                 const int* __restrict__ row_ptr, const int* __restrict__ eidx,
                                 const float* __restrict__ ecoef, int n_entries,
                                 long long n_edges, int n_atoms, int d1, int d2, int d3, int U,
                                 float* __restrict__ dx, float* __restrict__ denv) {
  extern __shared__ unsigned char smem[];
  const int a = blockIdx.x;
  const long long d1U = (long long)d1 * U;
  if (a == n_atoms) {
    for (long long t = (long long)row_ptr[n_atoms] * d1U + threadIdx.x; t < n_edges * d1U;
         t += blockDim.x)
      dx[t] = 0.f;
    return;
  }
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_idx + 4 * n_entries);
  const int wpb = blockDim.x / kWarp;
  const int d2U = d2 * U;
  float* s_den = s_coef + n_entries;          // [wpb][d2*U]
  float* s_dx = s_den + wpb * d2U;            // [wpb][d1][32]
  load_entries(eidx, ecoef, n_entries, s_idx, s_coef);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float* pden = s_den + warp * d2U;
  float* pdx = s_dx + warp * d1 * kWarp;
  for (int col = lane; col < d2U; col += kWarp) pden[col] = 0.f;
  __syncthreads();
  const int start = row_ptr[a], end = row_ptr[a + 1];
  const float* ea = env + (long long)a * d2U;
  for (int e = start + warp; e < end; e += wpb) {
    const float* xe = x + (long long)e * d1U;
    const float* ge = g + (long long)e * d3 * U;
    float* dxe = dx + (long long)e * d1U;
    for (int u0 = 0; u0 < U; u0 += kWarp) {
      const int u = u0 + lane;
      if (u >= U) continue;
      const float g0 = kGts ? ge[u] + gts[(long long)e * U + u] : 0.f;
      for (int i = 0; i < d1; ++i) pdx[i * kWarp + lane] = 0.f;
      for (int n = 0; n < n_entries; ++n) {
        const int i = s_idx[4 * n], j = s_idx[4 * n + 1], k = s_idx[4 * n + 2],
                  p = s_idx[4 * n + 3];
        const float gk = (kGts && k == 0) ? g0 : ge[k * U + u];
        const float cwg = s_coef[n] * w[p * U + u] * gk;
        pdx[i * kWarp + lane] += cwg * ea[j * U + u];
        pden[j * U + u] += cwg * xe[i * U + u];
      }
      for (int i = 0; i < d1; ++i) dxe[i * U + u] = pdx[i * kWarp + lane];
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
// unweight_both
// Replaces allegro_tpu/ops/fused_tp.py:_unweight_both_raw_kernel
// (unweight_both_raw_call): the two transposes of env_scatter in one pass.
// Bound: one read of wexp and one write of dwexp [E, n_irr*U]; t rows are
// shared by the edges of an atom (L1/L2). Design: one warp per edge, lane =
// channel; dsh is a warp shuffle reduction over u, dwexp is elementwise.
// ---------------------------------------------------------------------------
__global__ void unweight_both_kernel(const float* __restrict__ t, const float* __restrict__ sh,
                                     const float* __restrict__ wexp,
                                     const int* __restrict__ centers,
                                     const int* __restrict__ dim_to_irr, long long n_edges,
                                     int n_atoms, int d2, int n_irr, int U,
                                     float* __restrict__ dsh, float* __restrict__ dwexp) {
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
    const float* we = wexp + e * nU;
    const float* se = sh + e * d2;
    for (int j = 0; j < d2; ++j) {
      const int r = s_irr[j];
      float s = 0.f;
      if (valid)
        for (int u = lane; u < U; u += kWarp) s += te[j * U + u] * we[r * U + u];
      s = warp_sum(s);
      if (lane == 0) dsh[e * d2 + j] = s;
    }
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

const char* atpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int atpt_env_scatter(const float* sh, const float* wexp, const int* row_ptr,
                     const int* dim_to_irr, int n_atoms, int d2, int n_irr, int U, float* env,
                     void* stream) {
  int cols = d2 * U;
  int threads = ((cols + kWarp - 1) / kWarp) * kWarp;
  if (threads > 256) threads = 256;
  env_scatter_kernel<<<n_atoms, threads, 0, (cudaStream_t)stream>>>(sh, wexp, row_ptr,
                                                                     dim_to_irr, d2, n_irr, U,
                                                                     env);
  return (int)cudaGetLastError();
}

int atpt_gather_tp(const float* x, const float* env, const float* w, const int* centers,
                   const int* eidx, const float* ecoef, int n_entries, long long n_edges,
                   int n_atoms, int d1, int d2, int d3, int U, float* out, float* ts,
                   void* stream) {
  size_t smem = (size_t)n_entries * 5 * sizeof(float) + (size_t)kEdgeWarps * d3 * kWarp * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  gather_tp_kernel<<<edge_blocks(n_edges), kEdgeWarps * kWarp, smem, (cudaStream_t)stream>>>(
      x, env, w, centers, eidx, ecoef, n_entries, n_edges, n_atoms, d1, d2, d3, U, out, ts);
  return (int)cudaGetLastError();
}

int atpt_bwd_fused(const float* x, const float* g, const float* gts, const float* env,
                   const float* w,
                   const int* row_ptr, const int* eidx, const float* ecoef, int n_entries,
                   long long n_edges, int n_atoms, int d1, int d2, int d3, int U, float* dx,
                   float* denv, void* stream) {
  size_t fixed = (size_t)n_entries * 5 * sizeof(float);
  size_t per_warp = ((size_t)d2 * U + (size_t)d1 * kWarp) * sizeof(float);
  if (fixed + per_warp > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  int warps = (int)((kSmemLimit - fixed) / per_warp);
  if (warps > kSegmentWarps) warps = kSegmentWarps;
  size_t smem = fixed + warps * per_warp;
  if (gts)
    bwd_fused_kernel<true><<<n_atoms + 1, warps * kWarp, smem, (cudaStream_t)stream>>>(
        x, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, n_edges, n_atoms, d1, d2, d3, U, dx,
        denv);
  else
    bwd_fused_kernel<false><<<n_atoms + 1, warps * kWarp, smem, (cudaStream_t)stream>>>(
        x, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, n_edges, n_atoms, d1, d2, d3, U, dx,
        denv);
  return (int)cudaGetLastError();
}

int atpt_unweight_both(const float* t, const float* sh, const float* wexp, const int* centers,
                       const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr,
                       int U, float* dsh, float* dwexp, void* stream) {
  size_t smem = (size_t)d2 * sizeof(int);
  unweight_both_kernel<<<edge_blocks(n_edges), kEdgeWarps * kWarp, smem,
                         (cudaStream_t)stream>>>(t, sh, wexp, centers, dim_to_irr, n_edges,
                                                 n_atoms, d2, n_irr, U, dsh, dwexp);
  return (int)cudaGetLastError();
}

}  // extern "C"
