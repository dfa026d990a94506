// Allegro tensor-product layer kernels for Hopper (sm_90a), float32.
//
// bwd_fused with its weight gradient (TPU kernel 18, on no user path), the
// dispatch of atpt_bwd_fused, and two utility entry points: the error string
// of a launcher's code, and an empty kernel whose launch time is the floor
// under every kernel's time. The layer's other kernels live elsewhere:
// gather_tp, and bwd_fused without its weight gradient, walk compiled CG
// paths in csrc/sparse_tp.cu beside the `pallas` backend's per-edge product,
// which differs from gather_tp only in where its second input's row comes
// from; env_scatter and its transposes (unweight_both among them) run on
// staged rows in csrc/train_tp.cu. bwd_fused replaces a Pallas TPU kernel of
// allegro_tpu/ops/fused_tp.py and computes the same function, in atom space
// instead of the TPU's rank-window space:
//
//   bwd_fused     dx[e, iU+u]  = sum_n c_n w[p_n,u] g[e, k_nU+u] env[c(e), j_nU+u]
//                 denv[a, jU+u] = sum_{c(e)=a} sum_n c_n w[p_n,u] x[e, i_nU+u] g[e, k_nU+u]
//                 (the backward of gather_tp; optionally with g[e, u] += gts[e, u],
//                 the cotangent of gather_tp's split output ts). Here with the
//                 weight gradient dw[p, u] = sum_e sum_{n: p_n=p} c_n x[e, i_nU+u]
//                 env[c(e), j_nU+u] g[e, k_nU+u] (bwd_fused_dw_kernel); without
//                 it, atpt_bwd_fused launches csrc/sparse_tp.cu's path walk
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
// A launcher that needs more than 48 KB of shared memory opts in, up to the
// card's maximum, and refuses only what does not fit there.
// Each kernel is launched on the caller's stream and allocates nothing; each
// entry point returns cudaGetLastError().

#include "common.cu"

namespace {

// An empty kernel: its time under chip_smoke.py's median_ms is the launch
// floor, the least time any kernel of the port can take there.
__global__ void noop_kernel() {}

// ---------------------------------------------------------------------------
// bwd_fused with the weight gradient
// Replaces allegro_tpu/ops/fused_tp.py:_bwd_fused_kernel (bwd_fused_call
// with_dw=True), whose two env windows are one env array here; without dw,
// bwd_fused is csrc/sparse_tp.cu's path walk. On no user path, in JAX
// either: the trainable backend computes the same three cotangents with
// gather_tp, tp_scatter and gather_dw.
// Bound: one read each of x [E, d1*U] and g [E, d3*U], one write of dx
// [E, d1*U]. Design: the run-time CG entry loop, one block per atom segment
// of a grid striding over the atoms (a fixed number of blocks, from n_atoms
// alone), so dx and denv come from one pass over the edges, as on the TPU.
// Each warp takes every W-th edge of the segment (lane = channel), writes
// dx[e] and accumulates its share of denv in its own shared-memory row; the
// rows are summed across warps in a fixed order, so denv is deterministic
// without atomics. The atom n_atoms stands for the sentinel (padded) edges,
// which belong to no segment: its block zeroes their dx. ``gts`` (the
// cotangent of the split scalar output) is added to g's block k = 0 as it
// is read, as the TPU kernel folds it in VMEM. Each lane also keeps its
// channel's P path sums dw[p, u] += c x_i env_j g_k over all the edges its
// warp visits, from the x, env and g values the entry already loaded; at
// the end the warps of a block add theirs in warp order into the block's
// row of ``partial`` [blocks, P, U], which partials_reduce_kernel adds in
// block order. No float atomics: two identical calls give identical bits.
// ---------------------------------------------------------------------------
template <bool kGts>
__global__ void bwd_fused_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                    const float* __restrict__ gts, const float* __restrict__ env,
                                    const float* __restrict__ w, const int* __restrict__ row_ptr,
                                    const int* __restrict__ eidx, const float* __restrict__ ecoef,
                                    int n_entries, long long n_edges, int n_atoms, int d1, int d2,
                                    int d3, int U, int P, float* __restrict__ dx,
                                    float* __restrict__ denv, float* __restrict__ partial) {
  extern __shared__ unsigned char smem[];
  const long long d1U = (long long)d1 * U;
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_idx + 4 * n_entries);
  const int wpb = blockDim.x / kWarp;
  const int d2U = d2 * U;
  const int PU = P * U;
  float* s_den = s_coef + n_entries;          // [wpb][d2*U]
  float* s_dx = s_den + wpb * d2U;            // [wpb][d1][32]
  float* s_dw = s_dx + wpb * d1 * kWarp;      // [wpb][P*U]
  load_entries(eidx, ecoef, n_entries, s_idx, s_coef);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float* pden = s_den + warp * d2U;
  float* pdx = s_dx + warp * d1 * kWarp;
  float* pdw = s_dw + warp * PU;
  for (int q = lane; q < PU; q += kWarp) pdw[q] = 0.f;
  __syncthreads();
  for (int a = blockIdx.x; a <= n_atoms; a += gridDim.x) {
    if (a == n_atoms) {
      for (long long t = (long long)row_ptr[n_atoms] * d1U + threadIdx.x; t < n_edges * d1U;
           t += blockDim.x)
        dx[t] = 0.f;
      continue;
    }
    for (int col = lane; col < d2U; col += kWarp) pden[col] = 0.f;
    __syncwarp();
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
          const float xi = xe[i * U + u], ej = ea[j * U + u];
          pdx[i * kWarp + lane] += cwg * ej;
          pden[j * U + u] += cwg * xi;
          pdw[p * U + u] += s_coef[n] * gk * (xi * ej);
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
    __syncthreads();
  }
  __syncthreads();
  for (int q = threadIdx.x; q < PU; q += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < wpb; ++v) s += s_dw[v * PU + q];
    partial[(long long)blockIdx.x * PU + q] = s;
  }
}

template <bool kGts>
int launch_bwd_fused_dw(const float* x, const float* g, const float* gts, const float* env,
                        const float* w, const int* row_ptr, const int* eidx, const float* ecoef,
                        int n_entries, long long n_edges, int n_atoms, int d1, int d2, int d3,
                        int U, int P, int n_blocks, float* dx, float* denv, float* partial,
                        float* dw, cudaStream_t stream) {
  const size_t fixed = (size_t)n_entries * 5 * sizeof(float);
  const size_t per_warp = ((size_t)d2 * U + (size_t)d1 * kWarp + (size_t)P * U) * sizeof(float);
  size_t smem = 0;
  const int warps = fit_warps(fixed, per_warp, kSegmentWarps, smem_optin(), &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = prepare_smem(bwd_fused_dw_kernel<kGts>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_fused_dw_kernel<kGts><<<n_blocks, warps * kWarp, smem, stream>>>(
      x, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, n_edges, n_atoms, d1, d2, d3, U, P, dx,
      denv, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PU = P * U;
  partials_reduce_kernel<<<(PU + 255) / 256, 256, 0, stream>>>(partial, n_blocks, PU, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// csrc/sparse_tp.cu: bwd_fused without the weight gradient, on the path tables
int launch_bwd_fused_walk(const void* x, const void* g, const float* gts, const float* env,
                          const float* w, const int* row_ptr, const int* desc_dx,
                          const float* scale_dx, int rows_dx, const int* eidx_dx,
                          const float* ecoef_dx, const int* desc_den, const float* scale_den,
                          int rows_den, const int* eidx_den, const float* ecoef_den,
                          long long n_edges, int n_atoms, int d1, int d2, int d3, int U, int P,
                          void* dx, float* denv, int bf16, cudaStream_t stream);

extern "C" {

const char* atpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One launch of one block of one thread that does nothing.
int atpt_noop(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Without the weight gradient (dw and partial null): desc_dx ... ecoef_dx,
// the path table of the role-swapped entry table, and desc_den ...
// ecoef_den, that of the layer's table with roles (0, 2, 1), both in walk
// order (gen_cg_blocks.path_table(by_output=True)); eidx, ecoef and
// n_entries are not read. With it: dw [P, U], scratch partial [n_blocks, P,
// U] and the run-time entry table eidx [n_entries, 4], ecoef [n_entries];
// n_blocks is chosen by the caller from n_atoms alone (so the order of the
// sums does not depend on the card), and the path tables are not read.
// bf16: bit 0, x, g and dx are the bf16 track (__nv_bfloat16; without dw
// only), otherwise float; bit 3 (without dw only), gts is __nv_bfloat16 (a
// bfloat16 model's); env, denv and dw are float either way.
int atpt_bwd_fused(const void* x_, const void* g_, const float* gts, const float* env,
                   const float* w, const int* row_ptr, const int* eidx, const float* ecoef,
                   int n_entries, const int* desc_dx, const float* scale_dx, int rows_dx,
                   const int* eidx_dx, const float* ecoef_dx, const int* desc_den,
                   const float* scale_den, int rows_den, const int* eidx_den,
                   const float* ecoef_den, long long n_edges, int n_atoms, int d1, int d2, int d3,
                   int U, int P, int n_blocks, void* dx_, float* denv, float* partial, float* dw,
                   int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dw)
    return launch_bwd_fused_walk(x_, g_, gts, env, w, row_ptr, desc_dx, scale_dx, rows_dx,
                                 eidx_dx, ecoef_dx, desc_den, scale_den, rows_den, eidx_den,
                                 ecoef_den, n_edges, n_atoms, d1, d2, d3, U, P, dx_, denv, bf16,
                                 st);
  if (n_blocks < 1 || P < 1 || bf16) return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  const float* g = static_cast<const float*>(g_);
  float* dx = static_cast<float*>(dx_);
  if (gts)
    return launch_bwd_fused_dw<true>(x, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, n_edges,
                                     n_atoms, d1, d2, d3, U, P, n_blocks, dx, denv, partial, dw,
                                     st);
  return launch_bwd_fused_dw<false>(x, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, n_edges,
                                    n_atoms, d1, d2, d3, U, P, n_blocks, dx, denv, partial, dw,
                                    st);
}

}  // extern "C"
