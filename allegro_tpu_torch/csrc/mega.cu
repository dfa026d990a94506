// The mega-fused inference layers for Hopper (sm_90a), float32.
//
// Four kernels of the default inference path (`tp_kernel_backend=
// "fused_infer"` with `use_mega` None or True). Each replaces one Pallas TPU
// kernel of allegro_tpu/ops/fused_tp.py and computes the same function in
// atom space instead of the TPU's rank-window space:
//
//   latent_env_scatter  lat[e]        = silu(sum_i p_i[e] @ W0_i) @ W1  (or sum_i p_i[e] @ W0_i)
//                       lat_s[e, s]   = lat[e, s]                      (s < S)
//                       env[a, jU+u]  = sum_{c(e)=a} sh[e,j] lat[e, S + irr(j)U+u]
//   latent_env_bwd      dsh[e, j]     = sum_u t[c(e), jU+u] lat[e, S + irr(j)U+u]
//                       dlat[e]       = [g_lat[e] | sum_{irr(j)=r} t[c(e), jU+u] sh[e,j]]
//                       dp_i[e]       = dlat[e] back through W1, silu' and W0
//   gather_tp_embed     out[e, kU+u]  = sum_n c_n w[p_n,u] x0[e, i_nU+u] env[c(e), j_nU+u]
//                       with x0[e, iU+u] = sh[e, js_i] w2b[e, irs_i U+u] built on the fly
//   bwd_embed           dsh, dw2b and denv of gather_tp_embed; dx0 never reaches memory
//
// Layout (the JAX package's contract): per-edge arrays are row-major with the
// flat dim-major tensor track; edges are sorted by center, row_ptr[a] is the
// first edge of atom a, and padded edges carry the sentinel center n_atoms
// after row_ptr[n_atoms]: they add nothing to any per-atom sum and read zeros
// from per-atom arrays. `(js_i, irs_i)` (`row_specs`) is the SH dim and irrep
// of row i of layer 0's input, after the irreps ladder's pruning.
//
// The MLPs run in exact FP32 FMAs (no TF32, no tensor cores: precision
// "highest"). Every per-atom sum runs in edge order (no atomics), so results
// are deterministic. Each kernel runs on the caller's stream and allocates
// nothing; each entry point returns cudaGetLastError().

#include "common.cu"

namespace {

constexpr int kMegaWarps = 8;  // warps per block of the MLP kernels (fewer if shared memory is short)

// ---------------------------------------------------------------------------
// latent_env_scatter
// Replaces allegro_tpu/ops/fused_tp.py:_latent_env_scatter_kernel
// (latent_env_scatter_call). Bound: exact-FP32 FMAs, K*H + H*N per edge
// (16,384 for the flagship's layer-0 latent: K = 96, H = 64, N = 160), issued
// against shared-memory weight reads; the device-memory traffic is only the
// pieces, sh, lat_s and env, because the hidden activation and the env
// weights lat[:, S:] never leave the SM, as on the TPU. Design: a persistent
// grid; each block stages W0 and W1 (64 KB at the flagship, above the 48 KB
// default, so the entry point opts in) into shared memory once and its warps
// loop over work items: one atom's CSR segment, or a tile of 32 sentinel
// edges (which get lat_s but no env). Per 32 edges of a segment, lane = edge:
// the hidden layer goes through hidden_chunk into the warp's h tile (SiLU
// applied), then each chunk of 32 output columns is formed in registers and
// transposed through the warp's tile so that lane = column: lat_s columns go
// out as coalesced rows, env columns are weighted by sh and summed over the
// segment's edges in edge order into the warp's env row, which is written
// once per atom.
// ---------------------------------------------------------------------------
template <bool kHidden>
__global__ void __launch_bounds__(kMegaWarps* kWarp) latent_env_scatter_kernel(
    Pieces P, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ sh, const int* __restrict__ row_ptr,
    const int* __restrict__ dim_to_irr, long long n_edges, int n_atoms, int d2, int U, int S,
    int K, int H, int N, float* __restrict__ lat_s, float* __restrict__ env) {
  extern __shared__ float smem[];
  const int Np = round_up(N, kWarp);
  const int Hp = kHidden ? round_up(H, kWarp) : Np;  // row width of W0 in shared memory
  const int d2U = d2 * U;
  float* s_w0 = smem;                                          // [K][Hp]
  float* s_w1 = s_w0 + (size_t)K * Hp;                         // [Hp][Np]
  int* s_irr = reinterpret_cast<int*>(s_w1 + (kHidden ? (size_t)Hp * Np : 0));
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  const int per_warp = kWarp * kTile + (kHidden ? kWarp * (Hp + 1) : 0) + d2U;
  float* tile = reinterpret_cast<float*>(s_irr + round_up(d2, 4)) + (size_t)warp * per_warp;
  float* htile = tile + kWarp * kTile;                         // [32][Hp+1]
  float* envrow = htile + (kHidden ? kWarp * (Hp + 1) : 0);    // [d2*U]
  load_padded(w0, K, kHidden ? H : N, K, Hp, s_w0);
  if (kHidden) load_padded(w1, H, N, Hp, Np, s_w1);
  for (int q = threadIdx.x; q < d2; q += blockDim.x) s_irr[q] = dim_to_irr[q];
  __syncthreads();

  const long long tail = row_ptr[n_atoms];
  const long long n_items = n_atoms + (n_edges - tail + kWarp - 1) / kWarp;
  float acc[kWarp];
  for (long long item = (long long)blockIdx.x * wpb + warp; item < n_items;
       item += (long long)gridDim.x * wpb) {
    const bool atom = item < n_atoms;
    long long start, end;
    if (atom) {
      start = row_ptr[item];
      end = row_ptr[item + 1];
      for (int c = lane; c < d2U; c += kWarp) envrow[c] = 0.f;
    } else {
      start = tail + (item - n_atoms) * kWarp;
      end = min(start + kWarp, n_edges);
    }
    __syncwarp();
    for (long long e0 = start; e0 < end; e0 += kWarp) {
      const int n = (int)min((long long)kWarp, end - e0);
      if (kHidden) {
        for (int h0 = 0; h0 < Hp; h0 += kWarp) {
          hidden_chunk(P, e0, n, s_w0, Hp, h0, tile, lane, acc);
#pragma unroll
          for (int j = 0; j < kWarp; ++j) htile[lane * (Hp + 1) + h0 + j] = silu(acc[j]);
        }
      }
      for (int n0 = 0; n0 < Np; n0 += kWarp) {
        if (kHidden) {
#pragma unroll
          for (int j = 0; j < kWarp; ++j) acc[j] = 0.f;
          const float* hrow = htile + lane * (Hp + 1);
          const float* wrow = s_w1 + n0;
          for (int h = 0; h < Hp; ++h, wrow += Np) {
            const float x = hrow[h];
#pragma unroll
            for (int j = 0; j < kWarp; j += 4) {
              const float4 w = *reinterpret_cast<const float4*>(wrow + j);
              acc[j] = fmaf(x, w.x, acc[j]);
              acc[j + 1] = fmaf(x, w.y, acc[j + 1]);
              acc[j + 2] = fmaf(x, w.z, acc[j + 2]);
              acc[j + 3] = fmaf(x, w.w, acc[j + 3]);
            }
          }
        } else {
          hidden_chunk(P, e0, n, s_w0, Hp, n0, tile, lane, acc);
        }
        // lane = edge → lane = column, through the tile
#pragma unroll
        for (int j = 0; j < kWarp; ++j) tile[lane * kTile + j] = acc[j];
        __syncwarp();
        const int c = n0 + lane;
        if (c < S) {
          for (int r = 0; r < n; ++r) lat_s[(e0 + r) * S + c] = tile[r * kTile + lane];
        } else if (atom && c < N) {
          const int col = c - S, irr = col / U, u = col - irr * U;
          for (int j = 0; j < d2; ++j) {
            if (s_irr[j] != irr) continue;
            float s = envrow[j * U + u];
            for (int r = 0; r < n; ++r) s = fmaf(sh[(e0 + r) * d2 + j], tile[r * kTile + lane], s);
            envrow[j * U + u] = s;
          }
        }
        __syncwarp();
      }
    }
    if (atom)
      for (int c = lane; c < d2U; c += kWarp) env[item * d2U + c] = envrow[c];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// latent_env_bwd
// Replaces allegro_tpu/ops/fused_tp.py:_latent_env_bwd_kernel
// (latent_env_bwd_call). Bound: exact-FP32 FMAs against shared-memory weight
// reads, K*H + 2*H*N' + H*K per edge (N' = the env columns recomputed, all N
// on the way back); the device-memory traffic is the pieces and their
// cotangents, sh, dsh and g_lat, plus t rows that the ~25 edges of an atom
// share (L1). Design: a persistent grid over tiles of 32 edges, one warp per
// tile, lane = edge, weights staged once per block as in latent_env_scatter.
// Each lane recomputes its edge's pre-activation (hidden_chunk, kept in the
// warp's p tile), then walks the output columns 32 at a time: the env-weight
// columns are recomputed in registers, give dsh (per-lane partial sums in
// shared memory) and are replaced by their cotangent dwexp, which needs no
// reduction; the lat_s columns take g_lat, staged through the tile so its
// rows are read coalesced. Each chunk of dlat is pushed through W1 into the
// lane's dh row; then dh * silu'(pre) goes back through W0 (backprop_chunk)
// into the piece cotangents. Without a hidden layer dlat goes straight
// through W0. A sentinel edge reads t = 0, so its dsh and dwexp are zero and
// its piece cotangents come from g_lat alone, as on the TPU.
// ---------------------------------------------------------------------------
template <bool kHidden>
__global__ void __launch_bounds__(kMegaWarps* kWarp) latent_env_bwd_kernel(
    Pieces P, OutPieces D, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ sh, const float* __restrict__ t, const float* __restrict__ g_lat,
    const int* __restrict__ centers, const int* __restrict__ dim_to_irr, long long n_edges,
    int n_atoms, int d2, int U, int S, int K, int H, int N, float* __restrict__ dsh) {
  extern __shared__ float smem[];
  const int Np = round_up(N, kWarp);
  const int Hp = kHidden ? round_up(H, kWarp) : Np;
  const int d2U = d2 * U;
  float* s_w0 = smem;                                          // [K][Hp]
  float* s_w1 = s_w0 + (size_t)K * Hp;                         // [Hp][Np]
  int* s_irr = reinterpret_cast<int*>(s_w1 + (kHidden ? (size_t)Hp * Np : 0));
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  const int per_warp = kWarp * kTile + (kHidden ? 2 * kWarp * (Hp + 1) : 0) + d2 * kWarp;
  float* tile = reinterpret_cast<float*>(s_irr + round_up(d2, 4)) + (size_t)warp * per_warp;
  float* ptile = tile + kWarp * kTile;                         // [32][Hp+1] pre-activations
  float* dhtile = ptile + (kHidden ? kWarp * (Hp + 1) : 0);    // [32][Hp+1] d(hidden)
  float* dshbuf = dhtile + (kHidden ? kWarp * (Hp + 1) : 0);   // [d2][32]
  load_padded(w0, K, kHidden ? H : N, K, Hp, s_w0);
  if (kHidden) load_padded(w1, H, N, Hp, Np, s_w1);
  for (int q = threadIdx.x; q < d2; q += blockDim.x) s_irr[q] = dim_to_irr[q];
  __syncthreads();

  float acc[kWarp];
  for (long long e0 = ((long long)blockIdx.x * wpb + warp) * kWarp; e0 < n_edges;
       e0 += (long long)gridDim.x * wpb * kWarp) {
    const int n = (int)min((long long)kWarp, n_edges - e0);
    const long long e = e0 + lane;
    const int c = lane < n ? centers[e] : n_atoms;
    const bool valid = c >= 0 && c < n_atoms;
    const float* te = t + (valid ? (long long)c * d2U : 0);
    const float* se = sh + (valid ? e * d2 : 0);
    for (int j = 0; j < d2; ++j) dshbuf[j * kWarp + lane] = 0.f;
    if (kHidden) {
      for (int h0 = 0; h0 < Hp; h0 += kWarp) {
        hidden_chunk(P, e0, n, s_w0, Hp, h0, tile, lane, acc);
#pragma unroll
        for (int j = 0; j < kWarp; ++j) {
          ptile[lane * (Hp + 1) + h0 + j] = acc[j];
          dhtile[lane * (Hp + 1) + h0 + j] = 0.f;
        }
      }
    }
    for (int n0 = 0; n0 < Np; n0 += kWarp) {
      // forward values of the chunk's env-weight columns
      if (n0 + kWarp > S && n0 < N) {
        if (kHidden) {
#pragma unroll
          for (int j = 0; j < kWarp; ++j) acc[j] = 0.f;
          const float* prow = ptile + lane * (Hp + 1);
          const float* wrow = s_w1 + n0;
          for (int h = 0; h < Hp; ++h, wrow += Np) {
            const float x = silu(prow[h]);
#pragma unroll
            for (int j = 0; j < kWarp; j += 4) {
              const float4 w = *reinterpret_cast<const float4*>(wrow + j);
              acc[j] = fmaf(x, w.x, acc[j]);
              acc[j + 1] = fmaf(x, w.y, acc[j + 1]);
              acc[j + 2] = fmaf(x, w.z, acc[j + 2]);
              acc[j + 3] = fmaf(x, w.w, acc[j + 3]);
            }
          }
        } else {
          hidden_chunk(P, e0, n, s_w0, Hp, n0, tile, lane, acc);
        }
      }
      // the chunk's g_lat columns, read as coalesced rows into the tile
      if (n0 < S) {
        const int col = n0 + lane;
        for (int r = 0; r < kWarp; ++r)
          tile[r * kTile + lane] = (r < n && col < S) ? g_lat[(e0 + r) * S + col] : 0.f;
      }
      __syncwarp();
      // acc ← dlat of the chunk; dsh from the env-weight columns
#pragma unroll
      for (int jj = 0; jj < kWarp; ++jj) {
        const int cc = n0 + jj;
        float dl = 0.f;
        if (cc < S) {
          dl = tile[lane * kTile + jj];
        } else if (cc < N && valid) {
          const int col = cc - S, irr = col / U, u = col - irr * U;
          for (int j = 0; j < d2; ++j) {
            if (s_irr[j] != irr) continue;
            const float tv = te[j * U + u];
            dshbuf[j * kWarp + lane] = fmaf(tv, acc[jj], dshbuf[j * kWarp + lane]);
            dl = fmaf(tv, se[j], dl);
          }
        }
        acc[jj] = dl;
      }
      __syncwarp();
      if (kHidden) {
        // dh[h] += sum_j dlat[j] W1[h, n0+j]
        float* drow = dhtile + lane * (Hp + 1);
        const float* wrow = s_w1 + n0;
        for (int h = 0; h < Hp; ++h, wrow += Np) {
          float s = drow[h];
#pragma unroll
          for (int j = 0; j < kWarp; j += 4) {
            const float4 w = *reinterpret_cast<const float4*>(wrow + j);
            s = fmaf(acc[j], w.x, s);
            s = fmaf(acc[j + 1], w.y, s);
            s = fmaf(acc[j + 2], w.z, s);
            s = fmaf(acc[j + 3], w.w, s);
          }
          drow[h] = s;
        }
      } else {
        backprop_chunk(D, e0, n, s_w0, Hp, n0, acc, tile, lane, n0 == 0);
      }
    }
    if (kHidden) {
      for (int h0 = 0; h0 < Hp; h0 += kWarp) {
#pragma unroll
        for (int j = 0; j < kWarp; ++j)
          acc[j] = dhtile[lane * (Hp + 1) + h0 + j] * silu_grad(ptile[lane * (Hp + 1) + h0 + j]);
        backprop_chunk(D, e0, n, s_w0, Hp, h0, acc, tile, lane, h0 == 0);
      }
    }
    // dsh rows [e0, e0+n) are one contiguous block: write it coalesced
    __syncwarp();
    for (int q = lane; q < n * d2; q += kWarp) {
      const int r = q / d2, j = q - r * d2;
      dsh[e0 * d2 + q] = dshbuf[j * kWarp + r];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// gather_tp_embed
// Replaces allegro_tpu/ops/fused_tp.py:_gather_tp_embed_raw_kernel
// (gather_tp_embed_raw_call). Bound: the write of out [E, d3*U] (and ts); the
// reads are sh [E, d_sh] and w2b [E, n_irr*U], 3x fewer bytes than the
// [E, d1*U] layer-0 features, which never exist. Design: gather_tp's (one
// warp per edge, lane = channel u, k-accumulators in shared memory), with the
// warp's x0 row built in shared memory from sh and w2b before the entry loop.
// ---------------------------------------------------------------------------
__global__ void gather_tp_embed_kernel(
    const float* __restrict__ sh, const float* __restrict__ w2b, const float* __restrict__ env,
    const float* __restrict__ w, const int* __restrict__ centers, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, int n_entries, const int* __restrict__ row_specs,
    long long n_edges, int n_atoms, int d_sh, int n_irr, int d1, int d2, int d3, int U,
    float* __restrict__ out, float* __restrict__ ts) {
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_idx + 4 * n_entries);
  int* s_spec = reinterpret_cast<int*>(s_coef + n_entries);
  float* s_acc = reinterpret_cast<float*>(s_spec + 2 * d1);
  load_entries(eidx, ecoef, n_entries, s_idx, s_coef);
  for (int q = threadIdx.x; q < 2 * d1; q += blockDim.x) s_spec[q] = row_specs[q];
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  float* acc = s_acc + warp * (d3 + d1) * kWarp;
  float* x0 = acc + d3 * kWarp;
  const long long nU = (long long)n_irr * U;
  for (long long e = (long long)blockIdx.x * wpb + warp; e < n_edges;
       e += (long long)gridDim.x * wpb) {
    const int c = centers[e];
    const bool valid = c >= 0 && c < n_atoms;
    const float* ee = env + (valid ? (long long)c * d2 * U : 0);
    float* oe = out + e * d3 * U;
    for (int u0 = 0; u0 < U; u0 += kWarp) {
      const int u = u0 + lane;
      const bool act = u < U;
      for (int k = 0; k < d3; ++k) acc[k * kWarp + lane] = 0.f;
      if (act && valid) {
        for (int i = 0; i < d1; ++i)
          x0[i * kWarp + lane] = sh[e * d_sh + s_spec[2 * i]] * w2b[e * nU + s_spec[2 * i + 1] * U + u];
        for (int n = 0; n < n_entries; ++n) {
          const int i = s_idx[4 * n], j = s_idx[4 * n + 1], k = s_idx[4 * n + 2],
                    p = s_idx[4 * n + 3];
          acc[k * kWarp + lane] += s_coef[n] * w[p * U + u] * x0[i * kWarp + lane] * ee[j * U + u];
        }
      }
      if (act) {
        for (int k = 0; k < d3; ++k) oe[k * U + u] = acc[k * kWarp + lane];
        if (ts) ts[e * U + u] = acc[lane];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_embed
// Replaces allegro_tpu/ops/fused_tp.py:_bwd_embed_raw_kernel
// (bwd_embed_raw_call). Bound: the read of g [E, d3*U] and the writes of
// dw2b [E, n_irr*U] and dsh; the layer-0 features and their cotangent dx0
// [E, d1*U] never reach device memory. Design: bwd_fused's (one block per atom
// segment, each warp takes every W-th edge, lane = channel u, denv summed per
// warp in shared memory and across warps in a fixed order), with x0 built in
// shared memory from sh and w2b, gts added to g's block 0 as it is read, and
// dx0[e, i] reduced at once onto the factors: dsh[e, js_i] += sum_u dx0 w2b
// (a warp sum) and dw2b[e, irs_i U+u] += dx0 sh[e, js_i]. Block n_atoms
// zeroes dsh and dw2b on the sentinel edges, which belong to no segment.
// Instantiated with and without gts, as bwd_fused.
// ---------------------------------------------------------------------------
template <bool kGts>
__global__ void bwd_embed_kernel(
    const float* __restrict__ sh, const float* __restrict__ w2b, const float* __restrict__ g,
    const float* __restrict__ gts, const float* __restrict__ env, const float* __restrict__ w,
    const int* __restrict__ row_ptr, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, int n_entries, const int* __restrict__ row_specs,
    long long n_edges, int n_atoms, int d_sh, int n_irr, int d1, int d2, int d3, int U,
    float* __restrict__ dsh, float* __restrict__ dw2b, float* __restrict__ denv) {
  extern __shared__ float smem[];
  const int a = blockIdx.x;
  const long long nU = (long long)n_irr * U;
  if (a == n_atoms) {
    const long long first = row_ptr[n_atoms];
    for (long long q = first * d_sh + threadIdx.x; q < n_edges * d_sh; q += blockDim.x)
      dsh[q] = 0.f;
    for (long long q = first * nU + threadIdx.x; q < n_edges * nU; q += blockDim.x)
      dw2b[q] = 0.f;
    return;
  }
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_coef = reinterpret_cast<float*>(s_idx + 4 * n_entries);
  int* s_spec = reinterpret_cast<int*>(s_coef + n_entries);
  const int wpb = blockDim.x / kWarp;
  const int d2U = d2 * U;
  const int per_warp = d2U + (2 * d1 + d_sh) * kWarp;
  float* s_den = reinterpret_cast<float*>(s_spec + 2 * d1);   // [wpb][d2*U] first
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float* pden = s_den + warp * d2U;
  float* pdx = s_den + wpb * d2U + warp * (per_warp - d2U);   // [d1][32]
  float* px = pdx + d1 * kWarp;                               // [d1][32]
  float* pdsh = px + d1 * kWarp;                              // [d_sh][32]
  load_entries(eidx, ecoef, n_entries, s_idx, s_coef);
  for (int q = threadIdx.x; q < 2 * d1; q += blockDim.x) s_spec[q] = row_specs[q];
  for (int col = lane; col < d2U; col += kWarp) pden[col] = 0.f;
  __syncthreads();
  const int start = row_ptr[a], end = row_ptr[a + 1];
  const float* ea = env + (long long)a * d2U;
  for (int e = start + warp; e < end; e += wpb) {
    const float* ge = g + (long long)e * d3 * U;
    const float* se = sh + (long long)e * d_sh;
    const float* we = w2b + e * nU;
    for (int j = 0; j < d_sh; ++j) pdsh[j * kWarp + lane] = 0.f;
    for (int u0 = 0; u0 < U; u0 += kWarp) {
      const int u = u0 + lane;
      if (u >= U) continue;
      const float g0 = kGts ? ge[u] + gts[(long long)e * U + u] : 0.f;
      for (int i = 0; i < d1; ++i) {
        px[i * kWarp + lane] = se[s_spec[2 * i]] * we[s_spec[2 * i + 1] * U + u];
        pdx[i * kWarp + lane] = 0.f;
      }
      for (int n = 0; n < n_entries; ++n) {
        const int i = s_idx[4 * n], j = s_idx[4 * n + 1], k = s_idx[4 * n + 2],
                  p = s_idx[4 * n + 3];
        const float gk = (kGts && k == 0) ? g0 : ge[k * U + u];
        const float cwg = s_coef[n] * w[p * U + u] * gk;
        pdx[i * kWarp + lane] += cwg * ea[j * U + u];
        pden[j * U + u] += cwg * px[i * kWarp + lane];
      }
      for (int i = 0; i < d1; ++i) {
        const int js = s_spec[2 * i];
        pdsh[js * kWarp + lane] += pdx[i * kWarp + lane] * we[s_spec[2 * i + 1] * U + u];
      }
      for (int r = 0; r < n_irr; ++r) {
        float s = 0.f;
        for (int i = 0; i < d1; ++i)
          if (s_spec[2 * i + 1] == r) s += pdx[i * kWarp + lane] * se[s_spec[2 * i]];
        dw2b[e * nU + r * U + u] = s;
      }
    }
    for (int j = 0; j < d_sh; ++j) {
      const float s = warp_sum(pdsh[j * kWarp + lane]);
      if (lane == 0) dsh[(long long)e * d_sh + j] = s;
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d2U; col += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < wpb; ++q) s += s_den[q * d2U + col];
    denv[(long long)a * d2U + col] = s;
  }
}

// Shared memory of the two MLP kernels: the weights, the irrep table, and
// ``per_warp`` floats per warp; returns the warp count that fits (0: none).
int mlp_warps(size_t fixed, size_t per_warp, size_t* smem) {
  const size_t limit = smem_optin();
  if (fixed + per_warp > limit) return 0;
  size_t warps = (limit - fixed) / per_warp;
  if (warps > (size_t)kMegaWarps) warps = kMegaWarps;
  *smem = fixed + warps * per_warp;
  return (int)warps;
}

size_t mlp_weights_bytes(int K, int H, int N, int d2, bool hidden) {
  const int Np = round_up(N, kWarp);
  const int Hp = hidden ? round_up(H, kWarp) : Np;
  return ((size_t)K * Hp + (hidden ? (size_t)Hp * Np : 0) + round_up(d2, 4)) * sizeof(float);
}

template <bool kHidden>
int launch_latent_env_scatter(const Pieces& P, const float* w0, const float* w1, const float* sh,
                              const int* row_ptr, const int* dim_to_irr, long long n_edges,
                              int n_atoms, int d2, int U, int S, int K, int H, int N, float* lat_s,
                              float* env, cudaStream_t stream) {
  const int Hp = kHidden ? round_up(H, kWarp) : round_up(N, kWarp);
  const size_t per_warp =
      (kWarp * kTile + (kHidden ? kWarp * (Hp + 1) : 0) + (size_t)d2 * U) * sizeof(float);
  size_t smem = 0;
  const int warps = mlp_warps(mlp_weights_bytes(K, H, N, d2, kHidden), per_warp, &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem(latent_env_scatter_kernel<kHidden>, smem);
  if (err != cudaSuccess) return (int)err;
  // work items: the atoms' segments and the 32-edge tiles of the sentinel tail
  const long long items = n_atoms + (n_edges + kWarp - 1) / kWarp;
  const int blocks = persistent_blocks(latent_env_scatter_kernel<kHidden>, warps * kWarp, smem,
                                       items, warps);
  latent_env_scatter_kernel<kHidden><<<blocks, warps * kWarp, smem, stream>>>(
      P, w0, w1, sh, row_ptr, dim_to_irr, n_edges, n_atoms, d2, U, S, K, H, N, lat_s, env);
  return (int)cudaGetLastError();
}

template <bool kHidden>
int launch_latent_env_bwd(const Pieces& P, const OutPieces& D, const float* w0, const float* w1,
                          const float* sh, const float* t, const float* g_lat, const int* centers,
                          const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int U,
                          int S, int K, int H, int N, float* dsh, cudaStream_t stream) {
  const int Hp = kHidden ? round_up(H, kWarp) : round_up(N, kWarp);
  const size_t per_warp =
      (kWarp * kTile + (kHidden ? 2 * kWarp * (Hp + 1) : 0) + (size_t)d2 * kWarp) * sizeof(float);
  size_t smem = 0;
  const int warps = mlp_warps(mlp_weights_bytes(K, H, N, d2, kHidden), per_warp, &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem(latent_env_bwd_kernel<kHidden>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(latent_env_bwd_kernel<kHidden>, warps * kWarp, smem,
                                       (n_edges + kWarp - 1) / kWarp, warps);
  latent_env_bwd_kernel<kHidden><<<blocks, warps * kWarp, smem, stream>>>(
      P, D, w0, w1, sh, t, g_lat, centers, dim_to_irr, n_edges, n_atoms, d2, U, S, K, H, N, dsh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int atpt_latent_env_scatter(const float* const* piece_ptrs, const long long* piece_strides,
                            const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                            const float* sh, const int* row_ptr, const int* dim_to_irr,
                            long long n_edges, int n_atoms, int d2, int U, int S, int H, int N,
                            float* lat_s, float* env, void* stream) {
  Pieces P;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0) return (int)cudaErrorInvalidValue;
  P.n = n_pieces;
  if (w1)
    return launch_latent_env_scatter<true>(P, w0, w1, sh, row_ptr, dim_to_irr, n_edges, n_atoms,
                                           d2, U, S, K, H, N, lat_s, env, (cudaStream_t)stream);
  return launch_latent_env_scatter<false>(P, w0, w1, sh, row_ptr, dim_to_irr, n_edges, n_atoms,
                                          d2, U, S, K, H, N, lat_s, env, (cudaStream_t)stream);
}

int atpt_latent_env_bwd(const float* const* piece_ptrs, const long long* piece_strides,
                        float* const* dpiece_ptrs, const long long* dpiece_strides,
                        const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                        const float* sh, const float* t, const float* g_lat, const int* centers,
                        const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int U,
                        int S, int H, int N, float* dsh, void* stream) {
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
  if (w1)
    return launch_latent_env_bwd<true>(P, D, w0, w1, sh, t, g_lat, centers, dim_to_irr, n_edges,
                                       n_atoms, d2, U, S, K, H, N, dsh, (cudaStream_t)stream);
  return launch_latent_env_bwd<false>(P, D, w0, w1, sh, t, g_lat, centers, dim_to_irr, n_edges,
                                      n_atoms, d2, U, S, K, H, N, dsh, (cudaStream_t)stream);
}

int atpt_gather_tp_embed(const float* sh, const float* w2b, const float* env, const float* w,
                         const int* centers, const int* eidx, const float* ecoef, int n_entries,
                         const int* row_specs, long long n_edges, int n_atoms, int d_sh,
                         int n_irr, int d1, int d2, int d3, int U, float* out, float* ts,
                         void* stream) {
  const size_t smem = (size_t)(5 * n_entries + 2 * d1) * 4 +
                      (size_t)kEdgeWarps * (d3 + d1) * kWarp * sizeof(float);
  cudaError_t err = prepare_smem(gather_tp_embed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gather_tp_embed_kernel<<<edge_blocks(n_edges), kEdgeWarps * kWarp, smem,
                           (cudaStream_t)stream>>>(sh, w2b, env, w, centers, eidx, ecoef,
                                                   n_entries, row_specs, n_edges, n_atoms, d_sh,
                                                   n_irr, d1, d2, d3, U, out, ts);
  return (int)cudaGetLastError();
}

int atpt_bwd_embed(const float* sh, const float* w2b, const float* g, const float* gts,
                   const float* env, const float* w, const int* row_ptr, const int* eidx,
                   const float* ecoef, int n_entries, const int* row_specs, long long n_edges,
                   int n_atoms, int d_sh, int n_irr, int d1, int d2, int d3, int U, float* dsh,
                   float* dw2b, float* denv, void* stream) {
  const size_t fixed = (size_t)(5 * n_entries + 2 * d1) * 4;
  const size_t per_warp = ((size_t)d2 * U + (size_t)(2 * d1 + d_sh) * kWarp) * sizeof(float);
  size_t smem = 0;
  const int warps = fit_warps(fixed, per_warp, kSegmentWarps, &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = gts ? prepare_smem(bwd_embed_kernel<true>, smem)
                        : prepare_smem(bwd_embed_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (gts)
    bwd_embed_kernel<true><<<n_atoms + 1, warps * kWarp, smem, (cudaStream_t)stream>>>(
        sh, w2b, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, row_specs, n_edges, n_atoms,
        d_sh, n_irr, d1, d2, d3, U, dsh, dw2b, denv);
  else
    bwd_embed_kernel<false><<<n_atoms + 1, warps * kWarp, smem, (cudaStream_t)stream>>>(
        sh, w2b, g, gts, env, w, row_ptr, eidx, ecoef, n_entries, row_specs, n_edges, n_atoms,
        d_sh, n_irr, d1, d2, d3, U, dsh, dw2b, denv);
  return (int)cudaGetLastError();
}

}  // extern "C"
