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
//   bwd_embed           dsh, dw2b and denv of gather_tp_embed; dx0 never reaches memory;
//                       the CG table walked by path, each path a block of cg_blocks.h
//
// Layout (the JAX package's contract): per-edge arrays are row-major with the
// flat dim-major tensor track; edges are sorted by center, row_ptr[a] is the
// first edge of atom a, and padded edges carry the sentinel center n_atoms
// after row_ptr[n_atoms]: they add nothing to any per-atom sum and read zeros
// from per-atom arrays. `(js_i, irs_i)` (`row_specs`) is the SH dim and irrep
// of row i of layer 0's input, after the irreps ladder's pruning.
//
// The MLPs run in exact FP32 FMAs (no TF32, no tensor cores: precision
// "highest"); latent_env_bwd's four products are register-tiled GEMMs. Every per-atom sum runs in edge order (no atomics), so results
// are deterministic. Each kernel runs on the caller's stream and allocates
// nothing; each entry point returns cudaGetLastError().

#include <type_traits>

#include "common.cu"
#include "cg_blocks.h"

namespace {

constexpr int kMegaWarps = 8;  // warps per block of latent_env_scatter (fewer if shared memory is short)

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
// (latent_env_bwd_call). Bound: exact-FP32 FMAs, K*H + H*NE + N*H + H*K per
// edge with a hidden layer (NE = N - S env columns), K*NE + N*K without;
// the device-memory traffic is the pieces and their cotangents, sh, dsh,
// g_lat and t rows that the ~25 edges of an atom share. Design: a register-
// tiled GEMM chain over tiles of kLebRows edges. A persistent grid of blocks
// of kLebThreads threads, one per SM (the weights take most of its shared
// memory); each block stages the weights once, zero-padded, in the layouts
// its products read, and walks its tiles. Each tile's piece rows come in
// with cp.async, double-buffered where shared memory allows, so the next
// tile's rows load during this tile's math; its g_lat and sh rows load
// during the first two products. Every product runs on 4 x 8 register
// micro-tiles (4 x 4 on a last chunk of 32 columns): thread row group ty
// owns 4 edges, column group tx 8 columns, so each float4 read from shared
// memory feeds 8 or more FMAs:
//   pre = A W0                    (rows of A against rows of W0^T)
//   lat_env = silu(pre) W1[:, S:]  (columns of silu(pre)^T against rows of W1)
//   dh = dlat W1^T                (rows of dlat against rows of W1)
//   dA = (dh * silu'(pre)) W0^T   (columns of its transpose against rows of W0^T)
// silu(pre) and silu'(pre) are computed once per element, when pre leaves
// the registers, and kept transposed in the tile. The t rows of the tile's
// first atoms (up to kLebTileAtoms, as shared memory allows) load with the
// tile's g_lat and sh rows. Between
// the second and third products, one thread per (edge, SH dim) sums dsh =
// t . lat_env over the channels, and one per (edge, env column) sums
// dlat_env = t * sh over its irrep's dims from the per-irrep [start, len)
// table, written over lat_env: no branch over all d2 dims, no accumulator
// read back from shared memory inside a loop.
// Without a hidden layer: lat_env = A W0[:, S:] and dA = dlat W0^T, on the
// same helpers. dA goes back through the tile's piece rows, so the piece
// cotangents leave as coalesced rows. Rows of a stored operand that threads
// read strided have a stride of 4 mod 32 floats, so those float4 reads are
// free of bank conflicts. Every sum runs in a fixed order: no atomics. A
// sentinel edge reads t = 0, so its dsh and env cotangents are zero and its
// piece cotangents come from g_lat alone.
// ---------------------------------------------------------------------------
constexpr int kLebRows = 64;      // edges per tile: 16 row groups of 4
constexpr int kLebCols = 64;      // columns per pass: 8 column groups of 8
constexpr int kLebThreads = 128;  // (kLebRows / 4) x (kLebCols / 8)
constexpr int kLebIlp = 4;        // env-step items a thread works on at once
constexpr int kLebTileAtoms = 6;  // t rows a tile stages (it spans ~3 atoms at ~25 edges each)

// A row stride of 4 mod 32 floats: 8 threads reading rows r, r+1, ... of it
// as float4 hit 8 distinct bank quads.
__host__ __device__ inline int leb_ld(int width) { return round_up(width, kWarp) + 4; }

// Shared-memory layout of latent_env_bwd, offsets in floats (multiples of 4).
struct LebLayout {
  int ldK, ldS, ldE, ldM;  // strides of K-, S-, NE-wide rows and of kLebRows-wide rows
  int wa, wb, wc;          // hidden: W0^T [Hr][ldK], W1[:, :S] [Hr][ldS], W1[:, S:] [Hr][ldE]
                           // none: W0[:, S:]^T [NEr][ldK], W0[:, :S] [Kr][ldS], W0[:, S:] [Kr][ldE]
  int a, g, e, ht, st, sh, tt, tc, irr;  // tiles: pieces (stages of [kLebRows][ldK]; then
                                 // their cotangent), g_lat, env columns (then their
                                 // cotangent), silu(pre)^T (then the cotangent of pre),
                                 // silu'(pre)^T, sh, the t rows of the tile's first
                                 // kLebTileAtoms atoms, the centers; the per-irrep
                                 // (start, len) table
  int stages, ta, total;  // ta: the atoms whose t rows a tile stages
};

__host__ __device__ inline LebLayout leb_layout(bool hidden, int K, int H, int S, int NE, int d2,
                                                int U, int n_irr, int stages, int ta) {
  LebLayout L;
  L.ldK = leb_ld(K);
  L.ldS = leb_ld(S);
  L.ldE = leb_ld(NE);
  L.ldM = kLebRows + 4;
  const int Hr = round_up(H, kLebCols), Kr = round_up(K, kLebCols), NEr = round_up(NE, kLebCols);
  int o = 0;
  L.wa = o;
  o += (hidden ? Hr : NEr) * L.ldK;
  L.wb = o;
  o += (hidden ? Hr : Kr) * L.ldS;
  L.wc = o;
  o += (hidden ? Hr : Kr) * L.ldE;
  L.a = o;
  o += stages * kLebRows * L.ldK;
  L.g = o;
  o += kLebRows * L.ldS;
  L.e = o;
  o += kLebRows * L.ldE;
  L.ht = o;
  o += hidden ? H * L.ldM : 0;
  L.st = o;
  o += hidden ? H * L.ldM : 0;
  L.sh = o;
  o += round_up(kLebRows * d2, 4);
  L.tt = o;
  o += ta * round_up(d2 * U, 4);
  L.tc = o;
  o += kLebRows;
  L.irr = o;
  o += 2 * n_irr;
  L.stages = stages;
  L.ta = ta;
  L.total = round_up(o, 4);
  return L;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

constexpr int kLebWarps = kLebThreads / kWarp;

// Rows [e0, e0 + kLebRows) of a width-column array (row stride ``stride``)
// into dst (row stride ld), a warp per row, lane = column; rows past
// n_edges are left as they are.
__device__ __forceinline__ void leb_load_rows(const float* src, long long stride, int width,
                                              long long e0, long long n_edges, float* dst,
                                              int ld) {
  const int lane = threadIdx.x % kWarp;
  for (int m = threadIdx.x / kWarp; m < kLebRows && e0 + m < n_edges; m += kLebWarps)
    for (int k = lane; k < width; k += kWarp) cp_async4(dst + m * ld + k, src + (e0 + m) * stride + k);
}

__device__ __forceinline__ void leb_load_pieces(const Pieces& P, long long e0, long long n_edges,
                                                float* A, int ld) {
  for (int i = 0; i < P.n; ++i)
    leb_load_rows(P.ptr[i], P.stride[i], P.dim[i], e0, n_edges, A + P.off[i], ld);
}

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

template <int TN>
__device__ __forceinline__ void load_rows(const float* X, int ldx, const float* Y, int ldy, int k,
                                          float4 (&x)[4], float4 (&y)[TN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(X + i * ldx + k);
#pragma unroll
  for (int j = 0; j < TN; ++j) y[j] = *reinterpret_cast<const float4*>(Y + j * 8 * ldy + k);
}

// acc[i][j] += sum_k X[i][k] Y[8j][k] over Kd (a multiple of 4): the thread's
// 4 rows of X (stride ldx) against its TN rows of Y, 8 apart (stride ldy).
template <int TN>
__device__ __forceinline__ void mma_rows(const float* X, int ldx, const float* Y, int ldy, int Kd,
                                         float (&acc)[4][8]) {
#pragma unroll 2
  for (int k = 0; k < Kd; k += 4) {
    float4 x[4], y[TN];
    load_rows<TN>(X, ldx, Y, ldy, k, x, y);
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
    if (TN == 8) b[s][1] = *reinterpret_cast<const float4*>(R + (k + s) * ldr + 4);
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

// acc[i][j] += sum_k Lt[k][i] R[k][j] over Kd: the thread's 4 contiguous
// columns of Lt (row stride ldl) against its TN contiguous columns of R, 4
// k's at a time. Lt and R must have round_up(Kd, 4) readable rows (the tail
// rows are multiplied by nothing).
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

// f(TN, c0) over the column chunks of [0, width): 64 columns (8 a thread)
// while they last, then 32 (4 a thread), so no thread idles on a wide tail.
template <class F>
__device__ __forceinline__ void leb_chunks(int width, F&& f) {
  int c0 = 0;
  for (; c0 + kLebCols <= width; c0 += kLebCols) f(std::integral_constant<int, 8>(), c0);
  for (; c0 < width; c0 += kLebCols / 2) f(std::integral_constant<int, 4>(), c0);
}

template <bool kHidden>
__global__ void __launch_bounds__(kLebThreads) latent_env_bwd_kernel(
    Pieces P, OutPieces D, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ sh, const float* __restrict__ t, const float* __restrict__ g_lat,
    const int* __restrict__ centers, const int* __restrict__ irr_ranges, long long n_edges,
    int n_atoms, int d2, int n_irr, int U, int S, int K, int H, int N, LebLayout L,
    float* __restrict__ dsh) {
  extern __shared__ float smem[];
  const int NE = N - S, T = blockDim.x;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8, m0 = ty * 4;
  const int warp = tid / kWarp, lane = tid % kWarp;
  float* Wa = smem + L.wa;
  float* Wb = smem + L.wb;
  float* Wc = smem + L.wc;
  // the weights, zero-padded, once per block
  if (kHidden) {
    const int Hr = round_up(H, kLebCols);
    for (int q = tid; q < Hr * L.ldK; q += T) {
      const int h = q / L.ldK, k = q - h * L.ldK;
      Wa[q] = (h < H && k < K) ? w0[(long long)k * H + h] : 0.f;
    }
    for (int q = tid; q < Hr * L.ldS; q += T) {
      const int h = q / L.ldS, n = q - h * L.ldS;
      Wb[q] = (h < H && n < S) ? w1[(long long)h * N + n] : 0.f;
    }
    for (int q = tid; q < Hr * L.ldE; q += T) {
      const int h = q / L.ldE, c = q - h * L.ldE;
      Wc[q] = (h < H && c < NE) ? w1[(long long)h * N + S + c] : 0.f;
    }
  } else {
    const int Kr = round_up(K, kLebCols), NEr = round_up(NE, kLebCols);
    for (int q = tid; q < NEr * L.ldK; q += T) {
      const int c = q / L.ldK, k = q - c * L.ldK;
      Wa[q] = (c < NE && k < K) ? w0[(long long)k * N + S + c] : 0.f;
    }
    for (int q = tid; q < Kr * L.ldS; q += T) {
      const int k = q / L.ldS, n = q - k * L.ldS;
      Wb[q] = (k < K && n < S) ? w0[(long long)k * N + n] : 0.f;
    }
    for (int q = tid; q < Kr * L.ldE; q += T) {
      const int k = q / L.ldE, c = q - k * L.ldE;
      Wc[q] = (k < K && c < NE) ? w0[(long long)k * N + S + c] : 0.f;
    }
  }
  for (int q = L.a + tid; q < L.irr; q += T) smem[q] = 0.f;  // the tiles' padding stays zero
  int* s_rng = reinterpret_cast<int*>(smem + L.irr);         // [n_irr][2] (start, len)
  for (int q = tid; q < 2 * n_irr; q += T) s_rng[q] = irr_ranges[q];
  __syncthreads();

  float* A0 = smem + L.a;
  float* G = smem + L.g;
  float* E = smem + L.e;
  float* Ht = smem + L.ht;
  float* St = smem + L.st;
  float* Sh = smem + L.sh;
  float* Tt = smem + L.tt;
  int* Tc = reinterpret_cast<int*>(smem + L.tc);
  const int a_floats = kLebRows * L.ldK;
  const int Kd = round_up(K, 4), Sd = round_up(S, 4), NEd = round_up(NE, 4);
  const long long d2U = (long long)d2 * U;
  const long long n_tiles = (n_edges + kLebRows - 1) / kLebRows;
  float acc[4][8];
  int buf = 0;
  if (L.stages == 2 && blockIdx.x < n_tiles)
    leb_load_pieces(P, (long long)blockIdx.x * kLebRows, n_edges, A0, L.ldK);
  cp_async_commit();
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long e0 = tile * kLebRows;
    float* A = A0 + (L.stages == 2 ? buf * a_floats : 0);
    if (L.stages == 1) {
      leb_load_pieces(P, e0, n_edges, A, L.ldK);
      cp_async_commit();
    }
    leb_load_rows(g_lat, S, S, e0, n_edges, G, L.ldS);
    leb_load_rows(sh, d2, d2, e0, n_edges, Sh, d2);
    // the t rows of the tile's first L.ta atoms (centers are sorted: the
    // edges of atoms ca .. ca + L.ta - 1 read them from here)
    const int ca = centers[e0];
    const int dU = round_up(d2 * U, 4);
    for (int q = tid; q < kLebRows; q += T)
      if (e0 + q < n_edges)
        cp_async4(reinterpret_cast<float*>(Tc + q), reinterpret_cast<const float*>(centers + e0 + q));
    for (int i = warp; i < L.ta && ca + i < n_atoms; i += kLebWarps)
      for (int k = lane; k < d2 * U; k += kWarp) cp_async4(Tt + i * dU + k, t + (ca + i) * d2U + k);
    cp_async_commit();
    if (L.stages == 2) {
      const long long next = tile + gridDim.x;
      if (next < n_tiles)
        leb_load_pieces(P, next * kLebRows, n_edges, A0 + (buf ^ 1) * a_floats, L.ldK);
      cp_async_commit();
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    if (kHidden) {
      // pre = A W0, leaving the registers as silu(pre)^T and silu'(pre)^T
      leb_chunks(H, [&](auto tn, int h0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(A + m0 * L.ldK, L.ldK, Wa + (h0 + tx) * L.ldK, L.ldK, Kd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int h = h0 + tx + 8 * j;
          if (h >= H) continue;
          float hv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = acc[i][j], s = 1.f / (1.f + expf(-x));
            hv[i] = x * s;
            sv[i] = s * (1.f + x * (1.f - s));
          }
          *reinterpret_cast<float4*>(Ht + h * L.ldM + m0) = make_float4(hv[0], hv[1], hv[2], hv[3]);
          *reinterpret_cast<float4*>(St + h * L.ldM + m0) = make_float4(sv[0], sv[1], sv[2], sv[3]);
        }
      });
      __syncthreads();
      // lat_env = silu(pre) W1[:, S:]
      leb_chunks(NE, [&](auto tn, int c0) {
        constexpr int TN = decltype(tn)::value;
        const int c = c0 + tx * TN;
        zero_acc(acc);
        mma_cols<TN>(Ht + m0, L.ldM, Wc + c, L.ldE, H, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = E + (m0 + i) * L.ldE + c;
          *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (TN == 8)
            *reinterpret_cast<float4*>(row + 4) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      });
    } else {
      // lat_env = A W0[:, S:]
      leb_chunks(NE, [&](auto tn, int c0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(A + m0 * L.ldK, L.ldK, Wa + (c0 + tx) * L.ldK, L.ldK, Kd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = c0 + tx + 8 * j;
          if (c < NE)
#pragma unroll
            for (int i = 0; i < 4; ++i) E[(m0 + i) * L.ldE + c] = acc[i][j];
        }
      });
    }
    if (L.stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    // the env cotangents, from the tile's t rows (those of atoms past the
    // staged ones from device memory), each thread on kLebIlp independent
    // items at a time. First dsh, one thread per (edge, SH dim): dsh[e, j] =
    // sum_u t[c(e), jU+u] lat_env[e, irr(j)U+u]
    for (int q0 = tid; q0 < kLebRows * d2; q0 += kLebIlp * T) {
      const float* tr[kLebIlp];
      const float* er[kLebIlp];
      int u[kLebIlp];
      bool ok[kLebIlp];
      float acc[kLebIlp];
#pragma unroll
      for (int i = 0; i < kLebIlp; ++i) {
        const int q = q0 + i * T, m = q / d2, j = q - m * d2;
        const int c = q < kLebRows * d2 && e0 + m < n_edges ? Tc[m] : -1;
        int r = 0;
        while (r + 1 < n_irr && j >= s_rng[2 * r + 2]) ++r;
        ok[i] = c >= 0 && c < n_atoms;
        // a thread starts at its own channel, so a warp's reads of rows that
        // are all 32-float aligned fall into distinct banks
        tr[i] = ok[i] ? (c - ca < L.ta ? Tt + (c - ca) * dU : t + c * d2U) + j * U : Tt;
        er[i] = ok[i] ? E + m * L.ldE + r * U : Tt;
        u[i] = ok[i] ? q % U : 0;
        acc[i] = 0.f;
      }
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int i = 0; i < kLebIlp; ++i) {
          if (ok[i]) acc[i] = fmaf(tr[i][u[i]], er[i][u[i]], acc[i]);
          u[i] = u[i] + 1 == U ? 0 : u[i] + 1;
        }
#pragma unroll
      for (int i = 0; i < kLebIlp; ++i) {
        const int q = q0 + i * T, m = q / d2, j = q - m * d2;
        if (q < kLebRows * d2 && e0 + m < n_edges) dsh[(e0 + m) * d2 + j] = acc[i];
      }
    }
    __syncthreads();
    // then dlat_env[e, rU+u] = sum_{j in irrep r} t[c(e), jU+u] sh[e, j],
    // irrep by irrep, one thread per (edge, channel), over lat_env
    for (int r = 0; r < n_irr; ++r) {
      const int j0 = s_rng[2 * r], nj = s_rng[2 * r + 1];
      for (int q0 = tid; q0 < kLebRows * U; q0 += kLebIlp * T) {
        const float* tr[kLebIlp];
        const float* sr[kLebIlp];
        float acc[kLebIlp];
#pragma unroll
        for (int i = 0; i < kLebIlp; ++i) {
          const int q = q0 + i * T, m = q / U, uu = q - m * U;
          const int c = q < kLebRows * U && e0 + m < n_edges ? Tc[m] : -1;
          const bool ok = c >= 0 && c < n_atoms;
          tr[i] = ok ? (c - ca < L.ta ? Tt + (c - ca) * dU : t + c * d2U) + j0 * U + uu : nullptr;
          sr[i] = Sh + m * d2 + j0;
          acc[i] = 0.f;
        }
        for (int j = 0; j < nj; ++j)
#pragma unroll
          for (int i = 0; i < kLebIlp; ++i)
            if (tr[i]) acc[i] = fmaf(tr[i][j * U], sr[i][j], acc[i]);
#pragma unroll
        for (int i = 0; i < kLebIlp; ++i) {
          const int q = q0 + i * T, m = q / U, uu = q - m * U;
          if (q < kLebRows * U) E[m * L.ldE + r * U + uu] = acc[i];
        }
      }
    }
    __syncthreads();

    if (kHidden) {
      // dpre = (dlat W1^T) * silu'(pre), transposed over silu(pre)^T
      leb_chunks(H, [&](auto tn, int h0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(G + m0 * L.ldS, L.ldS, Wb + (h0 + tx) * L.ldS, L.ldS, Sd, acc);
        mma_rows<TN>(E + m0 * L.ldE, L.ldE, Wc + (h0 + tx) * L.ldE, L.ldE, NEd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int h = h0 + tx + 8 * j;
          if (h >= H) continue;
          const float4 sg = *reinterpret_cast<const float4*>(St + h * L.ldM + m0);
          *reinterpret_cast<float4*>(Ht + h * L.ldM + m0) =
              make_float4(acc[0][j] * sg.x, acc[1][j] * sg.y, acc[2][j] * sg.z, acc[3][j] * sg.w);
        }
      });
      __syncthreads();
      // dA = dpre W0^T, into the tile's piece rows (read by nothing since pre)
      leb_chunks(K, [&](auto tn, int k0) {
        constexpr int TN = decltype(tn)::value;
        const int k = k0 + tx * TN;
        zero_acc(acc);
        mma_cols<TN>(Ht + m0, L.ldM, Wa + k, L.ldK, H, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = A + (m0 + i) * L.ldK + k;
          *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (TN == 8)
            *reinterpret_cast<float4*>(row + 4) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      });
    } else {
      // dA = dlat W0^T, into the tile's piece rows
      leb_chunks(K, [&](auto tn, int k0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(G + m0 * L.ldS, L.ldS, Wb + (k0 + tx) * L.ldS, L.ldS, Sd, acc);
        mma_rows<TN>(E + m0 * L.ldE, L.ldE, Wc + (k0 + tx) * L.ldE, L.ldE, NEd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int k = k0 + tx + 8 * j;
#pragma unroll
          for (int i = 0; i < 4; ++i) A[(m0 + i) * L.ldK + k] = acc[i][j];
        }
      });
    }
    __syncthreads();
    // the piece cotangents out, a warp per row, lane = column
    for (int i = 0; i < D.n; ++i)
      for (int m = warp; m < kLebRows && e0 + m < n_edges; m += kLebWarps) {
        float* dst = D.ptr[i] + (e0 + m) * D.stride[i];
        const float* src = A + m * L.ldK + D.off[i];
        for (int k = lane; k < D.dim[i]; k += kWarp) dst[k] = src[k];
      }
    __syncthreads();
    buf ^= 1;
  }
  cp_async_wait<0>();
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
// [E, d1*U] never reach device memory. Design: the CG table is walked by
// path, not by entry. Each path is one block of wigner_3j(l1, l2, l3) *
// sqrt(2 l3 + 1) (times a scale), compiled into cg_blocks.h as straight-line
// FMAs on register arrays; per path a lane loads its three slices (x0, env,
// g times the path weight) once, runs the block, and adds its dx0 and denv
// slices once (EmbedPath). A path with l > 3, which the header does not
// hold, walks its entries one by one (the switch's default case). A
// persistent grid; each block stages the path table, the path weights and
// row_specs once, and each warp takes whole work items: an atom, whose CSR
// segment it walks in edge order with lane = channel u, keeping the atom's
// env and denv rows as its own in shared memory (denv written once per
// atom: no cross-warp sum, no atomics), or a tile of 32 sentinel edges,
// whose dsh and dw2b rows it zeroes. An edge's g, gts, w2b and sh rows come
// into the warp's buffers with cp.async while the warp works on the edge
// before it; gts is added to g's block 0 there, x0 = sh * w2b is staged per
// lane, and dx0 is reduced onto the factors: dw2b[e, irs_i U+u] += dx0
// sh[e, js_i] per lane, and dsh[e, js_i] += sum_u dx0 w2b by one lane per
// SH dim over a padded row.
// Instantiated with and without gts, as bwd_fused.
// ---------------------------------------------------------------------------
constexpr int kDescCols = 8;  // (p, triple id, i0, j0, k0, n0, n1, 0): gen_cg_blocks.path_table

// One path of bwd_embed for one lane, from that lane's buffer columns: x and
// dx have row stride kWarp, g (the edge's row as it is in memory) ldg, e and
// de (the atom's env and denv) ldr.
struct EmbedPath {
  const float* x;
  const float* g;
  const float* e;
  float* dx;
  float* de;
  int ldr, ldg, i0, j0, k0;
  float ws;  // the path weight of the lane's channel times the path's scale

  template <int L1, int L2, int L3>
  __device__ __forceinline__ void run() {
    constexpr int n1 = 2 * L1 + 1, n2 = 2 * L2 + 1, n3 = 2 * L3 + 1;
    float xs[n1], es[n2], gs[n3], dxs[n1], des[n2];
#pragma unroll
    for (int a = 0; a < n1; ++a) {
      xs[a] = x[(i0 + a) * kWarp];
      dxs[a] = 0.f;
    }
#pragma unroll
    for (int b = 0; b < n2; ++b) {
      es[b] = e[(j0 + b) * ldr];
      des[b] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < n3; ++c) gs[c] = ws * g[(k0 + c) * ldg];
    CgBlock<L1, L2, L3>::bwd(xs, es, gs, dxs, des);
#pragma unroll
    for (int a = 0; a < n1; ++a) dx[(i0 + a) * kWarp] += dxs[a];
#pragma unroll
    for (int b = 0; b < n2; ++b) de[(j0 + b) * ldr] += des[b];
  }
};

// Shared memory of bwd_embed, in floats: the block's tables, and one warp's
// buffers: the atom's env and denv rows [d2][Up]; two stages of an edge's
// rows as they are in device memory (g [d3][U], gts [U], w2b [n_irr][U],
// sh [d_sh]); x0 and dx0 [d1] and the w2b cotangent [n_irr], lane-major;
// the dsh partials [d_sh][kTile].
__host__ __device__ inline int embed_fixed_floats(int n_paths, int n_w, int U, int d1) {
  return round_up(n_paths * kDescCols + 2 * d1 + n_paths + n_w * U, 4);
}

__host__ __device__ inline int embed_edge_floats(int U, int d_sh, int n_irr, int d3) {
  return round_up((d3 + 1 + n_irr) * U + d_sh, 4);
}

__host__ __device__ inline int embed_warp_floats(int U, int d_sh, int n_irr, int d1, int d2,
                                                 int d3) {
  return 2 * d2 * round_up(U, kWarp) + 2 * embed_edge_floats(U, d_sh, n_irr, d3) +
         (2 * d1 + n_irr) * kWarp + d_sh * kTile;
}

// Edge e's g, gts, w2b and sh rows into one stage of the warp's buffers.
template <bool kGts>
__device__ __forceinline__ void embed_load_edge(const float* __restrict__ g,
                                                const float* __restrict__ gts,
                                                const float* __restrict__ w2b,
                                                const float* __restrict__ sh, long long e, int U,
                                                int d_sh, int n_irr, int d3, float* buf,
                                                int lane) {
  const int gU = d3 * U, nU = n_irr * U;
  for (int q = lane; q < gU; q += kWarp) cp_async4(buf + q, g + e * gU + q);
  if (kGts)
    for (int q = lane; q < U; q += kWarp) cp_async4(buf + gU + q, gts + e * U + q);
  for (int q = lane; q < nU; q += kWarp) cp_async4(buf + gU + U + q, w2b + e * nU + q);
  for (int q = lane; q < d_sh; q += kWarp) cp_async4(buf + gU + U + nU + q, sh + e * d_sh + q);
  cp_async_commit();
}

template <bool kGts>
__global__ void __launch_bounds__(kSegmentWarps* kWarp) bwd_embed_kernel(
    const float* __restrict__ sh, const float* __restrict__ w2b, const float* __restrict__ g,
    const float* __restrict__ gts, const float* __restrict__ env, const float* __restrict__ w,
    int n_w, const int* __restrict__ row_ptr, const int* __restrict__ desc,
    const float* __restrict__ dscale, int n_paths, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, const int* __restrict__ row_specs, long long n_edges,
    int n_atoms, int d_sh, int n_irr, int d1, int d2, int d3, int U, float* __restrict__ dsh,
    float* __restrict__ dw2b, float* __restrict__ denv) {
  extern __shared__ float smem[];
  const int Up = round_up(U, kWarp);
  int* s_desc = reinterpret_cast<int*>(smem);                       // [n_paths][kDescCols]
  int* s_spec = s_desc + n_paths * kDescCols;                       // [d1][2]
  float* s_scale = reinterpret_cast<float*>(s_spec + 2 * d1);       // [n_paths]
  float* s_w = s_scale + n_paths;                                   // [n_w][U]
  for (int q = threadIdx.x; q < n_paths * kDescCols; q += blockDim.x) s_desc[q] = desc[q];
  for (int q = threadIdx.x; q < 2 * d1; q += blockDim.x) s_spec[q] = row_specs[q];
  for (int q = threadIdx.x; q < n_paths; q += blockDim.x) s_scale[q] = dscale[q];
  for (int q = threadIdx.x; q < n_w * U; q += blockDim.x) s_w[q] = w[q];
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  const int edge_floats = embed_edge_floats(U, d_sh, n_irr, d3);
  float* s_env = smem + embed_fixed_floats(n_paths, n_w, U, d1) +
                 (size_t)warp * embed_warp_floats(U, d_sh, n_irr, d1, d2, d3);
  float* s_den = s_env + d2 * Up;
  float* s_edge = s_den + d2 * Up;      // two stages of edge_floats
  float* s_x = s_edge + 2 * edge_floats;  // the rest: [rows][kWarp], column lane
  float* s_dx = s_x + d1 * kWarp;
  float* s_dwb = s_dx + d1 * kWarp;
  float* s_dsh = s_dwb + n_irr * kWarp;  // [d_sh][kTile]
  const int gU = d3 * U;
  const long long nU = (long long)n_irr * U;
  const long long tail = row_ptr[n_atoms];
  const long long n_items = n_atoms + (n_edges - tail + kWarp - 1) / kWarp;
  for (long long item = (long long)blockIdx.x * wpb + warp; item < n_items;
       item += (long long)gridDim.x * wpb) {
    if (item >= n_atoms) {  // a tile of sentinel edges: zero rows
      const long long e0 = tail + (item - n_atoms) * kWarp, e1 = min(e0 + kWarp, n_edges);
      for (long long q = e0 * d_sh + lane; q < e1 * d_sh; q += kWarp) dsh[q] = 0.f;
      for (long long q = e0 * nU + lane; q < e1 * nU; q += kWarp) dw2b[q] = 0.f;
      continue;
    }
    const long long a = item, start = row_ptr[a], end = row_ptr[a + 1];
    // column j*Up + u of the env and denv rows belongs to lane u % 32
    for (int j = 0; j < d2; ++j)
      for (int u = lane; u < Up; u += kWarp) {
        s_env[j * Up + u] = u < U ? env[(a * d2 + j) * U + u] : 0.f;
        s_den[j * Up + u] = 0.f;
      }
    if (start < end) embed_load_edge<kGts>(g, gts, w2b, sh, start, U, d_sh, n_irr, d3, s_edge, lane);
    int stage = 0;
    for (long long e = start; e < end; ++e) {
      // the next edge's rows load while this one is worked on
      if (e + 1 < end) {
        embed_load_edge<kGts>(g, gts, w2b, sh, e + 1, U, d_sh, n_irr, d3,
                              s_edge + (stage ^ 1) * edge_floats, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float* eg = s_edge + stage * edge_floats;  // g [d3][U], then gts, w2b, sh
      const float* ewb = eg + gU + U;
      const float* esh = ewb + nU;
      if (kGts)
        for (int u = lane; u < U; u += kWarp) eg[u] += eg[gU + u];
      for (int j = 0; j < d_sh; ++j) s_dsh[j * kTile + lane] = 0.f;
      __syncwarp();
      for (int u0 = 0; u0 < U; u0 += kWarp) {
        const int u = u0 + lane;
        const bool act = u < U;
        for (int r = 0; r < n_irr; ++r) s_dwb[r * kWarp + lane] = 0.f;
        for (int i = 0; i < d1; ++i) {
          s_x[i * kWarp + lane] = act ? esh[s_spec[2 * i]] * ewb[s_spec[2 * i + 1] * U + u] : 0.f;
          s_dx[i * kWarp + lane] = 0.f;
        }
        // g is read at row stride U from the lane's column (0 past U)
        EmbedPath f{s_x + lane, eg + (act ? u : 0), s_env + u, s_dx + lane, s_den + u, Up, U,
                    0, 0, 0, 0.f};
        for (int q = 0; q < n_paths; ++q) {
          const int* dq = s_desc + q * kDescCols;
          f.i0 = dq[2];
          f.j0 = dq[3];
          f.k0 = dq[4];
          f.ws = act ? s_w[dq[0] * U + u] * s_scale[q] : 0.f;
          if (!cg_dispatch(dq[1], f)) {  // l > 3: the path's entries one by one
            for (int n = dq[5]; n < dq[6]; ++n) {
              const int i = eidx[4 * n], j = eidx[4 * n + 1], k = eidx[4 * n + 2];
              const float t = ecoef[n] * f.ws * f.g[k * U];
              s_dx[i * kWarp + lane] = fmaf(t, s_env[j * Up + u], s_dx[i * kWarp + lane]);
              s_den[j * Up + u] = fmaf(t, s_x[i * kWarp + lane], s_den[j * Up + u]);
            }
          }
        }
        for (int i = 0; i < d1; ++i) {
          const int js = s_spec[2 * i], r = s_spec[2 * i + 1];
          const float dx = s_dx[i * kWarp + lane];
          if (act) s_dsh[js * kTile + lane] = fmaf(dx, ewb[r * U + u], s_dsh[js * kTile + lane]);
          s_dwb[r * kWarp + lane] = fmaf(dx, esh[js], s_dwb[r * kWarp + lane]);
        }
        if (act)
          for (int r = 0; r < n_irr; ++r) dw2b[e * nU + r * U + u] = s_dwb[r * kWarp + lane];
      }
      // dsh[e, j] = the sum of partial row j, by lane j (rows of kTile: no bank conflicts)
      __syncwarp();
      for (int j0 = 0; j0 < d_sh; j0 += kWarp) {
        const int j = j0 + lane;
        if (j < d_sh) {
          float s = 0.f;
          for (int l = 0; l < kWarp; ++l) s += s_dsh[j * kTile + l];
          dsh[e * d_sh + j] = s;
        }
      }
      __syncwarp();
      stage ^= 1;
    }
    for (int j = 0; j < d2; ++j)
      for (int u = lane; u < U; u += kWarp) denv[(a * d2 + j) * U + u] = s_den[j * Up + u];
  }
}

// Shared memory of latent_env_scatter: the weights, the irrep table, and
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
                          const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
                          int S, int K, int H, int N, float* dsh, cudaStream_t stream) {
  const int n_irr = (N - S) / U;
  // the piece rows double-buffered and kLebTileAtoms t rows staged where
  // shared memory allows; else fewer t rows (at least 2), then a single
  // buffer with as many as fit
  LebLayout L;
  size_t smem = 0;
  bool fits = false;
  for (int stages = 2; stages >= 1 && !fits; --stages)
    for (int ta = kLebTileAtoms; ta >= (stages == 2 ? 2 : 0) && !fits; --ta) {
      L = leb_layout(kHidden, K, H, S, N - S, d2, U, n_irr, stages, ta);
      smem = (size_t)L.total * sizeof(float);
      fits = smem <= smem_optin();
    }
  if (!fits) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = prepare_smem(latent_env_bwd_kernel<kHidden>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(latent_env_bwd_kernel<kHidden>, kLebThreads, smem,
                                       (n_edges + kLebRows - 1) / kLebRows, 1);
  latent_env_bwd_kernel<kHidden><<<blocks, kLebThreads, smem, stream>>>(
      P, D, w0, w1, sh, t, g_lat, centers, irr_ranges, n_edges, n_atoms, d2, n_irr, U, S, K, H, N,
      L, dsh);
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
                        const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
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
    return launch_latent_env_bwd<true>(P, D, w0, w1, sh, t, g_lat, centers, irr_ranges, n_edges,
                                       n_atoms, d2, U, S, K, H, N, dsh, (cudaStream_t)stream);
  return launch_latent_env_bwd<false>(P, D, w0, w1, sh, t, g_lat, centers, irr_ranges, n_edges,
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
                   const float* env, const float* w, int n_w, const int* row_ptr,
                   const int* desc, const float* dscale, int n_paths, const int* eidx,
                   const float* ecoef, const int* row_specs, long long n_edges, int n_atoms,
                   int d_sh, int n_irr, int d1, int d2, int d3, int U, float* dsh, float* dw2b,
                   float* denv, void* stream) {
  const size_t fixed = (size_t)embed_fixed_floats(n_paths, n_w, U, d1) * sizeof(float);
  const size_t per_warp = (size_t)embed_warp_floats(U, d_sh, n_irr, d1, d2, d3) * sizeof(float);
  size_t smem = 0;
  const int warps = fit_warps(fixed, per_warp, kSegmentWarps, &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  const long long items = n_atoms + (n_edges + kWarp - 1) / kWarp;
  if (gts) {
    cudaError_t err = prepare_smem(bwd_embed_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = persistent_blocks(bwd_embed_kernel<true>, warps * kWarp, smem, items, warps);
    bwd_embed_kernel<true><<<blocks, warps * kWarp, smem, (cudaStream_t)stream>>>(
        sh, w2b, g, gts, env, w, n_w, row_ptr, desc, dscale, n_paths, eidx, ecoef, row_specs,
        n_edges, n_atoms, d_sh, n_irr, d1, d2, d3, U, dsh, dw2b, denv);
  } else {
    cudaError_t err = prepare_smem(bwd_embed_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks =
        persistent_blocks(bwd_embed_kernel<false>, warps * kWarp, smem, items, warps);
    bwd_embed_kernel<false><<<blocks, warps * kWarp, smem, (cudaStream_t)stream>>>(
        sh, w2b, g, gts, env, w, n_w, row_ptr, desc, dscale, n_paths, eidx, ecoef, row_specs,
        n_edges, n_atoms, d_sh, n_irr, d1, d2, d3, U, dsh, dw2b, denv);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
