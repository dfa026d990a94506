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
// The two embed kernels walk the CG table by path, each path a block of
// cg_blocks.h (CgBlock::fwd and CgBlock::bwd).
//
// Layout (the JAX package's contract): per-edge arrays are row-major with the
// flat dim-major tensor track; edges are sorted by center, row_ptr[a] is the
// first edge of atom a, and padded edges carry the sentinel center n_atoms
// after row_ptr[n_atoms]: they add nothing to any per-atom sum and read zeros
// from per-atom arrays. `(js_i, irs_i)` (`row_specs`) is the SH dim and irrep
// of row i of layer 0's input, after the irreps ladder's pruning.
//
// The MLPs run in exact FP32 FMAs (no TF32, no tensor cores: precision
// "highest"); latent_env_scatter's two products and latent_env_bwd's four
// are register-tiled GEMMs on tiles of 64 edges. Every per-atom sum runs in
// edge order (no atomics), so results are deterministic. Each kernel runs on
// the caller's stream and allocates nothing; each entry point returns
// cudaGetLastError().

#include "common.cu"
#include "cg_blocks.h"

namespace {

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
// micro-tiles (4 x 4 on a last chunk of 32 columns; common.cu's mma_rows
// and mma_cols): thread row group ty
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
constexpr int kLebCols = kMmaCols;  // columns per pass: 8 column groups of 8
constexpr int kLebThreads = 128;  // (kLebRows / 4) x (kLebCols / 8)
constexpr int kLebIlp = 4;        // env-step items a thread works on at once
constexpr int kLebTileAtoms = 6;  // t rows a tile stages (it spans ~3 atoms at ~25 edges each)

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
  L.ldK = tile_ld(K);
  L.ldS = tile_ld(S);
  L.ldE = tile_ld(NE);
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

// The dtype flags of the latent kernels (their bf16_wexp argument): bit 0
// rounds the env weights to bf16 (the bf16 track), bit 1 (kShBf16) reads sh
// as __nv_bfloat16, and bit kPiecesShift + i reads piece i as
// __nv_bfloat16 (a bfloat16 model's: both widened to float as they are
// staged; the weights arrive widened, and every output is float).
constexpr int kShBf16 = 2, kPiecesShift = 8;

// The same rows of a bf16 array (a bfloat16 model's sh), widened by plain
// loads (the caller's cp_async_wait and __syncthreads cover them).
__device__ __forceinline__ void leb_load_rows(const __nv_bfloat16* src, long long stride,
                                              int width, long long e0, long long n_edges,
                                              float* dst, int ld) {
  const int lane = threadIdx.x % kWarp;
  for (int m = threadIdx.x / kWarp; m < kLebRows && e0 + m < n_edges; m += kLebWarps)
    for (int k = lane; k < width; k += kWarp)
      dst[m * ld + k] = __bfloat162float(src[(e0 + m) * stride + k]);
}

template <bool kHidden>
__global__ void __launch_bounds__(kLebThreads) latent_env_bwd_kernel(
    Pieces P, OutPieces D, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ sh, const float* __restrict__ t, const float* __restrict__ g_lat,
    const int* __restrict__ centers, const int* __restrict__ irr_ranges, long long n_edges,
    int n_atoms, int d2, int n_irr, int U, int S, int K, int H, int N, LebLayout L,
    int round_wexp, float* __restrict__ dsh) {
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
    load_piece_rows<kLebRows, kLebThreads>(P, (long long)blockIdx.x * kLebRows, n_edges, A0,
                                           L.ldK, tid);
  cp_async_commit();
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long e0 = tile * kLebRows;
    float* A = A0 + (L.stages == 2 ? buf * a_floats : 0);
    if (L.stages == 1) {
      load_piece_rows<kLebRows, kLebThreads>(P, e0, n_edges, A, L.ldK, tid);
      cp_async_commit();
    }
    leb_load_rows(g_lat, S, S, e0, n_edges, G, L.ldS);
    if (round_wexp & kShBf16)
      leb_load_rows(reinterpret_cast<const __nv_bfloat16*>(sh), d2, d2, e0, n_edges, Sh, d2);
    else
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
        load_piece_rows<kLebRows, kLebThreads>(P, next * kLebRows, n_edges,
                                               A0 + (buf ^ 1) * a_floats, L.ldK, tid);
      cp_async_commit();
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    if (kHidden) {
      // pre = A W0, leaving the registers as silu(pre)^T and silu'(pre)^T
      col_chunks(H, [&](auto tn, int h0) {
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
      // lat_env = silu(pre) W1[:, S:] (on the bf16 track rounded to bf16,
      // as the forward weighted sh with it: it is read by dsh alone)
      col_chunks(NE, [&](auto tn, int c0) {
        constexpr int TN = decltype(tn)::value;
        const int c = c0 + tx * 4;
        zero_acc(acc);
        mma_cols<TN>(Ht + m0, L.ldM, Wc + c, L.ldE, H, acc);
        if (round_wexp & 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = bf16_round(acc[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = E + (m0 + i) * L.ldE + c;
          *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (TN == 8)
            *reinterpret_cast<float4*>(row + 32) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      });
    } else {
      // lat_env = A W0[:, S:]
      col_chunks(NE, [&](auto tn, int c0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(A + m0 * L.ldK, L.ldK, Wa + (c0 + tx) * L.ldK, L.ldK, Kd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = c0 + tx + 8 * j;
          if (c < NE)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              E[(m0 + i) * L.ldE + c] = (round_wexp & 1) ? bf16_round(acc[i][j]) : acc[i][j];
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
      col_chunks(H, [&](auto tn, int h0) {
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
      col_chunks(K, [&](auto tn, int k0) {
        constexpr int TN = decltype(tn)::value;
        const int k = k0 + tx * 4;
        zero_acc(acc);
        mma_cols<TN>(Ht + m0, L.ldM, Wa + k, L.ldK, H, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = A + (m0 + i) * L.ldK + k;
          *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (TN == 8)
            *reinterpret_cast<float4*>(row + 32) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      });
    } else {
      // dA = dlat W0^T, into the tile's piece rows
      col_chunks(K, [&](auto tn, int k0) {
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
// latent_env_scatter
// Replaces allegro_tpu/ops/fused_tp.py:_latent_env_scatter_kernel
// (latent_env_scatter_call). Bound: exact-FP32 FMAs, K*H + H*N per edge with
// a hidden layer (16,384 for the flagship's layer-0 latent: K = 96, H = 64,
// N = 160), K*N without; the device-memory traffic is only the pieces, sh,
// lat_s and env, because the hidden activation and the env weights
// lat[:, S:] never leave the SM, as on the TPU. Design: latent_env_bwd's
// register-tiled GEMM chain run forwards, on its helpers, on tiles of
// kLebRows edges that ignore atom boundaries, so no thread idles at a
// segment's end:
//   pre = A W0            (rows of A against rows of W0^T, 4 x 8 micro-tiles)
//   lat = silu(pre) W1    (columns of silu(pre)^T against rows of W1)
// or lat = A W0 without a hidden layer. A block stages the weights once,
// zero-padded, and runs kLesGroups groups of kLebThreads threads (as shared
// memory allows), each walking its own tiles with its own buffers and named
// barrier, so that one group's loads and syncs overlap the other's math. A
// tile's piece rows come in by cp.async (16 bytes a copy where aligned),
// double-buffered where shared memory allows; with a hidden layer the lat
// tile takes the place of the piece rows once pre is formed. Each piece row
// is read once and SiLU applied once per element, when pre leaves the
// registers. The lat tile stays in shared memory: its first S columns leave
// as coalesced lat_s rows, and its env columns are weighted by the tile's sh
// rows (also staged) and summed over each atom's edges in the tile, in edge
// order, by one thread per (atom, up to 4 SH dims j of one irrep, 4 channels
// u), 16 independent sums; the irreps' dims come from the per-irrep (start,
// len) table, cut into chunks of 4: no branch over all d2 dims, no sh read
// from device memory inside an FMA chain.
// Across tiles every env row is still summed in one fixed order, in one
// launch, by aligning to segments at the level of the walker rather than the
// tile (the first of the two designs that keep one order; the second,
// partial rows combined by another pass, costs a launch and a scratch
// array): walker w (a group of a block) owns the atoms whose segments start
// in its share [w, w+1) * ceil(E / n_walkers) of the edges, found by binary
// search in row_ptr (no host statics), and walks their edges in consecutive
// tiles. An atom that runs past a tile's end leaves its partial env row in
// the walker's shared memory (two buffers, by tile parity) and the next tile
// starts its sum from there. Only a walker's last tile can be ragged.
// Sentinel edges (after row_ptr[n_atoms]) are shared out the same way and
// get lat_s and no env; atoms without edges get a zero env row from their
// walker. Every sum runs in a fixed order: no atomics.
// ---------------------------------------------------------------------------
constexpr int kLesGroups = 2;  // tile walkers per block
static_assert(kLebRows == 2 * kWarp && kLebThreads >= kLebRows,
              "latent_env_scatter finds a tile's atoms with the ballots of two warps");

// Shared-memory layout of latent_env_scatter, offsets in floats (multiples
// of 4): the block's weights and tables, then `groups` copies of a group's
// buffers (offsets within them).
struct LesLayout {
  int ldK, ldN, ldM;   // strides of K- and N-wide rows and of kLebRows-wide rows
  int w0, w1, irr, jc; // W0^T [round_up(H or N, 32)][ldK]; W1 [round_up(H, 4)][ldN];
                       // the per-irrep (start, len) table; the SH-dim chunks
  int group, per_group;
  int a, lat, ht, sh, run, carry;  // pieces (stages of [kLebRows][ldK]); lat [kLebRows][ldN]
                       // (over the pieces with a hidden layer); silu(pre)^T; sh; the
                       // tile's atom runs (starts, atoms, count, flags, ballots); two
                       // carried env rows
  int stages, groups, total;
};

__host__ __device__ inline LesLayout les_layout(bool hidden, int K, int H, int N, int d2, int U,
                                                int n_irr, int stages, int groups) {
  LesLayout L;
  L.ldK = tile_ld(K);
  L.ldN = tile_ld(N);
  L.ldM = kLebRows + 4;
  int o = 0;
  L.w0 = o;
  o += round_up(hidden ? H : N, kWarp) * L.ldK;
  L.w1 = o;
  o += hidden ? round_up(H, 4) * L.ldN : 0;
  L.irr = o;
  o += round_up(2 * n_irr, 4);
  L.jc = o;
  o += round_up(3 * d2 + 1, 4);
  L.group = o;
  const int a_floats = stages * kLebRows * L.ldK, lat_floats = kLebRows * L.ldN;
  int g = 0;
  L.a = g;
  L.lat = hidden ? g : g + a_floats;
  g += hidden ? (a_floats > lat_floats ? a_floats : lat_floats) : a_floats + lat_floats;
  L.ht = g;
  g += hidden ? round_up(H, 4) * L.ldM : 0;
  L.sh = g;
  g += round_up(kLebRows * d2, 4);
  L.run = g;
  g += round_up(2 * kLebRows + 8, 4);
  L.carry = g;
  g += 2 * round_up(d2 * U, 4);
  L.per_group = g;
  L.stages = stages;
  L.groups = groups;
  L.total = o + groups * g;
  return L;
}

// The first atom whose segment starts at edge e or later (n_atoms if none).
__device__ __forceinline__ int first_atom_at(const int* __restrict__ row_ptr, int n_atoms,
                                             long long e) {
  int lo = 0, hi = n_atoms;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_ptr[mid] >= e) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// The barrier of one group of kLebThreads threads (named barrier 1 + group).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kLebThreads) : "memory");
}

template <bool kHidden>
__global__ void __launch_bounds__(kLesGroups* kLebThreads, 1) latent_env_scatter_kernel(
    Pieces P, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ sh, const int* __restrict__ centers,
    const int* __restrict__ row_ptr, const int* __restrict__ irr_ranges, long long n_edges,
    int n_atoms, int d2, int n_irr, int U, int S, int K, int H, int N, LesLayout L,
    int round_wexp, float* __restrict__ lat_s, float* __restrict__ env) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* W0t = smem + L.w0;
  float* W1 = smem + L.w1;
  int* s_rng = reinterpret_cast<int*>(smem + L.irr);  // [n_irr][2] (start, len)
  int* s_jc = reinterpret_cast<int*>(smem + L.jc);    // [n_jc][3] (first dim, dims, irrep); n_jc
  // the weights, zero-padded, once per block
  const int Hn = kHidden ? H : N;  // the columns of W0
  for (int q = threadIdx.x; q < round_up(Hn, kWarp) * L.ldK; q += T) {
    const int h = q / L.ldK, k = q - h * L.ldK;
    W0t[q] = (h < Hn && k < K) ? w0[(long long)k * Hn + h] : 0.f;
  }
  if (kHidden)
    for (int q = threadIdx.x; q < round_up(H, 4) * L.ldN; q += T) {
      const int h = q / L.ldN, n = q - h * L.ldN;
      W1[q] = (h < H && n < N) ? w1[(long long)h * N + n] : 0.f;
    }
  for (int q = L.group + threadIdx.x; q < L.total; q += T) smem[q] = 0.f;  // padding stays zero
  for (int q = threadIdx.x; q < 2 * n_irr; q += T) s_rng[q] = irr_ranges[q];
  if (threadIdx.x == 0) {  // each irrep's dims in chunks of up to 4
    int n = 0;
    for (int g = 0; g < n_irr; ++g) {
      const int j0 = irr_ranges[2 * g], j1 = j0 + irr_ranges[2 * g + 1];
      for (int j = j0; j < j1; j += 4, ++n) {
        s_jc[3 * n] = j;
        s_jc[3 * n + 1] = min(4, j1 - j);
        s_jc[3 * n + 2] = g;
      }
    }
    s_jc[3 * d2] = n;
  }
  __syncthreads();

  const int group = threadIdx.x / kLebThreads, gtid = threadIdx.x % kLebThreads;
  const int ty = gtid / 8, tx = gtid % 8, m0 = ty * 4;
  const int warp = gtid / kWarp, lane = gtid % kWarp;
  float* G = smem + L.group + group * L.per_group;
  float* A0 = G + L.a;
  float* Lat = G + L.lat;
  float* Ht = G + L.ht;
  float* Sh = G + L.sh;
  int* run_start = reinterpret_cast<int*>(G + L.run);  // [kLebRows + 1]
  int* run_atom = run_start + kLebRows + 1;             // [kLebRows]
  int* meta = run_atom + kLebRows;  // run count, carried in, carried out; two ballots
  const int n_jc = s_jc[3 * d2];
  const long long d2U = (long long)d2 * U;
  const int dU = round_up(d2 * U, 4);

  // the walker's atoms [a0, a1) with their edges [r0, r1), and its sentinel
  // edges [z0, z1)
  const long long nw = (long long)gridDim.x * L.groups;
  const long long w = (long long)blockIdx.x * L.groups + group;
  const long long chunk = (n_edges + nw - 1) / nw;
  const long long s0 = min(w * chunk, n_edges);
  const long long s1 = w + 1 == nw ? n_edges : min(s0 + chunk, n_edges);
  const int a0 = first_atom_at(row_ptr, n_atoms, s0);
  const int a1 = w + 1 == nw ? n_atoms : first_atom_at(row_ptr, n_atoms, s1);
  const long long r0 = row_ptr[a0], r1 = row_ptr[a1], tail = row_ptr[n_atoms];
  const long long z0 = max(tail, s0), z1 = max(tail, s1);
  const int n_env_tiles = (int)((r1 - r0 + kLebRows - 1) / kLebRows);
  const int n_tiles = n_env_tiles + (int)((z1 - z0 + kLebRows - 1) / kLebRows);
  for (int a = a0 + warp; a < a1; a += kLebWarps)  // atoms without edges: zero rows
    if (row_ptr[a] == row_ptr[a + 1])
      for (int c = lane; c < d2U; c += kWarp) env[a * d2U + c] = 0.f;

  const int a_floats = kLebRows * L.ldK;
  const int Kd = round_up(K, 4);
  // tile k of the walker: its first edge and the end of its range
  auto tile_at = [&](int k, long long& e0, long long& end) {
    if (k < n_env_tiles) {
      e0 = r0 + (long long)k * kLebRows;
      end = r1;
    } else {
      e0 = z0 + (long long)(k - n_env_tiles) * kLebRows;
      end = z1;
    }
  };
  float acc[4][8];
  int buf = 0, cur = 0;
  if (L.stages == 2 && n_tiles > 0) {
    long long e0, end;
    tile_at(0, e0, end);
    load_piece_rows<kLebRows, kLebThreads>(P, e0, end, A0, L.ldK, gtid);
  }
  cp_async_commit();
  for (int k = 0; k < n_tiles; ++k) {
    long long e0, end;
    tile_at(k, e0, end);
    const bool has_env = k < n_env_tiles;
    const int rows = (int)min((long long)kLebRows, end - e0);
    float* A = A0 + (L.stages == 2 ? buf * a_floats : 0);
    if (L.stages == 1) {
      load_piece_rows<kLebRows, kLebThreads>(P, e0, end, A, L.ldK, gtid);
      if (kHidden && Kd > K)  // the lat tile of the tile before wrote over the padding
        for (int q = gtid; q < kLebRows * (Kd - K); q += kLebThreads)
          A[(q / (Kd - K)) * L.ldK + K + q % (Kd - K)] = 0.f;
      cp_async_commit();
    }
    // the tile's centers, read now and used after the products: one edge a
    // thread of the group's first two warps; thread 0 also reads whether the
    // first atom began before the tile and whether the last runs past it
    int center = -1, before = -1;
    bool carried = false, carries = false;
    if (has_env) {
      if (round_wexp & kShBf16) {
        const auto* shb = reinterpret_cast<const __nv_bfloat16*>(sh) + e0 * d2;
        for (int q = gtid; q < rows * d2; q += kLebThreads) Sh[q] = __bfloat162float(shb[q]);
      } else {
        for (int q = gtid; q < rows * d2; q += kLebThreads) cp_async4(Sh + q, sh + e0 * d2 + q);
      }
      if (gtid < rows) {
        center = centers[e0 + gtid];
        before = gtid > 0 ? centers[e0 + gtid - 1] : -1;
      }
      if (gtid == 0) {
        carried = row_ptr[centers[e0]] < e0;
        carries = row_ptr[centers[e0 + rows - 1] + 1] > e0 + rows;
      }
    }
    cp_async_commit();
    if (L.stages == 2) {
      if (k + 1 < n_tiles) {
        long long n0, nend;
        tile_at(k + 1, n0, nend);
        load_piece_rows<kLebRows, kLebThreads>(P, n0, nend, A0 + (buf ^ 1) * a_floats, L.ldK,
                                               gtid);
      }
      cp_async_commit();
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    group_sync(group);

    if (kHidden) {
      // pre = A W0, leaving the registers as silu(pre)^T
      col_chunks(H, [&](auto tn, int h0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(A + m0 * L.ldK, L.ldK, W0t + (h0 + tx) * L.ldK, L.ldK, Kd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int h = h0 + tx + 8 * j;
          if (h < H)
            *reinterpret_cast<float4*>(Ht + h * L.ldM + m0) =
                make_float4(silu(acc[0][j]), silu(acc[1][j]), silu(acc[2][j]), silu(acc[3][j]));
        }
      });
      group_sync(group);
      // lat = silu(pre) W1, over the piece rows
      col_chunks(N, [&](auto tn, int c0) {
        constexpr int TN = decltype(tn)::value;
        const int c = c0 + tx * 4;
        zero_acc(acc);
        mma_cols<TN>(Ht + m0, L.ldM, W1 + c, L.ldN, H, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = Lat + (m0 + i) * L.ldN + c;
          *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (TN == 8)
            *reinterpret_cast<float4*>(row + 32) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      });
    } else {
      // lat = A W0
      col_chunks(N, [&](auto tn, int c0) {
        constexpr int TN = decltype(tn)::value;
        zero_acc(acc);
        mma_rows<TN>(A + m0 * L.ldK, L.ldK, W0t + (c0 + tx) * L.ldK, L.ldK, Kd, acc);
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) Lat[(m0 + i) * L.ldN + c0 + tx + 8 * j] = acc[i][j];
      });
    }
    if (L.stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    // the tile's atom runs: a run starts where the center changes
    const bool starts = center >= 0 && center != before;
    if (has_env && gtid < kLebRows) {
      const unsigned b = __ballot_sync(0xffffffffu, starts);
      if (lane == 0) meta[3 + warp] = (int)b;
    }
    group_sync(group);

    // lat_s out, a warp per row, lane = column
    for (int m = warp; m < rows; m += kLebWarps)
      for (int c = lane; c < S; c += kWarp) lat_s[(e0 + m) * S + c] = Lat[m * L.ldN + c];
    if (has_env) {
      if (gtid < kLebRows) {
        const unsigned b0 = (unsigned)meta[3], b1 = (unsigned)meta[4];
        const unsigned below = (1u << lane) - 1u;
        if (starts) {
          const int r = warp == 0 ? __popc(b0 & below) : __popc(b0) + __popc(b1 & below);
          run_start[r] = gtid;
          run_atom[r] = center;
        }
        if (gtid == 0) {
          const int n_runs = __popc(b0) + __popc(b1);
          run_start[n_runs] = rows;
          meta[0] = n_runs;
          meta[1] = carried;
          meta[2] = carries;
        }
      }
      group_sync(group);
      // env[a, jU+u] = carried + sum over the atom's edges in the tile, in
      // edge order, of sh[e, j] lat[e, S + irr(j)U + u]: a thread per (run,
      // chunk of up to 4 dims j of one irrep, 4 channels u)
      const int n_runs = meta[0];
      const bool in = meta[1], out = meta[2];
      const float* cin = G + L.carry + cur * dU;
      float* cout = G + L.carry + (cur ^ 1) * dU;
      const int n_u4 = (U + 3) / 4, per_run = n_jc * n_u4;
      for (int q = gtid; q < n_runs * per_run; q += kLebThreads) {
        const int r = q / per_run, rest = q - r * per_run, c = rest / n_u4;
        const int u0 = 4 * (rest - c * n_u4);
        const int j0 = s_jc[3 * c], nj = s_jc[3 * c + 1], g = s_jc[3 * c + 2];
        const int ms = run_start[r], me = run_start[r + 1];
        const bool from_carry = r == 0 && in;
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            s[a][b] = from_carry && a < nj && u0 + b < U ? cin[(j0 + a) * U + u0 + b] : 0.f;
        // the lat row's four columns (past U: the row's next columns, never
        // written out) and up to four sh values of the edge
        const float* lp = Lat + ms * L.ldN + S + g * U + u0;
        const float* sp = Sh + ms * d2 + j0;
        for (int m = ms; m < me; ++m, lp += L.ldN, sp += d2) {
          float lv[4], sv[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) lv[b] = (round_wexp & 1) ? bf16_round(lp[b]) : lp[b];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = a < nj ? sp[a] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = fmaf(sv[a], lv[b], s[a][b]);
        }
        float* dst = r == n_runs - 1 && out ? cout : env + run_atom[r] * d2U;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (a < nj && u0 + b < U) dst[(j0 + a) * U + u0 + b] = s[a][b];
      }
      cur ^= 1;
    }
    group_sync(group);
    buf ^= 1;
  }
  cp_async_wait<0>();
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

// g's row of edge e into buf: by cp.async from float, widened by plain
// loads from the bf16 track (the same float buffer either way).
__device__ __forceinline__ void embed_load_g(const float* __restrict__ g, long long e, int gU,
                                             float* buf, int lane) {
  for (int q = lane; q < gU; q += kWarp) cp_async4(buf + q, g + e * gU + q);
}

__device__ __forceinline__ void embed_load_g(const __nv_bfloat16* __restrict__ g, long long e,
                                             int gU, float* buf, int lane) {
  for (int q = lane; q < gU; q += kWarp) buf[q] = load_f(g + e * gU + q);
}

// The embeds' dtype flags (their bf16 argument): bit 0 their bf16-track form
// (gather_tp_embed's out, bwd_embed's g), and a bfloat16 model's per-edge
// operands (JAX's param dtype): kEmbedSh sh, kEmbedW2b w2b, kEmbedTs
// gather_tp_embed's ts and bwd_embed's gts, each __nv_bfloat16 where set.
constexpr int kEmbedSh = 2, kEmbedW2b = 4, kEmbedTs = 8;

// n elements of a row from element off of src into buf, by cp.async from
// float, widened by plain loads where src holds __nv_bfloat16 (bf16).
__device__ __forceinline__ void embed_load_row(const float* __restrict__ src, long long off,
                                               bool bf16, int n, float* buf, int lane) {
  if (bf16) {
    const auto* b = reinterpret_cast<const __nv_bfloat16*>(src) + off;
    for (int q = lane; q < n; q += kWarp) buf[q] = __bfloat162float(b[q]);
  } else {
    for (int q = lane; q < n; q += kWarp) cp_async4(buf + q, src + off + q);
  }
}

// Edge e's g, gts, w2b and sh rows into one stage of the warp's buffers.
template <bool kGts, typename Tg>
__device__ __forceinline__ void embed_load_edge(const Tg* __restrict__ g,
                                                const float* __restrict__ gts,
                                                const float* __restrict__ w2b,
                                                const float* __restrict__ sh, long long e, int U,
                                                int d_sh, int n_irr, int d3, float* buf,
                                                int lane, int flags) {
  const int gU = d3 * U, nU = n_irr * U;
  embed_load_g(g, e, gU, buf, lane);
  if (kGts) embed_load_row(gts, e * U, flags & kEmbedTs, U, buf + gU, lane);
  embed_load_row(w2b, e * nU, flags & kEmbedW2b, nU, buf + gU + U, lane);
  embed_load_row(sh, e * d_sh, flags & kEmbedSh, d_sh, buf + gU + U + nU, lane);
  cp_async_commit();
}

template <bool kGts, typename Tg>
__global__ void __launch_bounds__(kSegmentWarps* kWarp) bwd_embed_kernel(
    const float* __restrict__ sh, const float* __restrict__ w2b, const Tg* __restrict__ g,
    const float* __restrict__ gts, const float* __restrict__ env, const float* __restrict__ w,
    int n_w, const int* __restrict__ row_ptr, const int* __restrict__ desc,
    const float* __restrict__ dscale, int n_paths, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, const int* __restrict__ row_specs, long long n_edges,
    int n_atoms, int d_sh, int n_irr, int d1, int d2, int d3, int U, float* __restrict__ dsh,
    float* __restrict__ dw2b, float* __restrict__ denv, int flags) {
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
    if (start < end)
      embed_load_edge<kGts>(g, gts, w2b, sh, start, U, d_sh, n_irr, d3, s_edge, lane, flags);
    int stage = 0;
    for (long long e = start; e < end; ++e) {
      // the next edge's rows load while this one is worked on
      if (e + 1 < end) {
        embed_load_edge<kGts>(g, gts, w2b, sh, e + 1, U, d_sh, n_irr, d3,
                              s_edge + (stage ^ 1) * edge_floats, lane, flags);
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

// ---------------------------------------------------------------------------
// gather_tp_embed
// Replaces allegro_tpu/ops/fused_tp.py:_gather_tp_embed_raw_kernel
// (gather_tp_embed_raw_call). Bound: the writes of out [E, d3*U] and ts
// [E, U]; the reads are sh [E, d_sh] and w2b [E, n_irr*U], 3x fewer bytes
// than the [E, d1*U] layer-0 features, which never exist. Design: bwd_embed's
// walk, forwards. The CG table is walked by path, not by entry: each path of
// l <= 3 is one block of cg_blocks.h (CgBlock::fwd), straight-line FMAs on
// register arrays; per path a lane loads its x0 slice (times the path weight
// and the path's scale) and env slice once, runs the block and adds its out
// slice once into a lane-major buffer (GatherPath). A path with l > 3 walks
// its entries one by one (the switch's default case). A persistent grid;
// each block stages the path table, the path weights and row_specs once, and
// each warp takes whole work items: an atom, whose CSR segment it walks in
// edge order with lane = channel u, with the atom's env row staged in shared
// memory once (not read again for each of its ~25 edges), or a tile of 32
// sentinel edges, whose out and ts rows it zeroes. An edge's sh and w2b rows
// come into the warp's buffers by cp.async while the warp works on the edge
// before it; each lane builds its x0 column once per edge, and the out row
// and ts leave once per edge, coalesced.
// ---------------------------------------------------------------------------

// One path of gather_tp_embed for one lane: x (the lane's x0 column) and o
// (its output column) have row stride kWarp, e (the atom's env row at the
// lane's channel) ldr.
struct GatherPath {
  const float* x;
  const float* e;
  float* o;
  int ldr, i0, j0, k0;
  float ws;  // the path weight of the lane's channel times the path's scale

  template <int L1, int L2, int L3>
  __device__ __forceinline__ void run() {
    constexpr int n1 = 2 * L1 + 1, n2 = 2 * L2 + 1, n3 = 2 * L3 + 1;
    float xs[n1], es[n2], os[n3];
#pragma unroll
    for (int a = 0; a < n1; ++a) xs[a] = ws * x[(i0 + a) * kWarp];
#pragma unroll
    for (int b = 0; b < n2; ++b) es[b] = e[(j0 + b) * ldr];
#pragma unroll
    for (int c = 0; c < n3; ++c) os[c] = 0.f;
    CgBlock<L1, L2, L3>::fwd(xs, es, os);
#pragma unroll
    for (int c = 0; c < n3; ++c) o[(k0 + c) * kWarp] += os[c];
  }
};

// Shared memory of gather_tp_embed, in floats: the block's tables
// (embed_fixed_floats), and one warp's buffers: the atom's env row [d2][Up];
// two stages of an edge's w2b [n_irr][U] and sh [d_sh] rows; x0 [d1] and the
// output [d3], lane-major.
__host__ __device__ inline int gather_embed_edge_floats(int U, int d_sh, int n_irr) {
  return round_up(n_irr * U + d_sh, 4);
}

__host__ __device__ inline int gather_embed_warp_floats(int U, int d_sh, int n_irr, int d1, int d2,
                                                        int d3) {
  return d2 * round_up(U, kWarp) + 2 * gather_embed_edge_floats(U, d_sh, n_irr) +
         (d1 + d3) * kWarp;
}

// ts's element q: float, or __nv_bfloat16 (a bfloat16 model's) rounded once.
__device__ __forceinline__ void store_ts(float* ts, long long q, float v, int flags) {
  if (flags & kEmbedTs)
    store_f(reinterpret_cast<__nv_bfloat16*>(ts) + q, v);
  else
    ts[q] = v;
}

template <typename To>
__global__ void __launch_bounds__(kSegmentWarps* kWarp) gather_tp_embed_kernel(
    const float* __restrict__ sh, const float* __restrict__ w2b, const float* __restrict__ env,
    const float* __restrict__ w, int n_w, const int* __restrict__ row_ptr,
    const int* __restrict__ desc, const float* __restrict__ dscale, int n_paths,
    const int* __restrict__ eidx, const float* __restrict__ ecoef,
    const int* __restrict__ row_specs, long long n_edges, int n_atoms, int d_sh, int n_irr,
    int d1, int d2, int d3, int U, To* __restrict__ out, float* __restrict__ ts, int flags) {
  extern __shared__ float smem[];
  const int Up = round_up(U, kWarp);
  int* s_desc = reinterpret_cast<int*>(smem);                  // [n_paths][kDescCols]
  int* s_spec = s_desc + n_paths * kDescCols;                  // [d1][2]
  float* s_scale = reinterpret_cast<float*>(s_spec + 2 * d1);  // [n_paths]
  float* s_w = s_scale + n_paths;                              // [n_w][U]
  for (int q = threadIdx.x; q < n_paths * kDescCols; q += blockDim.x) s_desc[q] = desc[q];
  for (int q = threadIdx.x; q < 2 * d1; q += blockDim.x) s_spec[q] = row_specs[q];
  for (int q = threadIdx.x; q < n_paths; q += blockDim.x) s_scale[q] = dscale[q];
  for (int q = threadIdx.x; q < n_w * U; q += blockDim.x) s_w[q] = w[q];
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  const int edge_floats = gather_embed_edge_floats(U, d_sh, n_irr);
  float* s_env = smem + embed_fixed_floats(n_paths, n_w, U, d1) +
                 (size_t)warp * gather_embed_warp_floats(U, d_sh, n_irr, d1, d2, d3);
  float* s_edge = s_env + d2 * Up;        // two stages of edge_floats: w2b, then sh
  float* s_x = s_edge + 2 * edge_floats;  // [d1][kWarp], column lane
  float* s_o = s_x + d1 * kWarp;          // [d3][kWarp]
  const long long nU = (long long)n_irr * U, oU = (long long)d3 * U;
  const long long tail = row_ptr[n_atoms];
  const long long n_items = n_atoms + (n_edges - tail + kWarp - 1) / kWarp;
  for (long long item = (long long)blockIdx.x * wpb + warp; item < n_items;
       item += (long long)gridDim.x * wpb) {
    if (item >= n_atoms) {  // a tile of sentinel edges: zero rows
      const long long e0 = tail + (item - n_atoms) * kWarp, e1 = min(e0 + kWarp, n_edges);
      for (long long q = e0 * oU + lane; q < e1 * oU; q += kWarp) store_f(out + q, 0.f);
      if (ts)
        for (long long q = e0 * U + lane; q < e1 * U; q += kWarp) store_ts(ts, q, 0.f, flags);
      continue;
    }
    const long long a = item, start = row_ptr[a], end = row_ptr[a + 1];
    // column j*Up + u of the env row belongs to lane u % 32
    for (int j = 0; j < d2; ++j)
      for (int u = lane; u < Up; u += kWarp)
        s_env[j * Up + u] = u < U ? env[(a * d2 + j) * U + u] : 0.f;
    auto load_edge = [&](long long e, float* dst) {
      embed_load_row(w2b, e * nU, flags & kEmbedW2b, (int)nU, dst, lane);
      embed_load_row(sh, e * d_sh, flags & kEmbedSh, d_sh, dst + nU, lane);
      cp_async_commit();
    };
    if (start < end) load_edge(start, s_edge);
    int stage = 0;
    for (long long e = start; e < end; ++e) {
      // the next edge's rows load while this one is worked on
      if (e + 1 < end) {
        load_edge(e + 1, s_edge + (stage ^ 1) * edge_floats);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const float* ewb = s_edge + stage * edge_floats;  // w2b [n_irr][U], then sh
      const float* esh = ewb + nU;
      for (int u0 = 0; u0 < U; u0 += kWarp) {
        const int u = u0 + lane;
        const bool act = u < U;
        for (int i = 0; i < d1; ++i)
          s_x[i * kWarp + lane] = act ? esh[s_spec[2 * i]] * ewb[s_spec[2 * i + 1] * U + u] : 0.f;
        for (int k = 0; k < d3; ++k) s_o[k * kWarp + lane] = 0.f;
        GatherPath f{s_x + lane, s_env + u, s_o + lane, Up, 0, 0, 0, 0.f};
        for (int q = 0; q < n_paths; ++q) {
          const int* dq = s_desc + q * kDescCols;
          f.i0 = dq[2];
          f.j0 = dq[3];
          f.k0 = dq[4];
          f.ws = act ? s_w[dq[0] * U + u] * s_scale[q] : 0.f;
          if (!cg_dispatch(dq[1], f)) {  // l > 3: the path's entries one by one
            for (int n = dq[5]; n < dq[6]; ++n) {
              const int i = eidx[4 * n], j = eidx[4 * n + 1], k = eidx[4 * n + 2];
              const float t = ecoef[n] * f.ws * s_x[i * kWarp + lane];
              s_o[k * kWarp + lane] = fmaf(t, s_env[j * Up + u], s_o[k * kWarp + lane]);
            }
          }
        }
        if (act) {
          for (int k = 0; k < d3; ++k) store_f(out + e * oU + k * U + u, s_o[k * kWarp + lane]);
          if (ts) store_ts(ts, e * U + u, s_o[lane], flags);
        }
      }
      __syncwarp();
      stage ^= 1;
    }
  }
}

// The layout latent_env_scatter launches with in ``limit`` bytes of shared
// memory: kLesGroups walkers with double-buffered piece rows where they fit
// (a single buffer with a hidden layer: the lat tile takes it over), then
// fewer. False where not even one walker with a single buffer fits (*L is
// then that smallest layout). The model's routing rule (ops/smem_fit.py)
// holds the same choice, through atpt_latent_env_scatter_smem.
inline bool les_fit(bool hidden, int K, int H, int N, int d2, int U, int n_irr, size_t limit,
                    LesLayout* L) {
  for (int groups = kLesGroups; groups >= 1; --groups)
    for (int stages = hidden ? 1 : 2; stages >= 1; --stages) {
      *L = les_layout(hidden, K, H, N, d2, U, n_irr, stages, groups);
      if ((size_t)L->total * sizeof(float) <= limit) return true;
    }
  return false;
}

// The layout latent_env_bwd launches with in ``limit`` bytes: the piece rows
// double-buffered and kLebTileAtoms t rows staged where they fit; else fewer
// t rows (at least 2), then a single buffer with as many as fit (down to
// none). False where even that does not fit (*L is then that smallest
// layout); ops/smem_fit.py holds the same choice, through
// atpt_latent_env_bwd_smem.
inline bool leb_fit(bool hidden, int K, int H, int S, int N, int d2, int U, int n_irr,
                    size_t limit, LebLayout* L) {
  for (int stages = 2; stages >= 1; --stages)
    for (int ta = kLebTileAtoms; ta >= (stages == 2 ? 2 : 0); --ta) {
      *L = leb_layout(hidden, K, H, S, N - S, d2, U, n_irr, stages, ta);
      if ((size_t)L->total * sizeof(float) <= limit) return true;
    }
  return false;
}

template <bool kHidden>
int launch_latent_env_scatter(const Pieces& P, const float* w0, const float* w1, const float* sh,
                              const int* centers, const int* row_ptr, const int* irr_ranges,
                              long long n_edges, int n_atoms, int d2, int U, int S, int K, int H,
                              int N, int round_wexp, float* lat_s, float* env,
                              cudaStream_t stream) {
  const int n_irr = (N - S) / U;
  LesLayout L;
  if (!les_fit(kHidden, K, H, N, d2, U, n_irr, smem_optin(), &L))
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = prepare_smem(latent_env_scatter_kernel<kHidden>, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = L.groups * kLebThreads;
  const int blocks = persistent_blocks(latent_env_scatter_kernel<kHidden>, threads, smem,
                                       (n_edges + kLebRows - 1) / kLebRows, L.groups);
  latent_env_scatter_kernel<kHidden><<<blocks, threads, smem, stream>>>(
      P, w0, w1, sh, centers, row_ptr, irr_ranges, n_edges, n_atoms, d2, n_irr, U, S, K, H, N, L,
      round_wexp, lat_s, env);
  return (int)cudaGetLastError();
}

template <bool kHidden>
int launch_latent_env_bwd(const Pieces& P, const OutPieces& D, const float* w0, const float* w1,
                          const float* sh, const float* t, const float* g_lat, const int* centers,
                          const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
                          int S, int K, int H, int N, int round_wexp, float* dsh,
                          cudaStream_t stream) {
  const int n_irr = (N - S) / U;
  LebLayout L;
  if (!leb_fit(kHidden, K, H, S, N, d2, U, n_irr, smem_optin(), &L))
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = prepare_smem(latent_env_bwd_kernel<kHidden>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(latent_env_bwd_kernel<kHidden>, kLebThreads, smem,
                                       (n_edges + kLebRows - 1) / kLebRows, 1);
  latent_env_bwd_kernel<kHidden><<<blocks, kLebThreads, smem, stream>>>(
      P, D, w0, w1, sh, t, g_lat, centers, irr_ranges, n_edges, n_atoms, d2, n_irr, U, S, K, H, N,
      L, round_wexp, dsh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int atpt_latent_env_scatter(const float* const* piece_ptrs, const long long* piece_strides,
                            const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                            const float* sh, const int* centers, const int* row_ptr,
                            const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
                            int S, int H, int N, float* lat_s, float* env, int bf16_wexp,
                            void* stream) {
  Pieces P;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0) return (int)cudaErrorInvalidValue;
  P.n = n_pieces;
  P.bf16 = (unsigned)bf16_wexp >> kPiecesShift;
  bf16_wexp &= 1 | kShBf16;
  if (w1)
    return launch_latent_env_scatter<true>(P, w0, w1, sh, centers, row_ptr, irr_ranges, n_edges,
                                           n_atoms, d2, U, S, K, H, N, bf16_wexp, lat_s, env,
                                           (cudaStream_t)stream);
  return launch_latent_env_scatter<false>(P, w0, w1, sh, centers, row_ptr, irr_ranges, n_edges,
                                          n_atoms, d2, U, S, K, H, N, bf16_wexp, lat_s, env,
                                          (cudaStream_t)stream);
}

int atpt_latent_env_bwd(const float* const* piece_ptrs, const long long* piece_strides,
                        float* const* dpiece_ptrs, const long long* dpiece_strides,
                        const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                        const float* sh, const float* t, const float* g_lat, const int* centers,
                        const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
                        int S, int H, int N, float* dsh, int bf16_wexp, void* stream) {
  Pieces P;
  OutPieces D;
  const int K = fill_pieces(piece_ptrs, piece_strides, piece_dims, n_pieces, P.ptr, P.stride,
                            P.dim, P.off);
  if (K < 0) return (int)cudaErrorInvalidValue;
  P.n = D.n = n_pieces;
  P.bf16 = (unsigned)bf16_wexp >> kPiecesShift;
  bf16_wexp &= 1 | kShBf16;
  for (int i = 0; i < n_pieces; ++i) {
    D.ptr[i] = dpiece_ptrs[i];
    D.stride[i] = dpiece_strides[i];
    D.dim[i] = P.dim[i];
    D.off[i] = P.off[i];
  }
  if (w1)
    return launch_latent_env_bwd<true>(P, D, w0, w1, sh, t, g_lat, centers, irr_ranges, n_edges,
                                       n_atoms, d2, U, S, K, H, N, bf16_wexp, dsh,
                                       (cudaStream_t)stream);
  return launch_latent_env_bwd<false>(P, D, w0, w1, sh, t, g_lat, centers, irr_ranges, n_edges,
                                      n_atoms, d2, U, S, K, H, N, bf16_wexp, dsh,
                                      (cudaStream_t)stream);
}

int atpt_gather_tp_embed(const float* sh, const float* w2b, const float* env, const float* w,
                         int n_w, const int* row_ptr, const int* desc, const float* dscale,
                         int n_paths, const int* eidx, const float* ecoef, const int* row_specs,
                         long long n_edges, int n_atoms, int d_sh, int n_irr, int d1, int d2,
                         int d3, int U, void* out, float* ts, int bf16, void* stream) {
  const size_t fixed = (size_t)embed_fixed_floats(n_paths, n_w, U, d1) * sizeof(float);
  const size_t per_warp =
      (size_t)gather_embed_warp_floats(U, d_sh, n_irr, d1, d2, d3) * sizeof(float);
  size_t smem = 0;
  const int warps = fit_warps(fixed, per_warp, kSegmentWarps, smem_optin(), &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  const long long items = n_atoms + (n_edges + kWarp - 1) / kWarp;
  const auto launch = [&](auto* ot) {
    using To = std::remove_pointer_t<decltype(ot)>;
    cudaError_t err = prepare_smem(gather_tp_embed_kernel<To>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks =
        persistent_blocks(gather_tp_embed_kernel<To>, warps * kWarp, smem, items, warps);
    gather_tp_embed_kernel<To><<<blocks, warps * kWarp, smem, (cudaStream_t)stream>>>(
        sh, w2b, env, w, n_w, row_ptr, desc, dscale, n_paths, eidx, ecoef, row_specs, n_edges,
        n_atoms, d_sh, n_irr, d1, d2, d3, U, ot, ts, bf16);
    return (int)cudaGetLastError();
  };
  if (bf16 & 1) return launch(static_cast<__nv_bfloat16*>(out));
  return launch(static_cast<float*>(out));
}

int atpt_bwd_embed(const float* sh, const float* w2b, const void* g, const float* gts,
                   const float* env, const float* w, int n_w, const int* row_ptr,
                   const int* desc, const float* dscale, int n_paths, const int* eidx,
                   const float* ecoef, const int* row_specs, long long n_edges, int n_atoms,
                   int d_sh, int n_irr, int d1, int d2, int d3, int U, float* dsh, float* dw2b,
                   float* denv, int bf16, void* stream) {
  const size_t fixed = (size_t)embed_fixed_floats(n_paths, n_w, U, d1) * sizeof(float);
  const size_t per_warp = (size_t)embed_warp_floats(U, d_sh, n_irr, d1, d2, d3) * sizeof(float);
  size_t smem = 0;
  const int warps = fit_warps(fixed, per_warp, kSegmentWarps, smem_optin(), &smem);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  const long long items = n_atoms + (n_edges + kWarp - 1) / kWarp;
  const auto launch = [&](auto kernel, auto* gt) {
    cudaError_t err = prepare_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = persistent_blocks(kernel, warps * kWarp, smem, items, warps);
    kernel<<<blocks, warps * kWarp, smem, (cudaStream_t)stream>>>(
        sh, w2b, gt, gts, env, w, n_w, row_ptr, desc, dscale, n_paths, eidx, ecoef, row_specs,
        n_edges, n_atoms, d_sh, n_irr, d1, d2, d3, U, dsh, dw2b, denv, bf16);
    return (int)cudaGetLastError();
  };
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* gf = static_cast<const float*>(g);
  if (gts)
    return (bf16 & 1) ? launch(bwd_embed_kernel<true, __nv_bfloat16>, gb)
                      : launch(bwd_embed_kernel<true, float>, gf);
  return (bf16 & 1) ? launch(bwd_embed_kernel<false, __nv_bfloat16>, gb)
                    : launch(bwd_embed_kernel<false, float>, gf);
}

// The bytes of shared memory each launcher above requests on a card whose
// blocks may opt into ``limit`` bytes: the layout it chooses, or its smallest
// where none fits (more than ``limit``: the launch is refused). The
// arguments are the launchers' own (hidden: 0 or 1; the embeds' n_paths,
// n_w and d1 are the path table's rows, the path weights' rows and
// row_specs' rows). ops/smem_fit.py computes the same on the host, and
// chip_smoke.py holds the two together.
long long atpt_latent_env_scatter_smem(int hidden, int K, int H, int N, int d2, int U, int n_irr,
                                       long long limit) {
  LesLayout L;
  les_fit(hidden != 0, K, H, N, d2, U, n_irr, (size_t)limit, &L);
  return (long long)L.total * (long long)sizeof(float);
}

long long atpt_latent_env_bwd_smem(int hidden, int K, int H, int S, int N, int d2, int U,
                                   int n_irr, long long limit) {
  LebLayout L;
  leb_fit(hidden != 0, K, H, S, N, d2, U, n_irr, (size_t)limit, &L);
  return (long long)L.total * (long long)sizeof(float);
}

long long atpt_gather_tp_embed_smem(int n_paths, int n_w, int d_sh, int n_irr, int d1, int d2,
                                    int d3, int U, long long limit) {
  const size_t fixed = (size_t)embed_fixed_floats(n_paths, n_w, U, d1) * sizeof(float);
  const size_t per_warp =
      (size_t)gather_embed_warp_floats(U, d_sh, n_irr, d1, d2, d3) * sizeof(float);
  size_t smem = 0;
  if (fit_warps(fixed, per_warp, kSegmentWarps, (size_t)limit, &smem) == 0)
    smem = fixed + per_warp;
  return (long long)smem;
}

long long atpt_bwd_embed_smem(int n_paths, int n_w, int d_sh, int n_irr, int d1, int d2, int d3,
                              int U, long long limit) {
  const size_t fixed = (size_t)embed_fixed_floats(n_paths, n_w, U, d1) * sizeof(float);
  const size_t per_warp = (size_t)embed_warp_floats(U, d_sh, n_irr, d1, d2, d3) * sizeof(float);
  size_t smem = 0;
  if (fit_warps(fixed, per_warp, kSegmentWarps, (size_t)limit, &smem) == 0)
    smem = fixed + per_warp;
  return (long long)smem;
}

}  // extern "C"
