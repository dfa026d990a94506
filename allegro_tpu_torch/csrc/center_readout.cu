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

// center_sum over few, long segments (a parameter table's class CSR: a
// handful of rows, each summing thousands of edges or atoms), where one
// thread per (row, column) would walk a whole segment alone. Pass 1: block
// i adds the CSR positions [i*chunk, (i+1)*chunk) of each segment it meets,
// in position order, into partial[i][row] (the caller zeroes partial, so a
// segment that misses the chunk stays 0); pass 2 (partials_reduce_kernel)
// adds the blocks' partials in block order. A fixed order, no atomics.
__global__ void center_sum_chunks_kernel(const float* __restrict__ v,
                                         const int* __restrict__ row_ptr,
                                         const int* __restrict__ perm, int n_rows, int C,
                                         int chunk, float* __restrict__ partial) {
  const long long k0 = (long long)blockIdx.x * chunk, end = row_ptr[n_rows];
  if (k0 >= end) return;
  const long long k1 = min(k0 + chunk, end);
  int a0 = 0;  // the segment of position k0
  while (row_ptr[a0 + 1] <= k0) ++a0;
  float* out = partial + (long long)blockIdx.x * n_rows * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int a = a0;
    long long next = row_ptr[a + 1];
    float s = 0.f;
    for (long long k = k0; k < k1; ++k) {
      while (k >= next) {  // segment a ends before k
        out[(long long)a * C + c] = s;
        s = 0.f;
        next = row_ptr[++a + 1];
      }
      s += v[(perm ? perm[k] : k) * C + c];
    }
    out[(long long)a * C + c] = s;
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

// The widest tile whose shared memory fits on the card: 64 edges, then 32,
// then 16.
template <bool kSilu>
int launch_readout_bwd_fit(const Pieces& P, const OutPieces& D, bool vec_out, const float* w0,
                           const float* w1, const float* y, const int* centers, long long n_edges,
                           int n_atoms, int K, int H, cudaStream_t stream) {
  const size_t limit = smem_optin();
  const auto fits = [&](int rows) {
    return (size_t)rb_layout(K, H, rows, kSilu).total * sizeof(float) <= limit;
  };
  if (fits(64))
    return launch_readout_bwd<kSilu, 64>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K,
                                         H, stream);
  if (fits(32))
    return launch_readout_bwd<kSilu, 32>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K,
                                         H, stream);
  return launch_readout_bwd<kSilu, 16>(P, D, vec_out, w0, w1, y, centers, n_edges, n_atoms, K, H,
                                       stream);
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

int atpt_center_sum_chunked(const float* v, const int* row_ptr, const int* perm, int n_rows,
                            int C, long long n_pos, int chunk, float* partial, float* out,
                            void* stream) {
  const long long n_blocks = (n_pos + chunk - 1) / chunk;
  const int threads = C < kThreads ? (C + kWarp - 1) / kWarp * kWarp : kThreads;
  if (n_blocks > 0)
    center_sum_chunks_kernel<<<(int)n_blocks, threads, 0, (cudaStream_t)stream>>>(
        v, row_ptr, perm, n_rows, C, chunk, partial);
  const int n = n_rows * C;
  partials_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, (int)n_blocks, n, out);
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
  if (K < 0 || H < 1 || n_edges < 1) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;  // no output column
  P.n = D.n = n_pieces;
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

}  // extern "C"
