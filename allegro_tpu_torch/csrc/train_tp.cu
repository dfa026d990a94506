// Allegro tensor-product kernels of env_scatter and its transposes for
// Hopper (sm_90a), float32, each with a bf16 form for the bf16 tensor track.
//
// The layer's environment sum and the trainable backend's kernels around it.
// The inference backend without the mega kernels (`tp_kernel_backend=
// "fused_infer"`, `use_mega=False` or shared env weights) and the trainable
// one (`"fused"`) run env_scatter and gather_tp (csrc/sparse_tp.cu) forward;
// the trainable backend's derivatives are the closed family of
// allegro_tpu/ops/fused_primitives.py: every transpose is again one of the
// family with permuted roles, so the double backward of force training stays
// on the kernels. This file holds env_scatter and its two transposes;
// gather_tp's, tp_scatter and gather_dw, walk compiled CG paths in
// csrc/sparse_tp.cu. Each replaces one Pallas TPU kernel of
// allegro_tpu/ops/fused_tp.py and computes its function in atom space
// instead of the TPU's rank windows:
//
//   env_scatter   env[a, jU+u]  = sum_{c(e)=a} sh[e, j] wexp[e, irr(j)U+u]
//   unweight_sh   dsh[e, j]     = sum_u t[c(e), jU+u] wexp[e, irr(j)U+u]
//   unweight_w    dwexp[e, rU+u] = sum_{j: irr(j)=r} t[c(e), jU+u] sh[e, j]
//   unweight_both both of them in one pass: the backward of env_scatter on
//                 the inference backend without the mega kernels
//
// All four stage contiguous wexp and sh rows by cp.async (stage_range). The
// three transposes run the same tile schedule on the same device functions
// (tile_dsh, tile_dwexp): unweight_both stages the rows both need once.
//
// The bf16 forms (the model's tensor_dtype="bfloat16", JAX's storage): the
// env weights wexp of env_scatter, unweight_sh and unweight_both may be
// __nv_bfloat16 (or a cotangent in their role, on the trainable backend's
// double backward), and so may the dwexp that unweight_w and unweight_both
// write (JAX stores it in the env weights' dtype; unweight_both also reads
// bf16 wexp and writes float dwexp, for a mega model routed off the mega
// kernels, whose env weights' cotangent JAX's mega path never rounds). A bf16 wexp row is
// widened to float as it is staged (stage_rows: plain loads, since cp.async
// copies bytes and cannot widen), so shared memory and every sum are the
// float32 forms'; dwexp is rounded once, on store. t, env and dsh stay
// float32, and so does sh, except in a bfloat16 model (model_dtype=
// "bfloat16", JAX's param dtype): there env_scatter and unweight_both read
// bf16 sh beside bf16 wexp, and unweight_w (its training form, the wexp
// cotangent of env_scatter's double backward) bf16 sh beside its bf16
// dwexp, their rows widened as they are staged (the same stage_rows), bit 1
// of their bf16 flags.
//
// Layout (the JAX package's contract): per-edge arrays are row-major with
// the flat dim-major tensor track (column i*U+u is basis dim i, channel u);
// edges are sorted by center, the CSR row pointer `row_ptr[a]` is the first
// edge of atom a, and padded edges carry the center n_atoms after
// row_ptr[n_atoms]: they add nothing and read zeros from per-atom arrays.
// Every sum runs in a fixed order (no atomics), so two identical calls give
// identical results. Each kernel runs on the caller's stream and allocates
// nothing; each entry point returns cudaGetLastError().

#include "common.cu"

namespace {

// ---------------------------------------------------------------------------
// unweight_sh
// Replaces allegro_tpu/ops/fused_tp.py:_gather_unweight_sh_kernel
// (gather_unweight_sh_call): the sh-transpose of env_scatter.
// Bound: one read of wexp [E, n_irr*U] and of t [n_atoms, d2*U] and one
// write of dsh [E, d2] (48 MB at the flagship's layer 0 on the 4,096-atom
// crystal, ~0.014 ms at 3.35 TB/s); 2 FLOPs per (edge, dim, channel).
// Design: a row kernel on tiles of kShTile consecutive edges, one block per
// tile. The tile's wexp rows are one contiguous range: they go into shared
// memory by 16-byte cp.async copies (4-byte ones where U or the pointers
// are not 16-byte multiples). Edges are sorted by center, so the tile's
// centers are few and consecutive: the t rows [c(first edge), c(last real
// edge)] go into shared memory too, up to kShCenters of them (an edge whose
// row is not staged reads it from device memory). Where those rows do not
// fit in the card's opt-in shared memory (l_max 4 at U = 256 needs 260 KiB),
// the launcher stages fewer t rows, down to one, then halves the tile, down
// to one edge, then stages no t row. Each thread then computes
// whole (edge, j) dots over u from shared memory, with no shuffle
// reduction: thread o of the tile's d2 * n_edges outputs starts its walk
// over the U channels at float4 o mod (U / 4), so the eight threads of a
// 16-byte shared-memory phase read eight different bank groups with no
// padding. The tile's dsh [n_edges, d2] is one contiguous range, written
// coalesced. A sentinel edge (center outside [0, n_atoms)) writes zeros and
// reads no t row; the last tile may be partial.
// ---------------------------------------------------------------------------

constexpr int kShTile = 32;      // edges per block (64 ran slower on an H100)
constexpr int kShThreads = 128;  // threads per block
constexpr int kShCenters = 4;    // t rows staged per tile (at most)

// sum_u a[u] b[u] over U channels, starting at element (kVec = 1) or float4
// (kVec = 4) rot and wrapping around.
template <int kVec>
__device__ __forceinline__ float rotated_dot(const float* __restrict__ a,
                                             const float* __restrict__ b, int U, int rot) {
  float s = 0.f;
  if (kVec == 4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int nv = U / 4;
    for (int n = 0, k = rot; n < nv; ++n) {
      const float4 p = a4[k], v = b4[k];
      s = fmaf(p.x, v.x, s);
      s = fmaf(p.y, v.y, s);
      s = fmaf(p.z, v.z, s);
      s = fmaf(p.w, v.w, s);
      if (++k == nv) k = 0;
    }
  } else {
    for (int n = 0, k = rot; n < U; ++n) {
      s = fmaf(a[k], b[k], s);
      if (++k == U) k = 0;
    }
  }
  return s;
}

// Copies n floats from src to dst with cp.async, 16 bytes (kVec = 4: both
// 16-byte aligned, n a multiple of 4) or 4 bytes at a time.
template <int kVec>
__device__ __forceinline__ void stage_range(float* dst, const float* src, int n) {
  if (kVec == 4) {
    for (int q = 4 * threadIdx.x; q < n; q += 4 * blockDim.x) cp_async16(dst + q, src + q);
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) cp_async4(dst + q, src + q);
  }
}

// Stages n elements of a row range into shared memory as float: the float
// rows by stage_range's cp.async copies, the bf16 ones by plain loads
// widened to float as they are stored (the caller's cp_async_wait and
// __syncthreads cover both).
template <int kVec>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  stage_range<kVec>(dst, src, n);
}

template <int kVec>
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* src, int n) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) dst[q] = load_f(src + q);
}

// Stores four channels of an output row from one float4: one 16-byte store
// (float, 16-byte aligned: the launchers check) or four rounded ones (bf16).
__device__ __forceinline__ void store4(float* o, const float4& v) {
  *reinterpret_cast<float4*>(o) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, const float4& v) {
  store_f(o, v.x);
  store_f(o + 1, v.y);
  store_f(o + 2, v.z);
  store_f(o + 3, v.w);
}

// The t rows a tile stages, [c_lo, c_lo + n_c): from its first edge's center
// to its last real one's, at most n_stage (none where the first edge is a
// sentinel).
__device__ __forceinline__ void tile_centers(const int* __restrict__ centers, long long e0,
                                             int n_e, int n_atoms, int n_stage, int* c_lo,
                                             int* n_c) {
  *c_lo = __ldg(centers + e0);
  *n_c = 0;
  if (*c_lo >= 0 && *c_lo < n_atoms) {
    const int c_hi = min(__ldg(centers + e0 + n_e - 1), n_atoms - 1);
    *n_c = max(0, min(n_stage, c_hi - *c_lo + 1));
  }
}

// dsh of the tile's n_e edges from e0, its wexp rows staged in s_w and the t
// rows [c_lo, c_lo + n_c) in s_t: thread o of the tile's n_e * d2 outputs
// (edge, j) dots its wexp irrep row with its t row over the U channels,
// starting at its own rotation.
template <int kVec>
__device__ __forceinline__ void tile_dsh(const float* __restrict__ t, const float* s_w,
                                         const float* s_t, const int* __restrict__ centers,
                                         const int* __restrict__ dim_to_irr, long long e0, int n_e,
                                         int c_lo, int n_c, int n_atoms, int d2, int n_irr, int U,
                                         float* __restrict__ dsh) {
  const int wrow = n_irr * U, trow = d2 * U;
  const int period = kVec == 4 ? U / 4 : U;
  for (int o = threadIdx.x; o < n_e * d2; o += kShThreads) {
    const int el = o / d2, j = o - el * d2;
    const int c = __ldg(centers + e0 + el);
    float s = 0.f;
    if (c >= 0 && c < n_atoms) {
      const float* wr = s_w + el * wrow + __ldg(dim_to_irr + j) * U;
      const int rot = o % period;
      if (c - c_lo >= 0 && c - c_lo < n_c)
        s = rotated_dot<kVec>(wr, s_t + (c - c_lo) * trow + j * U, U, rot);
      else
        s = rotated_dot<kVec>(wr, t + (long long)c * trow + j * U, U, rot);
    }
    dsh[e0 * d2 + o] = s;
  }
}

template <int kVec, typename Tw>
__global__ void __launch_bounds__(kShThreads) unweight_sh_kernel(
    const float* __restrict__ t, const Tw* __restrict__ wexp, const int* __restrict__ centers,
    const int* __restrict__ dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr, int U,
    int tile, int n_stage, float* __restrict__ dsh) {
  extern __shared__ unsigned char smem[];  // 16-byte aligned: the dynamic window's start
  const int wrow = n_irr * U, trow = d2 * U;
  float* s_w = reinterpret_cast<float*>(smem);  // [tile][n_irr * U]
  float* s_t = s_w + tile * wrow;               // [n_stage][d2 * U]
  const long long e0 = (long long)blockIdx.x * tile;
  const int n_e = (int)(n_edges - e0 < tile ? n_edges - e0 : tile);
  int c_lo, n_c;
  tile_centers(centers, e0, n_e, n_atoms, n_stage, &c_lo, &n_c);
  stage_rows<kVec>(s_w, wexp + e0 * wrow, n_e * wrow);
  stage_range<kVec>(s_t, t + (long long)c_lo * trow, n_c * trow);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  tile_dsh<kVec>(t, s_w, s_t, centers, dim_to_irr, e0, n_e, c_lo, n_c, n_atoms, d2, n_irr, U, dsh);
}

// ---------------------------------------------------------------------------
// unweight_w
// Replaces allegro_tpu/ops/fused_tp.py:_gather_unweight_w_kernel
// (gather_unweight_w_call): the wexp-transpose of env_scatter.
// Bound: one write of dwexp [E, n_irr*U] (40 MB at the flagship's layer 0
// on the 4,096-atom crystal, ~0.012 ms at 3.35 TB/s), one read of sh [E,
// d2] and t [n_atoms, d2*U]; 2 FLOPs per (edge, dim, channel).
// Design: unweight_sh's tiles run the other way. One block per tile of
// kShTile consecutive edges: the tile's sh rows (one contiguous range) and
// up to kShCenters t rows of its consecutive centers go into shared memory
// by cp.async (t by 16-byte copies where U and the pointers allow, else 4
// bytes; the same back-off as unweight_sh where the t rows outgrow shared
// memory). Each irrep's dims are one contiguous range (every Contracter
// registers irr_ranges, and ops/fused_tp.py:irrep_ranges raises otherwise):
// each block finds each irrep's (first, end) dims from dim_to_irr. Each
// thread then takes items (edge, channels 4v..4v+3), single channels where
// U is not a multiple of 4: one center, t row and sh row for all the edge's
// outputs, and per irrep r a float4 sum over the dims of r with no branch
// per dim. The tile's dwexp [n_edges, n_irr*U] is one contiguous range:
// consecutive threads store consecutive 16 bytes of it. A sentinel edge
// (center outside [0, n_atoms)) writes zeros and reads no t row; the last
// tile may be partial. Measured on the H100 and not kept: one thread per
// float4 output (edge, irrep, channels), its indices by integer division,
// 256 threads or 16- and 64-edge tiles, a persistent grid
// staging the next tile during this one, and no staged t row (all slower).
// ---------------------------------------------------------------------------
// Each irrep's dims [s_first[r], s_end[r]) from dim_to_irr (each irrep's
// dims one contiguous range), one thread per dim.
__device__ __forceinline__ void irrep_bounds(const int* __restrict__ dim_to_irr, int d2,
                                             int* s_first, int* s_end) {
  for (int j = threadIdx.x; j < d2; j += kShThreads) {
    const int r = __ldg(dim_to_irr + j);
    if (j == 0 || __ldg(dim_to_irr + j - 1) != r) s_first[r] = j;
    if (j == d2 - 1 || __ldg(dim_to_irr + j + 1) != r) s_end[r] = j + 1;
  }
}

// dwexp of the tile's n_e edges from e0, its sh rows staged in s_sh, the t
// rows [c_lo, c_lo + n_c) in s_t and the irreps' dims in s_first / s_end:
// thread item q = (edge el of the tile, channel group v): one center, t row
// and sh row for all of the edge's irreps; el by a float reciprocal, exact
// while q + 0.5 < 2^22 (the launchers check), not an integer division.
template <int kVec, typename To>
__device__ __forceinline__ void tile_dwexp(const float* __restrict__ t, const float* s_sh,
                                           const float* s_t, const int* s_first, const int* s_end,
                                           const int* __restrict__ centers, long long e0, int n_e,
                                           int c_lo, int n_c, int n_atoms, int d2, int n_irr,
                                           int U, To* __restrict__ dwexp) {
  const int trow = d2 * U, nU = n_irr * U;
  const int per_irr = U / kVec;  // channel groups of kVec floats
  const float inv_irr = 1.f / per_irr;
  for (int q = threadIdx.x; q < n_e * per_irr; q += kShThreads) {
    const int el = (int)(((float)q + 0.5f) * inv_irr), v = q - el * per_irr;
    const int c = __ldg(centers + e0 + el);
    const bool real = c >= 0 && c < n_atoms;
    const float* tr = !real ? nullptr
                      : c - c_lo >= 0 && c - c_lo < n_c ? s_t + (c - c_lo) * trow
                                                        : t + (long long)c * trow;
    const float* sr = s_sh + el * d2;
    To* o = dwexp + (e0 + el) * nU;
    for (int r = 0; r < n_irr; ++r) {
      const int j0 = s_first[r], j1 = real ? s_end[r] : j0;  // a sentinel sums no dim
      if constexpr (kVec == 4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        // not unrolled: unrolled, this loop took 56 registers and spilled
#pragma unroll 1
        for (int j = j0; j < j1; ++j) {
          const float s = sr[j];
          const float4 tv = reinterpret_cast<const float4*>(tr + j * U)[v];
          acc.x = fmaf(s, tv.x, acc.x);
          acc.y = fmaf(s, tv.y, acc.y);
          acc.z = fmaf(s, tv.z, acc.z);
          acc.w = fmaf(s, tv.w, acc.w);
        }
        store4(o + r * U + 4 * v, acc);
      } else {
        float acc = 0.f;
        for (int j = j0; j < j1; ++j) acc = fmaf(sr[j], tr[j * U + v], acc);
        store_f(o + r * U + v, acc);
      }
    }
  }
}

template <int kVec, typename To, typename Ts>
__global__ void __launch_bounds__(kShThreads) unweight_w_kernel(
    const float* __restrict__ t, const Ts* __restrict__ sh, const int* __restrict__ centers,
    const int* __restrict__ dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr, int U,
    int tile, int n_stage, To* __restrict__ dwexp) {
  extern __shared__ unsigned char smem[];  // 16-byte aligned: the dynamic window's start
  const int trow = d2 * U;
  float* s_t = reinterpret_cast<float*>(smem);        // [n_stage][d2 * U]
  float* s_sh = s_t + n_stage * trow;                 // [tile][d2]
  int* s_first = reinterpret_cast<int*>(s_sh + tile * d2);  // [n_irr]: irrep r's dims are
  int* s_end = s_first + n_irr;                       // [s_first[r], s_end[r])
  const long long e0 = (long long)blockIdx.x * tile;
  const int n_e = (int)(n_edges - e0 < tile ? n_edges - e0 : tile);
  int c_lo, n_c;
  tile_centers(centers, e0, n_e, n_atoms, n_stage, &c_lo, &n_c);
  stage_range<kVec>(s_t, t + (long long)c_lo * trow, n_c * trow);
  stage_rows<1>(s_sh, sh + e0 * d2, n_e * d2);
  cp_async_commit();
  irrep_bounds(dim_to_irr, d2, s_first, s_end);
  cp_async_wait<0>();
  __syncthreads();
  tile_dwexp<kVec>(t, s_sh, s_t, s_first, s_end, centers, e0, n_e, c_lo, n_c, n_atoms, d2, n_irr,
                   U, dwexp);
}

// ---------------------------------------------------------------------------
// unweight_both
// Replaces allegro_tpu/ops/fused_tp.py:_unweight_both_raw_kernel
// (unweight_both_raw_call) and _unweight_both_kernel (unweight_both_call, the
// same function from one denv array): the two transposes of env_scatter in
// one pass.
// Bound: one read of wexp [E, n_irr*U], sh [E, d2] and t [n_atoms, d2*U], one
// write of dsh [E, d2] and dwexp [E, n_irr*U] (92 MB per layer at the
// flagship on the 4,096-atom crystal, ~0.027 ms at 3.35 TB/s); 4 FLOPs per
// (edge, dim, channel).
// Design: unweight_sh's and unweight_w's tiles in one block. One block per
// tile of kShTile consecutive edges stages the tile's wexp rows and sh rows
// (each one contiguous range) and up to kShCenters t rows of its consecutive
// centers in one cp.async group, finds each irrep's dims as unweight_w does,
// then runs unweight_sh's (edge, j) dots (tile_dsh) and unweight_w's (edge,
// 4 channels) items (tile_dwexp) on the staged rows: every t row a tile's
// edges share is read from device memory once for both outputs. The
// launcher backs off as the other two do where the three staged ranges
// outgrow shared memory (fit_tile). A sentinel edge writes zero dsh and
// dwexp rows and reads no t row; the last tile may be partial; no atomics.
// ---------------------------------------------------------------------------
template <int kVec, typename Tw, typename To, typename Ts>
__global__ void __launch_bounds__(kShThreads) unweight_both_kernel(
    const float* __restrict__ t, const Ts* __restrict__ sh, const Tw* __restrict__ wexp,
    const int* __restrict__ centers, const int* __restrict__ dim_to_irr, long long n_edges,
    int n_atoms, int d2, int n_irr, int U, int tile, int n_stage, float* __restrict__ dsh,
    To* __restrict__ dwexp) {
  extern __shared__ unsigned char smem[];  // 16-byte aligned: the dynamic window's start
  const int wrow = n_irr * U, trow = d2 * U;
  float* s_w = reinterpret_cast<float*>(smem);              // [tile][n_irr * U]
  float* s_t = s_w + tile * wrow;                           // [n_stage][d2 * U]
  float* s_sh = s_t + n_stage * trow;                       // [tile][d2]
  int* s_first = reinterpret_cast<int*>(s_sh + tile * d2);  // [n_irr]
  int* s_end = s_first + n_irr;                             // [n_irr]
  const long long e0 = (long long)blockIdx.x * tile;
  const int n_e = (int)(n_edges - e0 < tile ? n_edges - e0 : tile);
  int c_lo, n_c;
  tile_centers(centers, e0, n_e, n_atoms, n_stage, &c_lo, &n_c);
  stage_rows<kVec>(s_w, wexp + e0 * wrow, n_e * wrow);
  stage_range<kVec>(s_t, t + (long long)c_lo * trow, n_c * trow);
  stage_rows<1>(s_sh, sh + e0 * d2, n_e * d2);
  cp_async_commit();
  irrep_bounds(dim_to_irr, d2, s_first, s_end);
  cp_async_wait<0>();
  __syncthreads();
  tile_dsh<kVec>(t, s_w, s_t, centers, dim_to_irr, e0, n_e, c_lo, n_c, n_atoms, d2, n_irr, U, dsh);
  tile_dwexp<kVec>(t, s_sh, s_t, s_first, s_end, centers, e0, n_e, c_lo, n_c, n_atoms, d2, n_irr,
                   U, dwexp);
}

// ---------------------------------------------------------------------------
// env_scatter
// Replaces allegro_tpu/ops/fused_tp.py:_env_scatter_kernel (env_scatter_call).
// Bound: one read of wexp [E, n_irr*U] and sh [E, d2] and one write of env
// [n_atoms, d2*U] (48 MB at the flagship's layer 0 on the 4,096-atom
// crystal, ~0.0144 ms at 3.35 TB/s); 2 FLOPs per (edge, dim, channel).
// Design: a block per group of kEnvGroup consecutive atoms. Edges are sorted
// by center, so the group's edges are one contiguous range [row_ptr[a0],
// row_ptr[a0 + G]): its wexp rows and sh rows go into shared memory by
// cp.async (wexp by 16-byte copies where U and the pointers allow, else 4
// bytes), in chunks of at most kEnvTile edges, halved while their rows take
// more than a quarter of the card's shared memory so that four blocks share
// an SM (U = 256 takes 16-edge chunks), so device memory reads each wexp row
// once. Each thread owns one item (atom of the group, dim j, channels
// 4q..4q+3; one channel where U is not a multiple of 4): it sums sh[e, j] *
// wexp[e, irr(j)U + 4q..] over its atom's staged edges in edge order, in
// four registers carried across chunks, and writes env as one float4, so a
// block's stores are one contiguous range. Where an atom's items outnumber
// kEnvThreads (wide U), a block takes one atom and a slice of its items. An
// atom without edges writes zeros; nothing past row_ptr[n_atoms] is read, so
// sentinel edges and their rows are never touched. No atomics: two identical
// calls give identical bits. Measured on an H100 and not kept (PERF.md, PR
// 14): groups of 1, 3, 4 and 6 atoms with 32-, 96-, 128- and 192-edge chunks
// (as fast or up to 10% slower at the flagship).
// ---------------------------------------------------------------------------
constexpr int kEnvGroup = 2;      // atoms per block
constexpr int kEnvTile = 64;      // edges staged per chunk (at most)
constexpr int kEnvThreads = 512;  // threads per block (at most)

template <int kVec, typename Tw, typename Ts>
__global__ void __launch_bounds__(kEnvThreads) env_scatter_kernel(
    const Ts* __restrict__ sh, const Tw* __restrict__ wexp, const int* __restrict__ row_ptr,
    const int* __restrict__ dim_to_irr, int n_atoms, int d2, int n_irr, int U, int group,
    int slices, int per_atom, int tile, float* __restrict__ env) {
  extern __shared__ unsigned char smem[];  // 16-byte aligned: the dynamic window's start
  const int wrow = n_irr * U;
  float* s_w = reinterpret_cast<float*>(smem);  // [tile][n_irr * U]
  float* s_sh = s_w + tile * wrow;              // [tile][d2]
  // block b: the atoms' group b / slices, their items' slice b % slices (the
  // slices of an atom run side by side, so its rows come from L2 after the first)
  const int slice = blockIdx.x % slices;
  const int a0 = (blockIdx.x / slices) * group, a_stop = min(a0 + group, n_atoms);
  const int gi = threadIdx.x / per_atom;
  const int item = slice * per_atom + (threadIdx.x - gi * per_atom);
  const int per_dim = U / kVec, a = a0 + gi;
  const bool active = gi < group && a < n_atoms && item < d2 * per_dim;
  // the thread's dim, its wexp column and its atom's edges [seg0, seg1)
  int j = 0, wcol = 0, seg0 = 0, seg1 = 0;
  if (active) {
    j = item / per_dim;
    wcol = __ldg(dim_to_irr + j) * U + (item - j * per_dim) * kVec;
    seg0 = __ldg(row_ptr + a);
    seg1 = __ldg(row_ptr + a + 1);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int g0 = __ldg(row_ptr + a0), g1 = __ldg(row_ptr + a_stop);
  for (int c0 = g0; c0 < g1; c0 += tile) {
    const int n = min(tile, g1 - c0);
    if (c0 > g0) __syncthreads();  // every thread is done with the last chunk's rows
    stage_rows<kVec>(s_w, wexp + (long long)c0 * wrow, n * wrow);
    stage_rows<1>(s_sh, sh + (long long)c0 * d2, n * d2);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int e1 = min(seg1, c0 + n) - c0;
#pragma unroll 4
    for (int e = max(seg0, c0) - c0; e < e1; ++e) {
      const float s = s_sh[e * d2 + j];
      if constexpr (kVec == 4) {
        const float4 w = *reinterpret_cast<const float4*>(s_w + e * wrow + wcol);
        acc.x = fmaf(s, w.x, acc.x);
        acc.y = fmaf(s, w.y, acc.y);
        acc.z = fmaf(s, w.z, acc.z);
        acc.w = fmaf(s, w.w, acc.w);
      } else {
        acc.x = fmaf(s, s_w[e * wrow + wcol], acc.x);
      }
    }
  }
  if (!active) return;
  float* out = env + (long long)a * d2 * U + item * kVec;
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(out) = acc;
  else
    *out = acc.x;
}

// The widest schedule of a tiled row kernel whose shared memory, bytes(tile,
// n_stage), fits on the card: fewer staged t rows first (down to one), then
// smaller tiles (down to one edge), then no staged t row; false where even
// that does not fit.
template <typename Bytes>
bool fit_tile(Bytes bytes, int* tile, int* n_stage) {
  *tile = kShTile;
  *n_stage = kShCenters;
  const size_t limit = smem_optin();
  while (bytes(*tile, *n_stage) > limit && *n_stage > 1) --*n_stage;
  while (bytes(*tile, *n_stage) > limit && *tile > 1) *tile /= 2;
  if (bytes(*tile, *n_stage) > limit) *n_stage = 0;
  return bytes(*tile, *n_stage) <= limit;
}

// The launches of the four kernels, on float (Tw = float) or bf16 env
// weights: the same schedule and shared memory either way. A bf16 row is
// staged by plain loads, so only a float range's pointer must be 16-byte
// aligned for the float4 form.
template <typename Tw, typename Ts = float>
int launch_env_scatter(const Ts* sh, const Tw* wexp, const int* row_ptr, const int* dim_to_irr,
                       int n_atoms, int d2, int n_irr, int U, float* env, cudaStream_t stream) {
  if (n_atoms < 1 || d2 < 1 || n_irr < 1 || U < 1) return (int)cudaErrorInvalidValue;
  const bool vec = U % 4 == 0 && (!std::is_same_v<Tw, float> || (uintptr_t)wexp % 16 == 0) &&
                   (uintptr_t)env % 16 == 0;
  // an atom's items (dim, channel group), split into slices of at most
  // kEnvThreads; atoms of one slice each are grouped, up to kEnvGroup a block
  const int items = d2 * (vec ? U / 4 : U);
  const int slices = (items + kEnvThreads - 1) / kEnvThreads;
  const int per_atom = (items + slices - 1) / slices;
  int group = slices > 1 ? 1 : kEnvThreads / per_atom;  // at least 1: per_atom <= kEnvThreads
  if (group > kEnvGroup) group = kEnvGroup;
  const int threads = round_up(group * per_atom, kWarp);
  // chunks of kEnvTile edges, halved while their rows take more than a
  // quarter of the card's shared memory (at least four blocks an SM)
  const auto bytes = [&](int tile) { return (size_t)tile * (n_irr * U + d2) * sizeof(float); };
  int tile = kEnvTile;
  while (bytes(tile) > smem_optin() / 4 && tile > 1) tile /= 2;
  const long long blocks = (long long)(n_atoms + group - 1) / group * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = vec ? env_scatter_kernel<4, Tw, Ts> : env_scatter_kernel<1, Tw, Ts>;
  cudaError_t err = prepare_smem(kernel, bytes(tile));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, bytes(tile), stream>>>(
      sh, wexp, row_ptr, dim_to_irr, n_atoms, d2, n_irr, U, group, slices, per_atom, tile, env);
  return (int)cudaGetLastError();
}

template <typename Tw>
int launch_unweight_sh(const float* t, const Tw* wexp, const int* centers, const int* dim_to_irr,
                       long long n_edges, int n_atoms, int d2, int n_irr, int U, float* dsh,
                       cudaStream_t stream) {
  if (n_edges < 1 || d2 < 1 || n_irr < 1 || U < 1) return (int)cudaErrorInvalidValue;
  const auto bytes = [&](int tile, int n_stage) {
    return (size_t)(tile * n_irr + n_stage * d2) * U * sizeof(float);
  };
  int tile, n_stage;
  if (!fit_tile(bytes, &tile, &n_stage)) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_edges + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = U % 4 == 0 && (uintptr_t)t % 16 == 0 &&
                   (!std::is_same_v<Tw, float> || (uintptr_t)wexp % 16 == 0);
  auto kernel = vec ? unweight_sh_kernel<4, Tw> : unweight_sh_kernel<1, Tw>;
  const size_t smem = bytes(tile, n_stage);
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, kShThreads, smem, stream>>>(
      t, wexp, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U, tile, n_stage, dsh);
  return (int)cudaGetLastError();
}

template <typename To, typename Ts = float>
int launch_unweight_w(const float* t, const Ts* sh, const int* centers, const int* dim_to_irr,
                      long long n_edges, int n_atoms, int d2, int n_irr, int U, To* dwexp,
                      cudaStream_t stream) {
  // n_irr <= d2, and the kernel's float reciprocal is exact for its items
  if (n_edges < 1 || d2 < 1 || n_irr < 1 || n_irr > d2 || U < 1 || (long long)kShTile * U >= 1 << 22)
    return (int)cudaErrorInvalidValue;
  const auto bytes = [&](int tile, int n_stage) {
    return ((size_t)n_stage * d2 * U + (size_t)tile * d2 + 2 * n_irr) * sizeof(float);
  };
  int tile, n_stage;
  if (!fit_tile(bytes, &tile, &n_stage)) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_edges + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = U % 4 == 0 && (uintptr_t)t % 16 == 0 &&
                   (!std::is_same_v<To, float> || (uintptr_t)dwexp % 16 == 0);
  auto kernel = vec ? unweight_w_kernel<4, To, Ts> : unweight_w_kernel<1, To, Ts>;
  const size_t smem = bytes(tile, n_stage);
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, kShThreads, smem, stream>>>(
      t, sh, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U, tile, n_stage, dwexp);
  return (int)cudaGetLastError();
}

template <typename Tw, typename To, typename Ts = float>
int launch_unweight_both(const float* t, const Ts* sh, const Tw* wexp, const int* centers,
                         const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr,
                         int U, float* dsh, To* dwexp, cudaStream_t stream) {
  // as atpt_unweight_w: n_irr <= d2, and the float reciprocal exact for its items
  if (n_edges < 1 || d2 < 1 || n_irr < 1 || n_irr > d2 || U < 1 || (long long)kShTile * U >= 1 << 22)
    return (int)cudaErrorInvalidValue;
  // the wexp rows, the t rows (once for both outputs), the sh rows, the irreps' dims
  const auto bytes = [&](int tile, int n_stage) {
    return ((size_t)(tile * n_irr + n_stage * d2) * U + (size_t)tile * d2 + 2 * n_irr) *
           sizeof(float);
  };
  int tile, n_stage;
  if (!fit_tile(bytes, &tile, &n_stage)) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_edges + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = U % 4 == 0 && (uintptr_t)t % 16 == 0 &&
                   (!std::is_same_v<Tw, float> || (uintptr_t)wexp % 16 == 0) &&
                   (!std::is_same_v<To, float> || (uintptr_t)dwexp % 16 == 0);
  auto kernel = vec ? unweight_both_kernel<4, Tw, To, Ts> : unweight_both_kernel<1, Tw, To, Ts>;
  const size_t smem = bytes(tile, n_stage);
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, kShThreads, smem, stream>>>(
      t, sh, wexp, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U, tile, n_stage, dsh, dwexp);
  return (int)cudaGetLastError();
}

using bf16_t = __nv_bfloat16;

}  // namespace

extern "C" {

// dim_to_irr [d2]; the edges of atom a are [row_ptr[a], row_ptr[a + 1]).
// bf16: bit 0, wexp is __nv_bfloat16 (the bf16 track's env weights), else
// float; bit 1 (with bit 0), sh is __nv_bfloat16 too (a bfloat16 model's).
int atpt_env_scatter(const void* sh_, const void* wexp, const int* row_ptr,
                     const int* dim_to_irr, int n_atoms, int d2, int n_irr, int U, float* env,
                     int bf16, void* stream) {
  const auto* sh = static_cast<const float*>(sh_);
  if (bf16 & 2)
    return (bf16 & 1) ? launch_env_scatter(static_cast<const bf16_t*>(sh_),
                                           static_cast<const bf16_t*>(wexp), row_ptr, dim_to_irr,
                                           n_atoms, d2, n_irr, U, env, (cudaStream_t)stream)
                      : (int)cudaErrorInvalidValue;
  if (bf16 & 1)
    return launch_env_scatter(sh, static_cast<const bf16_t*>(wexp), row_ptr, dim_to_irr, n_atoms,
                              d2, n_irr, U, env, (cudaStream_t)stream);
  return launch_env_scatter(sh, static_cast<const float*>(wexp), row_ptr, dim_to_irr, n_atoms, d2,
                            n_irr, U, env, (cudaStream_t)stream);
}

// bf16: wexp is __nv_bfloat16, else float.
int atpt_unweight_sh(const float* t, const void* wexp, const int* centers,
                     const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr,
                     int U, float* dsh, int bf16, void* stream) {
  if (bf16)
    return launch_unweight_sh(t, static_cast<const bf16_t*>(wexp), centers, dim_to_irr, n_edges,
                              n_atoms, d2, n_irr, U, dsh, (cudaStream_t)stream);
  return launch_unweight_sh(t, static_cast<const float*>(wexp), centers, dim_to_irr, n_edges,
                            n_atoms, d2, n_irr, U, dsh, (cudaStream_t)stream);
}

// dim_to_irr [d2]: each irrep's dims one contiguous range, the irreps in order.
// bf16: bit 0, dwexp is __nv_bfloat16 (the env weights' storage), else
// float; bit 1 (with bit 0), sh is __nv_bfloat16 too (a bfloat16 model's).
int atpt_unweight_w(const float* t, const void* sh_, const int* centers, const int* dim_to_irr,
                    long long n_edges, int n_atoms, int d2, int n_irr, int U, void* dwexp,
                    int bf16, void* stream) {
  const auto* sh = static_cast<const float*>(sh_);
  if (bf16 & 2)
    return (bf16 & 1) ? launch_unweight_w(t, static_cast<const bf16_t*>(sh_), centers,
                                          dim_to_irr, n_edges, n_atoms, d2, n_irr, U,
                                          static_cast<bf16_t*>(dwexp), (cudaStream_t)stream)
                      : (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_unweight_w(t, sh, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U,
                             static_cast<bf16_t*>(dwexp), (cudaStream_t)stream);
  return launch_unweight_w(t, sh, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U,
                           static_cast<float*>(dwexp), (cudaStream_t)stream);
}

// dim_to_irr [d2]: each irrep's dims one contiguous range, the irreps in order.
// bf16: bit 0, wexp is __nv_bfloat16, else float; bit 1 (with bit 0 and
// bf16_out), sh is __nv_bfloat16 too (a bfloat16 model's); bf16_out: dwexp
// is __nv_bfloat16 (only with a bf16 wexp), else float; dsh is float either
// way.
int atpt_unweight_both(const float* t, const void* sh_, const void* wexp, const int* centers,
                       const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr,
                       int U, float* dsh, void* dwexp, int bf16, int bf16_out, void* stream) {
  const auto s = (cudaStream_t)stream;
  const auto* sh = static_cast<const float*>(sh_);
  if (bf16 & 2)
    return (bf16 & 1) && bf16_out
               ? launch_unweight_both(t, static_cast<const bf16_t*>(sh_),
                                      static_cast<const bf16_t*>(wexp), centers, dim_to_irr,
                                      n_edges, n_atoms, d2, n_irr, U, dsh,
                                      static_cast<bf16_t*>(dwexp), s)
               : (int)cudaErrorInvalidValue;
  if (!bf16)
    return bf16_out ? (int)cudaErrorInvalidValue
                    : launch_unweight_both(t, sh, static_cast<const float*>(wexp), centers,
                                           dim_to_irr, n_edges, n_atoms, d2, n_irr, U, dsh,
                                           static_cast<float*>(dwexp), s);
  const auto* w = static_cast<const bf16_t*>(wexp);
  if (bf16_out)
    return launch_unweight_both(t, sh, w, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U,
                                dsh, static_cast<bf16_t*>(dwexp), s);
  return launch_unweight_both(t, sh, w, centers, dim_to_irr, n_edges, n_atoms, d2, n_irr, U, dsh,
                              static_cast<float*>(dwexp), s);
}

}  // extern "C"
