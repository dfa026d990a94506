// The sparse Clebsch-Gordan tensor product for Hopper (sm_90a), float32, and
// its weight gradient, on a second input read per edge (the `pallas`
// backend) or gathered by the edge's center (the `fused` and `fused_infer`
// backends):
//
//   sparse_tp        out[e, kU+u] = sum_n c_n w[p_n, u] a[e, i_nU+u] b[e, j_nU+u]
//   sparse_tp_gradw  gw[p, u]     = sum_e sum_{n: p_n=p} c_n a[e, i_nU+u] b[e, j_nU+u] g[e, k_nU+u]
//   gather_tp        out[e, kU+u] = sum_n c_n w[p_n, u] x[e, i_nU+u] env[c(e), j_nU+u]
//                    (optionally also ts[e, u] = out[e, u], the leading 0e block)
//   gather_dw        dw[p, u]     = sum_e sum_{n: p_n=p} c_n x[e, i_nU+u] env[c(e), j_nU+u] g[e, k_nU+u]
//   tp_scatter       denv[a, kU+u] = sum_{c(e)=a} sum_n c_n w[p_n, u] x[e, i_nU+u] g[e, j_nU+u]
//                    (the table's roles permuted so that out is gather_tp's env)
//   bwd_fused        gather_tp's backward in x and env: gather_tp's walk on the
//                    role-swapped table (dx) and tp_scatter's (denv) in one pass
//
// The `pallas` backend (`tp_kernel_backend="pallas"`) sums the environment
// first (on the center kernels, csrc/center_readout.cu) and then contracts
// two per-edge arrays: nothing is gathered by center in sparse_tp and
// sparse_tp_gradw, every row of a, b, g and out belongs to one edge. The
// fused backends keep the environment per atom and gather_tp / gather_dw read
// row c(e) of it for each edge, and tp_scatter sums its per-edge out rows
// over each atom's edges (see their sections below).
// The table is the caller's: the layer's own, or one of its role
// permutations (the transposes of the derivative families,
// allegro_tpu_torch/ops/tp_primitives.py and ops/fused_primitives.py), so
// the inputs and out may have any of the layer's dims in any order. All six
// kernels walk it by path, not by entry (gen_cg_blocks.path_table(by_output=True):
// rows (p, triple id, i0, j0, k0, n0, n1, width) ordered by output slice k0,
// then p). A path with l <= 3 is one block of cg_blocks.h (CgBlock::fwd: its
// coefficients are literals in straight-line FMAs on register arrays) times
// the row's scale; a path beyond the header (l > 3) walks its entries
// [n0, n1) one by one, those whose output row falls in the row's slice
// [k0, k0 + width).
// Layout: per-edge arrays are row-major with the flat dim-major track
// (column i*U+u is basis dim i, channel u), w and gw are [P, U]. Padded
// edges of the per-edge kernels are rows like any other: the caller's
// cotangents are zero there.
// The bf16 tensor track (the model's tensor_dtype="bfloat16"): gather_tp,
// gather_dw, tp_scatter and bwd_fused have bf16 forms, templated on the
// track's storage (Tt = __nv_bfloat16): x and g (or g in x's role), and
// gather_tp's and bwd_fused's per-edge out, are bf16, widened to float as
// they are staged into the same float columns (stage_column), so every sum
// and the shared memory are the float32 forms'; env, w, ts, denv and dw stay
// float32.
// Every sum runs in a fixed order (no atomics), so two identical calls give
// identical bits. Each kernel runs on the caller's stream and allocates
// nothing; each entry point returns cudaGetLastError().

#include "common.cu"
#include "cg_blocks.h"

namespace {

constexpr int kTpThreads = kEdgeWarps * kWarp;  // threads per block of sparse_tp
constexpr int kMaxTpDim = 32;                   // basis dims of a, b, out (l_max 3, both parities)
constexpr int kSliceMax = 7;       // the widest output slice of a row: gen_cg_blocks.SLICE_MAX
constexpr int kDescCols = 8;       // (p, triple id, i0, j0, k0, n0, n1, width)
constexpr int kGradwMaxBlocks = 1024;  // blocks of gradw's first pass

// Copies the path table into shared memory.
__device__ __forceinline__ void load_desc(const int* __restrict__ desc, int n_rows, int* s_desc) {
  for (int q = threadIdx.x; q < n_rows * kDescCols; q += blockDim.x) s_desc[q] = desc[q];
}

// Starts the cp.async copy of column u of an edge's rows (d rows at stride
// U in device memory, from src) into a thread's shared-memory column (stride
// T, from dst). The caller commits and waits.
__device__ __forceinline__ void stage_column(const float* src, int d, int U, float* dst, int T) {
  for (int i = 0; i < d; ++i) cp_async4(dst + i * T, src + (long long)i * U);
}

// The same from the bf16 track: each element widened to float as it is
// stored, so the column is the float one (cp.async copies bytes and cannot
// widen; the loads are synchronous and read 64 coalesced bytes a warp row).
__device__ __forceinline__ void stage_column(const __nv_bfloat16* src, int d, int U, float* dst,
                                             int T) {
  for (int i = 0; i < d; ++i) dst[i * T] = load_f(src + (long long)i * U);
}

// ---------------------------------------------------------------------------
// sparse_tp
// Replaces allegro_tpu/ops/pallas_contract.py:_tp_kernel (_run_tp, lowered
// through ops/tp_primitives.py:tp): the forward of the `pallas` backend and,
// on the permuted tables, both input transposes.
// Bound: one read each of a [E, d1*U] and b [E, d2*U] and one write of out
// [E, d3*U] (3 x 119 MB at layer 0 of the 4,096-atom crystal, ~0.107 ms at
// 3.35 TB/s); the ~3 FLOPs per entry, edge and channel are an order of
// magnitude below that. Design: output-stationary path walk, one thread per
// (edge, channel), consecutive channels on consecutive lanes, so every row
// access is coalesced and any U works; a persistent grid strides over the
// (edge, channel) items. Once per block: the path table and ws[row, u] =
// w[p, u] * scale[row] go into shared memory, one load per path and lane.
// Per item: the thread's a and b columns are copied into its own
// shared-memory columns (stride = block size: no bank conflicts) by
// cp.async, all in flight at once and holding no registers. (A second
// buffer that loads the next item during this one measured slower: it
// halves the blocks per SM.) Per row (warp-uniform: every thread
// walks the same table, so the block's switch does not diverge): the x and e
// slices into registers, CgBlock::fwd onto the register accumulator of the
// current output slice; when the slice changes it is stored once, straight
// to device memory, and the rows of out that no path writes are stored as
// zeros. No shared-memory read-modify-write is left on a path with l <= 3.
// ---------------------------------------------------------------------------

// One row of sparse_tp for one thread: adds the path's block, its x slice
// times ws, onto the slice accumulator.
struct TpRow {
  const float* x;  // the thread's a column, stride T
  const float* e;  // its b column
  int T, i0, j0;
  float ws;  // w[p, u] times the row's scale
  float acc[kSliceMax];

  template <int L1, int L2, int L3>
  __device__ __forceinline__ void run() {
    constexpr int n1 = 2 * L1 + 1, n2 = 2 * L2 + 1, n3 = 2 * L3 + 1;
    float xs[n1], es[n2], os[n3];
#pragma unroll
    for (int a = 0; a < n1; ++a) xs[a] = ws * x[(i0 + a) * T];
#pragma unroll
    for (int b = 0; b < n2; ++b) es[b] = e[(j0 + b) * T];
#pragma unroll
    for (int c = 0; c < n3; ++c) os[c] = acc[c];
    CgBlock<L1, L2, L3>::fwd(xs, es, os);
#pragma unroll
    for (int c = 0; c < n3; ++c) acc[c] = os[c];
  }

  // A path beyond the header: its entries one by one (k0, width: the row's slice).
  __device__ __forceinline__ void entries(const int* __restrict__ eidx,
                                          const float* __restrict__ ecoef, int n0, int n1,
                                          int k0, int width) {
    for (int n = n0; n < n1; ++n) {
      const int k = __ldg(eidx + 4 * n + 2) - k0;
      if (k < 0 || k >= width) continue;
      const float v = __ldg(ecoef + n) * ws * x[__ldg(eidx + 4 * n) * T] *
                      e[__ldg(eidx + 4 * n + 1) * T];
#pragma unroll
      for (int c = 0; c < kSliceMax; ++c)
        if (c == k) acc[c] += v;
    }
  }
};

// Rows [k0, k0 + width) of one output column (row stride U) from acc, in
// the column's storage type (To: float, or __nv_bfloat16 for the bf16 track).
template <typename To>
__device__ __forceinline__ void store_slice(To* o, const float (&acc)[kSliceMax], int k0,
                                            int width, int U) {
#pragma unroll
  for (int c = 0; c < kSliceMax; ++c)
    if (c < width) store_f(o + (long long)(k0 + c) * U, acc[c]);
}

__global__ void __launch_bounds__(kTpThreads) sparse_tp_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ w,
    const int* __restrict__ desc, const float* __restrict__ dscale, int n_rows,
    const int* __restrict__ eidx, const float* __restrict__ ecoef, long long n_edges, int d1,
    int d2, int d3, int U, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  int4* s_desc = reinterpret_cast<int4*>(smem);  // [n_rows][kDescCols]
  float* s_ws = smem + n_rows * kDescCols;        // [n_rows][U]
  float* s_col = s_ws + n_rows * U;               // [d1 + d2][T]
  load_desc(desc, n_rows, reinterpret_cast<int*>(s_desc));
  __syncthreads();
  for (int q = tid; q < n_rows * U; q += T) {
    const int r = q / U;
    s_ws[q] = w[s_desc[2 * r].x * U + (q - r * U)] * dscale[r];
  }
  __syncthreads();
  float* col = s_col + tid;  // the thread's a and b columns
  const long long work = n_edges * U;
  for (long long t = (long long)blockIdx.x * T + tid; t < work; t += (long long)gridDim.x * T) {
    const long long e = t / U;
    const int u = (int)(t - e * U);
    stage_column(a + e * d1 * U + u, d1, U, col, T);
    stage_column(b + e * d2 * U + u, d2, U, col + d1 * T, T);
    cp_async_commit();
    cp_async_wait<0>();
    float* o = out + e * d3 * U + u;
    TpRow f{col, col + d1 * T, T, 0, 0, 0.f, {}};
    int k0 = -1, width = 0, next = 0;  // the current slice; the first row no slice has written
    for (int q = 0; q < n_rows; ++q) {
      // (p, triple id, i0, j0) and (k0, n0, n1, width)
      const int4 dp = s_desc[2 * q], dk = s_desc[2 * q + 1];
      if (dk.x != k0) {
        if (k0 >= 0) {
          store_slice(o, f.acc, k0, width, U);
          next = k0 + width;
        }
        k0 = dk.x;
        width = dk.w;
        for (int k = next; k < k0; ++k) o[(long long)k * U] = 0.f;
#pragma unroll
        for (int c = 0; c < kSliceMax; ++c) f.acc[c] = 0.f;
      }
      f.i0 = dp.z;
      f.j0 = dp.w;
      f.ws = s_ws[q * U + u];
      if (!cg_dispatch(dp.y, f)) f.entries(eidx, ecoef, dk.y, dk.z, k0, width);
    }
    if (k0 >= 0) {
      store_slice(o, f.acc, k0, width, U);
      next = k0 + width;
    }
    for (int k = next; k < d3; ++k) o[(long long)k * U] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// sparse_tp_gradw
// Replaces allegro_tpu/ops/pallas_contract.py:_gradw_kernel (_run_gradw,
// lowered through ops/tp_primitives.py:tp_gradw): the weight transpose of
// sparse_tp, whose own transposes are sparse_tp on permuted tables.
// Bound: one read each of a, b and g (3 x 119 MB at layer 0 of the 4,096-atom
// crystal, ~0.107 ms); the output [P, U] is tiny. Design: a reduction of all
// edges into [P, U]. The TPU kernel carries the sum from one grid step to the
// next; here a fixed grid of blocks (a function of E only) each sums a fixed,
// strided share of the edges and writes its partial [P, U], and a second
// launch adds the partials in block order. A block is U x (edges per step)
// threads, so each thread keeps one channel u for the whole pass, with its
// P sums in its own shared-memory column. Per edge the thread's a, b and g
// columns are copied into its own columns by cp.async, as in sparse_tp; per
// row, t = CgBlock::fwd(x, e) runs in registers and scale * dot(t, g slice)
// is added to the path's sum: one shared-memory update per path, edge and
// channel. The block's columns of one channel are added in a fixed order at
// the end. No float atomics: two identical calls give identical bits.
// ---------------------------------------------------------------------------

// One row of sparse_tp_gradw for one thread: dot = sum_c fwd(x, e)[c] g[k0 + c].
struct GradwRow {
  const float* x;  // the thread's a, b and g columns, stride T
  const float* e;
  const float* g;
  int T, i0, j0, k0;
  float dot;

  template <int L1, int L2, int L3>
  __device__ __forceinline__ void run() {
    constexpr int n1 = 2 * L1 + 1, n2 = 2 * L2 + 1, n3 = 2 * L3 + 1;
    float xs[n1], es[n2], os[n3];
#pragma unroll
    for (int a = 0; a < n1; ++a) xs[a] = x[(i0 + a) * T];
#pragma unroll
    for (int b = 0; b < n2; ++b) es[b] = e[(j0 + b) * T];
#pragma unroll
    for (int c = 0; c < n3; ++c) os[c] = 0.f;
    CgBlock<L1, L2, L3>::fwd(xs, es, os);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < n3; ++c) s = fmaf(os[c], g[(k0 + c) * T], s);
    dot = s;
  }

  // A path beyond the header: its entries one by one (width: the row's slice).
  __device__ __forceinline__ float entries(const int* __restrict__ eidx,
                                           const float* __restrict__ ecoef, int n0, int n1,
                                           int width) const {
    float s = 0.f;
    for (int n = n0; n < n1; ++n) {
      const int k = __ldg(eidx + 4 * n + 2);
      if (k < k0 || k >= k0 + width) continue;
      s += __ldg(ecoef + n) * x[__ldg(eidx + 4 * n) * T] * e[__ldg(eidx + 4 * n + 1) * T] *
           g[k * T];
    }
    return s;
  }
};

__global__ void sparse_tp_gradw_partial_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ g,
    const int* __restrict__ desc, const float* __restrict__ dscale, int n_rows,
    const int* __restrict__ eidx, const float* __restrict__ ecoef, long long n_edges, int d1,
    int d2, int d3, int U, int P, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int epb = T / U, slot = tid / U, u = tid - slot * U;
  int4* s_desc = reinterpret_cast<int4*>(smem);  // [n_rows][kDescCols]
  float* s_scale = smem + n_rows * kDescCols;     // [n_rows]
  float* s_acc = s_scale + n_rows;                // [P][T]
  float* s_col = s_acc + P * T;                   // [d1 + d2 + d3][T]
  load_desc(desc, n_rows, reinterpret_cast<int*>(s_desc));
  for (int q = tid; q < n_rows; q += T) s_scale[q] = dscale[q];
  for (int p = 0; p < P; ++p) s_acc[p * T + tid] = 0.f;
  __syncthreads();
  float* col = s_col + tid;  // the thread's a, b and g columns
  for (long long e = (long long)blockIdx.x * epb + slot; e < n_edges;
       e += (long long)gridDim.x * epb) {
    stage_column(a + e * d1 * U + u, d1, U, col, T);
    stage_column(b + e * d2 * U + u, d2, U, col + d1 * T, T);
    stage_column(g + e * d3 * U + u, d3, U, col + (d1 + d2) * T, T);
    cp_async_commit();
    cp_async_wait<0>();
    GradwRow f{col, col + d1 * T, col + (d1 + d2) * T, T, 0, 0, 0, 0.f};
    for (int q = 0; q < n_rows; ++q) {
      // (p, triple id, i0, j0) and (k0, n0, n1, width)
      const int4 dp = s_desc[2 * q], dk = s_desc[2 * q + 1];
      f.i0 = dp.z;
      f.j0 = dp.w;
      f.k0 = dk.x;
      float* acc = s_acc + dp.x * T + tid;
      if (cg_dispatch(dp.y, f))
        *acc = fmaf(s_scale[q], f.dot, *acc);
      else
        *acc += f.entries(eidx, ecoef, dk.y, dk.z, dk.w);
    }
  }
  __syncthreads();
  const int PU = P * U;
  for (int q = tid; q < PU; q += T) {
    const int p = q / U, uu = q - p * U;
    float s = 0.f;
    for (int sl = 0; sl < epb; ++sl) s += s_acc[p * T + sl * U + uu];
    partial[(long long)blockIdx.x * PU + q] = s;
  }
}

// Checks the sizes both kernels take; 0 or a CUDA error code.
int check_tp_dims(int d1, int d2, int d3, int P, int n_rows) {
  if (d1 < 1 || d2 < 1 || d3 < 1 || d1 > kMaxTpDim || d2 > kMaxTpDim || d3 > kMaxTpDim ||
      P < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ---------------------------------------------------------------------------
// gather_tp, gather_dw
// gather_tp replaces allegro_tpu/ops/fused_tp.py:_gather_tp_raw_kernel
// (gather_tp_raw_call) and, on the role-swapped table, _gather_tp_kernel
// (gather_tp_call), whose two env windows are one env array here: the
// forward of the fused backends and the x-transpose of the trainable one.
// gather_dw replaces _gather_dw_kernel (gather_dw_call), gather_tp's weight
// transpose. They are sparse_tp's and sparse_tp_gradw's walks (TpRow,
// GradwRow, the same path table) with the b column read from env
// [n_atoms, d2*U] at row c(e), the edge's center.
// Bound: one read of x [E, d1*U] and one write of out [E, d3*U] (gather_tp),
// one read each of x and g (gather_dw); the env rows (4.7 MB at the flagship,
// 8.4 MB at l_max 3) are re-read by the ~25 consecutive edges of an atom and
// stay in L1/L2. Design: as sparse_tp (one thread per (edge, channel), a
// persistent grid, the x and env columns into the thread's shared-memory
// columns by cp.async, each output slice summed in registers over its rows
// and stored once) and sparse_tp_gradw (a fixed grid of E alone, each path's
// block dotted with g's slice into the thread's shared-memory column of path
// sums, the partials added in block order). What the gather adds: a sentinel
// edge (center n_atoms, after row_ptr[n_atoms]) reads nothing, since its
// padded x row may hold anything: gather_tp stores zeros to its out row (and
// ts), gather_dw skips it. With ts (the split scalar output), row 0 of the
// slice that starts at 0 goes to ts from the same register as to out, so
// ts == out[:, :U] bit for bit.
// Kernels of their own, not a template shared with sparse_tp and
// sparse_tp_gradw: that template compiled kernels 20 and 21 to other
// schedules (the same registers) that measured ~3% slower at the l_max-3
// shapes on the H100. gather_tp's launch bounds hold it to 48 registers (56
// without them: 9 blocks per SM instead of 10), 3-4% faster; at 12 blocks
// per SM it spills.
// ---------------------------------------------------------------------------

constexpr int kGatherMinBlocks = 10;  // gather_tp's blocks per SM: at most 51 registers a thread

// The env row edge e reads: its center, or -1 for a sentinel edge (a center
// outside [0, n_atoms)).
__device__ __forceinline__ int center_row(const int* __restrict__ centers, long long e,
                                          int n_atoms) {
  const int c = __ldg(centers + e);
  return c >= 0 && c < n_atoms ? c : -1;
}

// One element of ts (none where p is null): float, or __nv_bfloat16 (a
// bfloat16 model's split scalars, JAX's scalar_dtype) rounded once.
struct TsOut {
  float* p;
  bool bf16;
  __device__ __forceinline__ void store(float v) const {
    if (bf16)
      store_f(reinterpret_cast<__nv_bfloat16*>(p), v);
    else
      *p = v;
  }
};

// The ts element of (edge e, channel u).
__device__ __forceinline__ TsOut ts_at(float* ts, bool bf16, long long q) {
  if (!ts) return {nullptr, false};
  return {bf16 ? reinterpret_cast<float*>(reinterpret_cast<__nv_bfloat16*>(ts) + q) : ts + q,
          bf16};
}

// Zeros to rows [k0, k1) of one output column, and to ts where row 0 is one.
template <typename To>
__device__ __forceinline__ void zero_rows(To* o, TsOut ts, int k0, int k1, int U) {
  for (int k = k0; k < k1; ++k) store_f(o + (long long)k * U, 0.f);
  if (ts.p && k0 == 0 && k1 > 0) ts.store(0.f);
}

// store_slice, and with ts row 0 there too, from the same register (ts is
// stored in its own type whatever out's storage: on the bf16 track out is
// rounded, ts not).
template <typename To>
__device__ __forceinline__ void store_slice_ts(To* o, TsOut ts,
                                               const float (&acc)[kSliceMax], int k0, int width,
                                               int U) {
  store_slice(o, acc, k0, width, U);
  if (ts.p && k0 == 0) ts.store(acc[0]);
}

template <typename Tt>
__global__ void __launch_bounds__(kTpThreads, kGatherMinBlocks) gather_tp_kernel(
    const Tt* __restrict__ x, const float* __restrict__ env, const float* __restrict__ w,
    const int* __restrict__ centers, const int* __restrict__ desc,
    const float* __restrict__ dscale, int n_rows, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, long long n_edges, int n_atoms, int d1, int d2, int d3,
    int U, Tt* __restrict__ out, float* __restrict__ ts, bool ts_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  int4* s_desc = reinterpret_cast<int4*>(smem);  // [n_rows][kDescCols]
  float* s_ws = smem + n_rows * kDescCols;        // [n_rows][U]
  float* s_col = s_ws + n_rows * U;               // [d1 + d2][T]
  load_desc(desc, n_rows, reinterpret_cast<int*>(s_desc));
  __syncthreads();
  for (int q = tid; q < n_rows * U; q += T) {
    const int r = q / U;
    s_ws[q] = w[s_desc[2 * r].x * U + (q - r * U)] * dscale[r];
  }
  __syncthreads();
  float* col = s_col + tid;  // the thread's x and env columns
  const long long work = n_edges * U;
  for (long long t = (long long)blockIdx.x * T + tid; t < work; t += (long long)gridDim.x * T) {
    const long long e = t / U;
    const int u = (int)(t - e * U);
    Tt* o = out + e * d3 * U + u;
    const TsOut tso = ts_at(ts, ts_bf16, e * U + u);
    const int ctr = center_row(centers, e, n_atoms);
    if (ctr < 0) {  // a sentinel edge: a zero row
      zero_rows(o, tso, 0, d3, U);
      continue;
    }
    stage_column(x + e * d1 * U + u, d1, U, col, T);
    stage_column(env + (long long)ctr * d2 * U + u, d2, U, col + d1 * T, T);
    cp_async_commit();
    cp_async_wait<0>();
    TpRow f{col, col + d1 * T, T, 0, 0, 0.f, {}};
    int k0 = -1, width = 0, next = 0;  // the current slice; the first row no slice has written
    for (int q = 0; q < n_rows; ++q) {
      // (p, triple id, i0, j0) and (k0, n0, n1, width)
      const int4 dp = s_desc[2 * q], dk = s_desc[2 * q + 1];
      if (dk.x != k0) {
        if (k0 >= 0) {
          store_slice_ts(o, tso, f.acc, k0, width, U);
          next = k0 + width;
        }
        k0 = dk.x;
        width = dk.w;
        zero_rows(o, tso, next, k0, U);
#pragma unroll
        for (int c = 0; c < kSliceMax; ++c) f.acc[c] = 0.f;
      }
      f.i0 = dp.z;
      f.j0 = dp.w;
      f.ws = s_ws[q * U + u];
      if (!cg_dispatch(dp.y, f)) f.entries(eidx, ecoef, dk.y, dk.z, k0, width);
    }
    if (k0 >= 0) {
      store_slice_ts(o, tso, f.acc, k0, width, U);
      next = k0 + width;
    }
    zero_rows(o, tso, next, d3, U);
  }
}

template <typename Tt>
__global__ void gather_dw_partial_kernel(
    const Tt* __restrict__ x, const float* __restrict__ env, const Tt* __restrict__ g,
    const int* __restrict__ centers, const int* __restrict__ desc,
    const float* __restrict__ dscale, int n_rows, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, long long n_edges, int n_atoms, int d1, int d2, int d3,
    int U, int P, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int epb = T / U, slot = tid / U, u = tid - slot * U;
  int4* s_desc = reinterpret_cast<int4*>(smem);  // [n_rows][kDescCols]
  float* s_scale = smem + n_rows * kDescCols;     // [n_rows]
  float* s_acc = s_scale + n_rows;                // [P][T]
  float* s_col = s_acc + P * T;                   // [d1 + d2 + d3][T]
  load_desc(desc, n_rows, reinterpret_cast<int*>(s_desc));
  for (int q = tid; q < n_rows; q += T) s_scale[q] = dscale[q];
  for (int p = 0; p < P; ++p) s_acc[p * T + tid] = 0.f;
  __syncthreads();
  float* col = s_col + tid;  // the thread's x, env and g columns
  for (long long e = (long long)blockIdx.x * epb + slot; e < n_edges;
       e += (long long)gridDim.x * epb) {
    const int ctr = center_row(centers, e, n_atoms);
    if (ctr < 0) continue;  // a sentinel edge adds nothing
    stage_column(x + e * d1 * U + u, d1, U, col, T);
    stage_column(env + (long long)ctr * d2 * U + u, d2, U, col + d1 * T, T);
    stage_column(g + e * d3 * U + u, d3, U, col + (d1 + d2) * T, T);
    cp_async_commit();
    cp_async_wait<0>();
    GradwRow f{col, col + d1 * T, col + (d1 + d2) * T, T, 0, 0, 0, 0.f};
    for (int q = 0; q < n_rows; ++q) {
      // (p, triple id, i0, j0) and (k0, n0, n1, width)
      const int4 dp = s_desc[2 * q], dk = s_desc[2 * q + 1];
      f.i0 = dp.z;
      f.j0 = dp.w;
      f.k0 = dk.x;
      float* acc = s_acc + dp.x * T + tid;
      if (cg_dispatch(dp.y, f))
        *acc = fmaf(s_scale[q], f.dot, *acc);
      else
        *acc += f.entries(eidx, ecoef, dk.y, dk.z, dk.w);
    }
  }
  __syncthreads();
  const int PU = P * U;
  for (int q = tid; q < PU; q += T) {
    const int p = q / U, uu = q - p * U;
    float s = 0.f;
    for (int sl = 0; sl < epb; ++sl) s += s_acc[p * T + sl * U + uu];
    partial[(long long)blockIdx.x * PU + q] = s;
  }
}

// ---------------------------------------------------------------------------
// tp_scatter
// Replaces allegro_tpu/ops/fused_tp.py:_tp_scatter_kernel (tp_scatter_call):
// gather_tp's env transpose, denv[a, jU+u] = sum_{c(e)=a} sum_n c_n w[p_n,u]
// x[e, i_nU+u] g[e, k_nU+u], on the layer's table or its role swap. Its out
// is the table's middle role, so it walks the path table of that table with
// roles (0, 2, 1) (a = x over i, b = g over k, out = j; built once per layer,
// nn/contract.py:Contracter.scatter_paths): per edge, sparse_tp's walk.
// Bound: one read each of x [E, d1*U] and g [E, d3*U] and one write of denv
// [n_atoms, d2*U] (237 MB, ~0.071 ms at 3.35 TB/s, at the flagship's layer 0
// on the 1k training batch); the ~3 FLOPs per entry, edge and channel take
// ~17% of that time at 83 entries and ~40% at 353.
// Design: one block per atom; its threads are (chunk q, channel u), U
// channels on consecutive lanes (every row access coalesced, any U) and
// T / U chunks. Chunk q walks the edges row_ptr[a] + q + n T / U (n = 0,
// 1, ...) of the segment in edge order: per edge, its x and g columns go
// into the thread's own shared-memory columns by cp.async, then TpRow walks
// the rows, each output slice summed in registers over its rows and added once
// per edge to the thread's shared-memory column of the atom's denv. At the
// end the chunks' columns are added in chunk order and the row is stored
// once, coalesced. An atom without edges stores a zero row; sentinel edges
// lie after row_ptr[n_atoms] and are never read. No float atomics: two
// identical calls give identical bits. Measured on the H100 and not kept: a
// second column buffer loading the next edge during this one (3-7% slower:
// fewer blocks per SM, as in sparse_tp), a persistent grid striding over
// the atoms (up to 9% slower: the card's block scheduler balances segments
// of unequal length better), and __launch_bounds__(128, 10) (48 registers
// instead of 56-64, 1-2% faster, but it would cap U at 128).
// ---------------------------------------------------------------------------

// Starts the cp.async copies of edge e's x and g columns (channel u) into a
// thread's columns at col (stride T).
template <typename Tt>
__device__ __forceinline__ void stage_scatter_edge(const Tt* __restrict__ x,
                                                   const Tt* __restrict__ g, long long e,
                                                   int d1, int d3, int U, int u, float* col,
                                                   int T) {
  stage_column(x + e * d1 * U + u, d1, U, col, T);
  stage_column(g + e * d3 * U + u, d3, U, col + d1 * T, T);
}

// Adds one output slice's accumulator to the thread's denv column (stride T).
__device__ __forceinline__ void add_slice(float* den, const float (&acc)[kSliceMax], int k0,
                                          int width, int T) {
#pragma unroll
  for (int c = 0; c < kSliceMax; ++c)
    if (c < width) den[(k0 + c) * T] += acc[c];
}

template <typename Tt>
__global__ void tp_scatter_kernel(const Tt* __restrict__ x, const Tt* __restrict__ g,
                                  const float* __restrict__ w, const int* __restrict__ row_ptr,
                                  const int* __restrict__ desc, const float* __restrict__ dscale,
                                  int n_rows, const int* __restrict__ eidx,
                                  const float* __restrict__ ecoef, int d1, int d2, int d3,
                                  int U, float* __restrict__ denv) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x, a = blockIdx.x;
  const int chunks = T / U, q = tid / U, u = tid - q * U;
  int4* s_desc = reinterpret_cast<int4*>(smem);  // [n_rows][kDescCols]
  float* s_ws = smem + n_rows * kDescCols;        // [n_rows][U]
  float* s_den = s_ws + n_rows * U;               // [d2][T]
  float* s_col = s_den + d2 * T;                  // [d1 + d3][T]
  float* den = s_den + tid;  // the thread's column of the atom's denv
  float* col = s_col + tid;  // its x and g columns
  load_desc(desc, n_rows, reinterpret_cast<int*>(s_desc));
  for (int k = 0; k < d2; ++k) den[k * T] = 0.f;
  __syncthreads();
  for (int r = tid; r < n_rows * U; r += T) {
    const int row = r / U;
    s_ws[r] = w[s_desc[2 * row].x * U + (r - row * U)] * dscale[row];
  }
  __syncthreads();
  const int end = row_ptr[a + 1];
  for (int e = row_ptr[a] + q; e < end; e += chunks) {
    stage_scatter_edge(x, g, e, d1, d3, U, u, col, T);
    cp_async_commit();
    cp_async_wait<0>();
    TpRow f{col, col + d1 * T, T, 0, 0, 0.f, {}};
    int k0 = -1, width = 0;  // the current slice
    for (int r = 0; r < n_rows; ++r) {
      // (p, triple id, i0, j0) and (k0, n0, n1, width)
      const int4 dp = s_desc[2 * r], dk = s_desc[2 * r + 1];
      if (dk.x != k0) {
        if (k0 >= 0) add_slice(den, f.acc, k0, width, T);
        k0 = dk.x;
        width = dk.w;
#pragma unroll
        for (int c = 0; c < kSliceMax; ++c) f.acc[c] = 0.f;
      }
      f.i0 = dp.z;
      f.j0 = dp.w;
      f.ws = s_ws[r * U + u];
      if (!cg_dispatch(dp.y, f)) f.entries(eidx, ecoef, dk.y, dk.z, k0, width);
    }
    add_slice(den, f.acc, k0, width, T);
  }
  __syncthreads();
  const int d2U = d2 * U;
  for (int c = tid; c < d2U; c += T) {
    const int k = c / U, uu = c - k * U;
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += s_den[k * T + ch * U + uu];
    denv[(long long)a * d2U + c] = s;
  }
}

// ---------------------------------------------------------------------------
// bwd_fused
// Replaces allegro_tpu/ops/fused_tp.py:_bwd_fused_raw_kernel
// (bwd_fused_raw_call): gather_tp's backward in x and env,
//   dx[e, iU+u]   = sum_n c_n w[p_n,u] g[e, k_nU+u] env[c(e), j_nU+u]
//   denv[a, jU+u] = sum_{c(e)=a} sum_n c_n w[p_n,u] x[e, i_nU+u] g[e, k_nU+u],
// optionally with g[e, u] += gts[e, u] (the cotangent of gather_tp's split
// output ts). Its weight-gradient variant (kernel 18, _bwd_fused_kernel)
// stays an entry loop in csrc/fused_tp.cu.
// Bound: one read each of x [E, d1*U] and g [E, d3*U], one write of dx
// [E, d1*U] and of denv [n_atoms, d2*U] (3 x 119 MB and 5 MB, ~0.108 ms at
// 3.35 TB/s, at the flagship's layer 0 on the 4,096-atom crystal); the ~6
// FLOPs per entry, edge and channel take ~23% of that time at 83 entries.
// Design: the two walks the port already has, in one pass over each atom's
// edges. dx is gather_tp's walk on the role-swapped table (a = g over k,
// b = env over j, out = i), denv tp_scatter's on the layer's table with
// roles (0, 2, 1) (a = x over i, b = g over k, out = j). One block per atom,
// threads (chunk q, channel u) as in tp_scatter. Once per block: both path
// tables and their ws into shared memory, and env[a] by cp.async, one
// [d2][U] row that the chunks share (EnvRow reads it at stride U): every edge
// of the block has the center a, so the env row is read once per atom, not
// once per edge. Per edge of chunk q, in edge order:
// the x and g columns by cp.async; with gts, gts[e, u] added to the thread's
// own g row 0, so that both walks see the folded value (as the TPU kernel
// folds it in VMEM); the dx walk stores each output slice once to dx[e],
// and the rows no path writes as zeros; the denv walk adds each slice once
// per edge to the thread's shared-memory denv column. At the end the chunks'
// columns are added in chunk order and denv[a] is stored once; an atom
// without edges stores a zero row. The sentinel edges lie after
// row_ptr[n_atoms]: one extra block zeroes their dx rows and reads nothing
// of them. Where the columns do not fit in shared memory, the launcher takes
// fewer chunks. No float atomics: two identical calls give identical bits.
// Measured on the H100 and not kept: an env column per thread (slower: fewer
// blocks per SM), a second x and g buffer loading the next edge during this
// one, __launch_bounds__(128, 12) (spills), 8 chunks at U = 32 and ws from
// one shared w [P][U] with per-row scales (each faster at l_max 3, slower at
// the flagship).
// ---------------------------------------------------------------------------

// Copies a path table into shared memory with ws[row, u] = w[p, u] * scale[row].
__device__ __forceinline__ void load_walk(const int* __restrict__ desc,
                                          const float* __restrict__ dscale, int n_rows,
                                          const float* __restrict__ w, int U, int* s_desc,
                                          float* s_ws) {
  load_desc(desc, n_rows, s_desc);
  for (int q = threadIdx.x; q < n_rows * U; q += blockDim.x) {
    const int r = q / U;
    s_ws[q] = __ldg(w + __ldg(desc + r * kDescCols) * U + (q - r * U)) * __ldg(dscale + r);
  }
}

// TpRow with its b column at a stride of its own: bwd_fused's dx walk reads
// the block's one staged env row [d2][U], which its chunks share.
struct EnvRow {
  const float* x;  // the thread's a column, stride T
  const float* e;  // channel u of the env row, stride U
  int T, U, i0, j0;
  float ws;  // w[p, u] times the row's scale
  float acc[kSliceMax];

  template <int L1, int L2, int L3>
  __device__ __forceinline__ void run() {
    constexpr int n1 = 2 * L1 + 1, n2 = 2 * L2 + 1, n3 = 2 * L3 + 1;
    float xs[n1], es[n2], os[n3];
#pragma unroll
    for (int a = 0; a < n1; ++a) xs[a] = ws * x[(i0 + a) * T];
#pragma unroll
    for (int b = 0; b < n2; ++b) es[b] = e[(j0 + b) * U];
#pragma unroll
    for (int c = 0; c < n3; ++c) os[c] = acc[c];
    CgBlock<L1, L2, L3>::fwd(xs, es, os);
#pragma unroll
    for (int c = 0; c < n3; ++c) acc[c] = os[c];
  }

  // A path beyond the header: its entries one by one (k0, width: the row's slice).
  __device__ __forceinline__ void entries(const int* __restrict__ eidx,
                                          const float* __restrict__ ecoef, int n0, int n1,
                                          int k0, int width) {
    for (int n = n0; n < n1; ++n) {
      const int k = __ldg(eidx + 4 * n + 2) - k0;
      if (k < 0 || k >= width) continue;
      const float v = __ldg(ecoef + n) * ws * x[__ldg(eidx + 4 * n) * T] *
                      e[__ldg(eidx + 4 * n + 1) * U];
#pragma unroll
      for (int c = 0; c < kSliceMax; ++c)
        if (c == k) acc[c] += v;
    }
  }
};

// One edge's walk over a path table's rows, the row f (TpRow or EnvRow)
// holding the thread's a and b columns: each output slice is summed in f.acc
// over its rows, and emit(k0, width) is called once per slice, when it is
// complete.
template <typename Row, typename Emit>
__device__ __forceinline__ void walk_slices(Row& f, const int4* s_desc, const float* s_ws,
                                            int n_rows, int U, int u,
                                            const int* __restrict__ eidx,
                                            const float* __restrict__ ecoef, Emit&& emit) {
  int k0 = -1, width = 0;  // the current slice
  for (int r = 0; r < n_rows; ++r) {
    // (p, triple id, i0, j0) and (k0, n0, n1, width)
    const int4 dp = s_desc[2 * r], dk = s_desc[2 * r + 1];
    if (dk.x != k0) {
      if (k0 >= 0) emit(k0, width);
      k0 = dk.x;
      width = dk.w;
#pragma unroll
      for (int c = 0; c < kSliceMax; ++c) f.acc[c] = 0.f;
    }
    f.i0 = dp.z;
    f.j0 = dp.w;
    f.ws = s_ws[r * U + u];
    if (!cg_dispatch(dp.y, f)) f.entries(eidx, ecoef, dk.y, dk.z, k0, width);
  }
  if (k0 >= 0) emit(k0, width);
}

template <typename Tt>
__global__ void bwd_fused_kernel(
    const Tt* __restrict__ x, const Tt* __restrict__ g, const float* __restrict__ gts,
    const float* __restrict__ env, const float* __restrict__ w, const int* __restrict__ row_ptr,
    const int* __restrict__ desc_dx, const float* __restrict__ scale_dx, int rows_dx,
    const int* __restrict__ eidx_dx, const float* __restrict__ ecoef_dx,
    const int* __restrict__ desc_den, const float* __restrict__ scale_den, int rows_den,
    const int* __restrict__ eidx_den, const float* __restrict__ ecoef_den, long long n_edges,
    int n_atoms, int d1, int d2, int d3, int U, Tt* __restrict__ dx,
    float* __restrict__ denv, bool gts_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x, a = blockIdx.x;
  if (a == n_atoms) {  // the sentinel edges' dx rows
    const long long d1U = (long long)d1 * U;
    for (long long t = (long long)row_ptr[n_atoms] * d1U + tid; t < n_edges * d1U; t += T)
      store_f(dx + t, 0.f);
    return;
  }
  const int chunks = T / U, q = tid / U, u = tid - q * U;
  int4* s_desc_dx = reinterpret_cast<int4*>(smem);   // [rows_dx][kDescCols]
  int4* s_desc_den = s_desc_dx + 2 * rows_dx;        // [rows_den][kDescCols]
  float* s_ws_dx = reinterpret_cast<float*>(s_desc_den + 2 * rows_den);  // [rows_dx][U]
  float* s_ws_den = s_ws_dx + rows_dx * U;           // [rows_den][U]
  float* s_env = s_ws_den + rows_den * U;            // [d2][U]: env[a]
  float* s_den = s_env + d2 * U;                     // [d2][T]
  float* den = s_den + tid;    // the thread's column of the atom's denv
  float* xcol = den + d2 * T;  // its x (d1 rows) and g (d3) columns
  float* gcol = xcol + d1 * T;
  load_walk(desc_dx, scale_dx, rows_dx, w, U, reinterpret_cast<int*>(s_desc_dx), s_ws_dx);
  load_walk(desc_den, scale_den, rows_den, w, U, reinterpret_cast<int*>(s_desc_den), s_ws_den);
  for (int k = 0; k < d2; ++k) den[k * T] = 0.f;
  const int d2U = d2 * U;
  for (int c = tid; c < d2U; c += T) cp_async4(s_env + c, env + (long long)a * d2U + c);
  const int first = row_ptr[a] + q, end = row_ptr[a + 1];
  if (first < end) stage_scatter_edge(x, g, first, d1, d3, U, u, xcol, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = first; e < end; e += chunks) {
    if (e != first) {
      stage_scatter_edge(x, g, e, d1, d3, U, u, xcol, T);
      cp_async_commit();
      cp_async_wait<0>();
    }
    if (gts)
      gcol[0] += gts_bf16 ? load_f(reinterpret_cast<const __nv_bfloat16*>(gts) + (long long)e * U + u)
                          : __ldg(gts + (long long)e * U + u);
    Tt* o = dx + (long long)e * d1 * U + u;
    int next = 0;  // the first row of dx no slice has written
    EnvRow fe{gcol, s_env + u, T, U, 0, 0, 0.f, {}};
    walk_slices(fe, s_desc_dx, s_ws_dx, rows_dx, U, u, eidx_dx, ecoef_dx,
                [&](int k0, int width) {
                  for (int k = next; k < k0; ++k) store_f(o + (long long)k * U, 0.f);
                  store_slice(o, fe.acc, k0, width, U);
                  next = k0 + width;
                });
    for (int k = next; k < d1; ++k) store_f(o + (long long)k * U, 0.f);
    TpRow f{xcol, gcol, T, 0, 0, 0.f, {}};
    walk_slices(f, s_desc_den, s_ws_den, rows_den, U, u, eidx_den, ecoef_den,
                [&](int k0, int width) { add_slice(den, f.acc, k0, width, T); });
  }
  __syncthreads();
  for (int c = tid; c < d2U; c += T) {
    const int k = c / U, uu = c - k * U;
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += s_den[k * T + ch * U + uu];
    denv[(long long)a * d2U + c] = s;
  }
}

}  // namespace

// bwd_fused without the weight gradient (csrc/fused_tp.cu's atpt_bwd_fused
// takes this path when dw is null): desc_dx ... ecoef_dx, the role-swapped
// table's path table; desc_den ... ecoef_den, the layer's table's with roles
// (0, 2, 1) (both in walk order, as in atpt_sparse_tp). The chunks per block
// start at kTpThreads / U and are halved while the block's shared memory
// does not fit on the card; 0 or a CUDA error code.
namespace {

template <typename Tt>
int launch_bwd_fused_walk_as(const Tt* x, const Tt* g, const float* gts, const float* env,
                             const float* w, const int* row_ptr, const int* desc_dx,
                             const float* scale_dx, int rows_dx, const int* eidx_dx,
                             const float* ecoef_dx, const int* desc_den, const float* scale_den,
                             int rows_den, const int* eidx_den, const float* ecoef_den,
                             long long n_edges, int n_atoms, int d1, int d2, int d3, int U, int P,
                             Tt* dx, float* denv, bool gts_bf16, cudaStream_t stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P, rows_dx)) return rc;
  if (rows_den < 1 || U < 1 || U > 1024) return (int)cudaErrorInvalidValue;
  int chunks = U < kTpThreads ? kTpThreads / U : 1;
  const auto bytes = [&] {
    return (size_t)(rows_dx + rows_den) * (kDescCols + U) * sizeof(float) +
           (size_t)d2 * U * sizeof(float) + (size_t)(d2 + d1 + d3) * U * chunks * sizeof(float);
  };
  const size_t limit = smem_optin();
  while (bytes() > limit && chunks > 1) chunks /= 2;
  cudaError_t err = prepare_smem(bwd_fused_kernel<Tt>, bytes());
  if (err != cudaSuccess) return (int)err;
  bwd_fused_kernel<Tt><<<n_atoms + 1, U * chunks, bytes(), stream>>>(
      x, g, gts, env, w, row_ptr, desc_dx, scale_dx, rows_dx, eidx_dx, ecoef_dx, desc_den,
      scale_den, rows_den, eidx_den, ecoef_den, n_edges, n_atoms, d1, d2, d3, U, dx, denv,
      gts_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: bit 0, x, g and dx are the bf16 track (__nv_bfloat16), otherwise
// float; bit 3, gts is __nv_bfloat16 (a bfloat16 model's); env and denv are
// float either way. The layout does not depend on it: the bf16 form widens
// x and g into the same float columns.
int launch_bwd_fused_walk(const void* x, const void* g, const float* gts, const float* env,
                          const float* w, const int* row_ptr, const int* desc_dx,
                          const float* scale_dx, int rows_dx, const int* eidx_dx,
                          const float* ecoef_dx, const int* desc_den, const float* scale_den,
                          int rows_den, const int* eidx_den, const float* ecoef_den,
                          long long n_edges, int n_atoms, int d1, int d2, int d3, int U, int P,
                          void* dx, float* denv, int bf16, cudaStream_t stream) {
  const bool gts_bf16 = bf16 & 8;
  if (bf16 & 1)
    return launch_bwd_fused_walk_as(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), gts, env, w,
        row_ptr, desc_dx, scale_dx, rows_dx, eidx_dx, ecoef_dx, desc_den, scale_den, rows_den,
        eidx_den, ecoef_den, n_edges, n_atoms, d1, d2, d3, U, P,
        static_cast<__nv_bfloat16*>(dx), denv, gts_bf16, stream);
  return launch_bwd_fused_walk_as(
      static_cast<const float*>(x), static_cast<const float*>(g), gts, env, w, row_ptr, desc_dx,
      scale_dx, rows_dx, eidx_dx, ecoef_dx, desc_den, scale_den, rows_den, eidx_den, ecoef_den,
      n_edges, n_atoms, d1, d2, d3, U, P, static_cast<float*>(dx), denv, gts_bf16, stream);
}

// ---------------------------------------------------------------------------
// sparse_tp, the bfloat16 form (a bfloat16 model's `pallas` layer)
// Replaces allegro_tpu/ops/pallas_contract.py:_tp_kernel (_run_tp) on
// bfloat16 operands. JAX's kernel does not promote there: in its table's
// entry order, t = a[i] b[j] (formed again where (i, j) changes), c w[p]
// with the Python float c taken to bfloat16, their product and each
// output's running sum are each rounded to bfloat16, and out is bfloat16.
// This form computes exactly that (each op in float, as XLA computes a
// bfloat16 op, then rounded), so it walks the entry table itself in its own
// order: the compiled CG blocks (csrc/cg_blocks.h) sum a path at a time,
// which is not the entry order where two paths share an i. Bound: the reads
// of a and b and the write of out, like the float form's; the entries (and
// c rounded once) sit in shared memory, one thread per (edge, channel)
// keeps its outputs' running sums in a local array, and every store is
// coalesced along the channels. The simple form: speed is later work.
// ---------------------------------------------------------------------------
constexpr int kBf16TpThreads = 256;
constexpr int kBf16TpMaxDim = 32;

__global__ void __launch_bounds__(kBf16TpThreads) sparse_tp_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ w, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, int n_entries, long long n_edges, int d1, int d2, int d3,
    int U, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  int4* s_idx = reinterpret_cast<int4*>(smem);                   // [n_entries] (i, j, k, p)
  float* s_c = reinterpret_cast<float*>(s_idx + n_entries);      // [n_entries] c in bf16
  for (int q = threadIdx.x; q < n_entries; q += blockDim.x) {
    s_idx[q] = make_int4(eidx[4 * q], eidx[4 * q + 1], eidx[4 * q + 2], eidx[4 * q + 3]);
    s_c[q] = bf16_round(ecoef[q]);
  }
  __syncthreads();
  const long long work = n_edges * U;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work;
       t += (long long)gridDim.x * blockDim.x) {
    const long long e = t / U;
    const int u = (int)(t - e * U);
    const __nv_bfloat16* ar = a + e * d1 * U + u;
    const __nv_bfloat16* br = b + e * d2 * U + u;
    float acc[kBf16TpMaxDim];
    unsigned set = 0;  // bit k: output k has its first contribution
    int ci = -1, cj = -1;
    float prod = 0.f;
    for (int n = 0; n < n_entries; ++n) {
      const int4 x = s_idx[n];
      if (x.x != ci || x.y != cj) {
        ci = x.x;
        cj = x.y;
        prod = bf16_round(load_f(ar + ci * U) * load_f(br + cj * U));
      }
      const float con = bf16_round(bf16_round(s_c[n] * load_f(w + x.w * U + u)) * prod);
      if (set >> x.z & 1) {
        acc[x.z] = bf16_round(acc[x.z] + con);
      } else {
        acc[x.z] = con;
        set |= 1u << x.z;
      }
    }
    __nv_bfloat16* o = out + e * d3 * U + u;
    for (int k = 0; k < d3; ++k) store_f(o + (long long)k * U, set >> k & 1 ? acc[k] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// sparse_tp_gradw, the bfloat16 form (a bfloat16 model's `pallas` training)
// Replaces allegro_tpu/ops/pallas_contract.py:_gradw_kernel (_run_gradw) on
// bfloat16 operands, and the fold of its lane-tiled [P, 128] output into
// [P, U] (the transpose of PallasTPBackend.tile_weights' jnp.tile). JAX sums
// on its packed layout: lane l = q*U + u of row r is channel u of edge
// r*Q + q (Q = 128 / U), and its grid steps are blocks of 64 rows. The
// semantics, established on JAX's CPU output (ops/pallas_contract.py:
// sparse_tp_gradw_bf16_reference): per block and lane, in the table's entry
// order, s = sum over the 64 rows of bf16(a[i] b[j]) * g[k] in float (each
// product exact, the rows in order), rounded; c s with c rounded to bf16,
// rounded; the path's running sum, rounded; then the blocks' sums added in
// block order and a channel's Q lanes in lane order, each add rounded. So
// this form sums the edges in JAX's groups, not in the float form's.
// Bound: one read each of a, b and g, as the float form's. Design: a warp
// per (block, 32 of its lanes), a thread per lane. Per row, the thread's a,
// b and g columns go into its shared-memory columns, widened (stride 32:
// no bank conflicts); each entry's float row sum is a shared-memory column
// too, so every input element is read once per chunk of kGradwBf16Chunk
// entries (one chunk at the flagship's l_max 2 layers when they have at
// most that many entries; more chunks read the rows again). After the rows,
// the chunk's sums are rounded into the paths' running sums (a shared
// column per path, started at -0.0, which adds exactly), and the block
// writes its partial [P][128]; a second launch, a thread per (p, u), adds
// the blocks and folds the lanes. Rows past the last edge add zeros, as
// JAX's padding does. The simple form: speed is later work.
// ---------------------------------------------------------------------------
constexpr int kGradwBf16Chunk = 64;  // entries whose row sums are kept at once
constexpr int kGradwLanes = 128;     // JAX's lanes
constexpr int kGradwRows = 64;       // rows of one of JAX's blocks

__global__ void __launch_bounds__(kWarp) sparse_tp_gradw_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ g, const int* __restrict__ eidx,
    const float* __restrict__ ecoef, int n_entries, long long n_edges, int d1, int d2, int d3,
    int U, int P, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  int4* s_idx = reinterpret_cast<int4*>(smem);                    // [kGradwBf16Chunk]
  float* s_c = reinterpret_cast<float*>(s_idx + kGradwBf16Chunk);  // [kGradwBf16Chunk]
  float* s_sum = s_c + kGradwBf16Chunk;                            // [kGradwBf16Chunk][32]
  float* s_acc = s_sum + kGradwBf16Chunk * kWarp;                  // [P][32]
  float* s_col = s_acc + P * kWarp;                                // [d1 + d2 + d3][32]
  const int per_block = kGradwLanes / kWarp;
  const long long blk = blockIdx.x / per_block;
  const int lane = (int)(blockIdx.x - blk * per_block) * kWarp + tid;
  const int Q = kGradwLanes / U, q = lane / U, u = lane - q * U;
  float* ca = s_col + tid;
  float* cb = ca + d1 * kWarp;
  float* cg = cb + d2 * kWarp;
  for (int p = 0; p < P; ++p) s_acc[p * kWarp + tid] = -0.f;
  for (int n0 = 0; n0 < n_entries; n0 += kGradwBf16Chunk) {
    const int nc = min(kGradwBf16Chunk, n_entries - n0);
    __syncthreads();  // the last chunk's entries are read
    for (int m = tid; m < nc; m += kWarp) {
      const int n = n0 + m;
      s_idx[m] = make_int4(eidx[4 * n], eidx[4 * n + 1], eidx[4 * n + 2], eidx[4 * n + 3]);
      s_c[m] = bf16_round(ecoef[n]);
    }
    for (int m = 0; m < nc; ++m) s_sum[m * kWarp + tid] = 0.f;
    __syncthreads();
    for (int r = 0; r < kGradwRows; ++r) {
      const long long e = (blk * kGradwRows + r) * Q + q;
      const bool real = e < n_edges;
      for (int i = 0; i < d1; ++i)
        ca[i * kWarp] = real ? load_f(a + (e * d1 + i) * U + u) : 0.f;
      for (int j = 0; j < d2; ++j)
        cb[j * kWarp] = real ? load_f(b + (e * d2 + j) * U + u) : 0.f;
      for (int k = 0; k < d3; ++k)
        cg[k * kWarp] = real ? load_f(g + (e * d3 + k) * U + u) : 0.f;
      for (int m = 0; m < nc; ++m) {
        const int4 x = s_idx[m];
        s_sum[m * kWarp + tid] += bf16_round(ca[x.x * kWarp] * cb[x.y * kWarp]) * cg[x.z * kWarp];
      }
    }
    for (int m = 0; m < nc; ++m) {
      const float con = bf16_round(s_c[m] * bf16_round(s_sum[m * kWarp + tid]));
      float* acc = s_acc + s_idx[m].w * kWarp + tid;
      *acc = bf16_round(*acc + con);
    }
  }
  for (int p = 0; p < P; ++p)
    partial[(blk * P + p) * kGradwLanes + lane] = s_acc[p * kWarp + tid];
}

// gw[p, u]: the blocks' partials of each lane (q, u) added in block order,
// then the Q lanes in lane order, each add rounded to bf16 (JAX's bf16
// output accumulated over its grid, then the fold of the lane tiling).
__global__ void sparse_tp_gradw_bf16_fold_kernel(const float* __restrict__ partial,
                                                 long long n_blocks, int U, int P,
                                                 __nv_bfloat16* __restrict__ gw) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * U) return;
  const int p = t / U, u = t - p * U, Q = kGradwLanes / U;
  float s = 0.f;
  for (int q = 0; q < Q; ++q) {
    float ow = 0.f;
    for (long long b = 0; b < n_blocks; ++b)
      ow = bf16_round(ow + partial[(b * P + p) * kGradwLanes + q * U + u]);
    s = bf16_round(s + ow);
  }
  gw[t] = __float2bfloat16_rn(s);
}

extern "C" {

// The bfloat16 form: a, b, w and out __nv_bfloat16; eidx [n_entries, 4],
// ecoef [n_entries]: the table itself, in its (sorted) entry order.
int atpt_sparse_tp_bf16(const void* a, const void* b, const void* w, const int* eidx,
                        const float* ecoef, int n_entries, long long n_edges, int d1, int d2,
                        int d3, int U, void* out, void* stream) {
  if (d1 < 1 || d2 < 1 || d3 < 1 || d1 > kBf16TpMaxDim || d2 > kBf16TpMaxDim ||
      d3 > kBf16TpMaxDim || U < 1 || n_entries < 0 || n_edges < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_entries * (sizeof(int4) + sizeof(float));
  cudaError_t err = prepare_smem(sparse_tp_bf16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(sparse_tp_bf16_kernel, kBf16TpThreads, smem,
                                       n_edges * U, kBf16TpThreads);
  sparse_tp_bf16_kernel<<<blocks, kBf16TpThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(w), eidx, ecoef, n_entries, n_edges, d1, d2, d3, U,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The bfloat16 form: a, b and g __nv_bfloat16, gw [P, U] __nv_bfloat16;
// eidx [n_entries, 4], ecoef [n_entries]: the table itself, in its (sorted)
// entry order; partial: scratch [n_blocks, P, 128], n_blocks JAX's 64-row
// blocks of the E edges at 128 / U a row (U must divide 128).
int atpt_sparse_tp_gradw_bf16(const void* a, const void* b, const void* g, const int* eidx,
                              const float* ecoef, int n_entries, long long n_edges, int d1,
                              int d2, int d3, int U, int P, long long n_blocks, float* partial,
                              void* gw, void* stream) {
  if (d1 < 1 || d2 < 1 || d3 < 1 || d1 > kMaxTpDim || d2 > kMaxTpDim || d3 > kMaxTpDim ||
      U < 1 || kGradwLanes % U || P < 1 || n_entries < 1 || n_edges < 0 || n_blocks < 1 ||
      n_blocks * (kGradwLanes / kWarp) > 0x7fffffffLL ||
      n_blocks * kGradwRows * (kGradwLanes / U) < n_edges)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kGradwBf16Chunk * (sizeof(int4) + sizeof(float)) +
                      (size_t)(kGradwBf16Chunk + P + d1 + d2 + d3) * kWarp * sizeof(float);
  cudaError_t err = prepare_smem(sparse_tp_gradw_bf16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const auto s = (cudaStream_t)stream;
  sparse_tp_gradw_bf16_kernel<<<(unsigned)(n_blocks * (kGradwLanes / kWarp)), kWarp, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(g), eidx, ecoef, n_entries, n_edges, d1, d2, d3, U, P,
      partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparse_tp_gradw_bf16_fold_kernel<<<(P * U + 127) / 128, 128, 0, s>>>(
      partial, n_blocks, U, P, static_cast<__nv_bfloat16*>(gw));
  return (int)cudaGetLastError();
}

// desc [n_rows, kDescCols], dscale [n_rows]: the table's path table in walk
// order; eidx [n, 4], ecoef [n]: its entries ordered by path.
int atpt_sparse_tp(const float* a, const float* b, const float* w, const int* desc,
                   const float* dscale, int n_rows, const int* eidx, const float* ecoef,
                   long long n_edges, int d1, int d2, int d3, int U, int P, float* out,
                   void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P, n_rows)) return rc;
  const int T = kTpThreads;
  const size_t smem = (size_t)n_rows * (kDescCols + U) * sizeof(float) +
                      (size_t)(d1 + d2) * T * sizeof(float);
  cudaError_t err = prepare_smem(sparse_tp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(sparse_tp_kernel, T, smem, n_edges * U, T);
  sparse_tp_kernel<<<blocks, T, smem, (cudaStream_t)stream>>>(
      a, b, w, desc, dscale, n_rows, eidx, ecoef, n_edges, d1, d2, d3, U, out);
  return (int)cudaGetLastError();
}

// partial: scratch [n_blocks, P, U]; n_blocks <= kGradwMaxBlocks, chosen by
// the caller from E alone, so the order of the sums does not depend on the card.
int atpt_sparse_tp_gradw(const float* a, const float* b, const float* g, const int* desc,
                         const float* dscale, int n_rows, const int* eidx, const float* ecoef,
                         long long n_edges, int d1, int d2, int d3, int U, int P, int n_blocks,
                         float* partial, float* gw, void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P, n_rows)) return rc;
  if (U < 1 || U > 1024 || n_blocks < 1 || n_blocks > kGradwMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const int T = U * (U < kTpThreads ? kTpThreads / U : 1);
  const size_t smem = (size_t)n_rows * (kDescCols + 1) * sizeof(float) +
                      (size_t)(P + d1 + d2 + d3) * T * sizeof(float);
  cudaError_t err = prepare_smem(sparse_tp_gradw_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sparse_tp_gradw_partial_kernel<<<n_blocks, T, smem, (cudaStream_t)stream>>>(
      a, b, g, desc, dscale, n_rows, eidx, ecoef, n_edges, d1, d2, d3, U, P, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PU = P * U;
  partials_reduce_kernel<<<(PU + 255) / 256, 256, 0, (cudaStream_t)stream>>>(partial, n_blocks,
                                                                            PU, gw);
  return (int)cudaGetLastError();
}


// env [n_atoms, d2*U], centers [E]; ts: null, or [E, U] for the split
// output; the path table as in atpt_sparse_tp. bf16: x and out are the bf16
// track (__nv_bfloat16), otherwise float; env, w and ts are float either
// way, and so is the shared-memory layout (x is widened as it is staged).
int atpt_gather_tp(const void* x, const float* env, const float* w, const int* centers,
                   const int* desc, const float* dscale, int n_rows, const int* eidx,
                   const float* ecoef, long long n_edges, int n_atoms, int d1, int d2, int d3,
                   int U, int P, void* out, float* ts, int bf16, void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P, n_rows)) return rc;
  const int T = kTpThreads;
  const size_t smem = (size_t)n_rows * (kDescCols + U) * sizeof(float) +
                      (size_t)(d1 + d2) * T * sizeof(float);
  const auto launch = [&](auto* xt, auto* ot) {
    using Tt = std::remove_const_t<std::remove_pointer_t<decltype(xt)>>;
    cudaError_t err = prepare_smem(gather_tp_kernel<Tt>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = persistent_blocks(gather_tp_kernel<Tt>, T, smem, n_edges * U, T);
    gather_tp_kernel<Tt><<<blocks, T, smem, (cudaStream_t)stream>>>(
        xt, env, w, centers, desc, dscale, n_rows, eidx, ecoef, n_edges, n_atoms, d1, d2, d3, U,
        ot, ts, (bf16 & 8) != 0);
    return (int)cudaGetLastError();
  };
  if (bf16 & 1)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out));
  return launch(static_cast<const float*>(x), static_cast<float*>(out));
}

// partial and n_blocks as in atpt_sparse_tp_gradw. bf16: x and g are the
// bf16 track (__nv_bfloat16), otherwise float; env, partial and dw are float
// either way, and so is the shared-memory layout (x and g are widened as
// they are staged).
int atpt_gather_dw(const void* x, const float* env, const void* g, const int* centers,
                   const int* desc, const float* dscale, int n_rows, const int* eidx,
                   const float* ecoef, long long n_edges, int n_atoms, int d1, int d2, int d3,
                   int U, int P, int n_blocks, float* partial, float* dw, int bf16,
                   void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P, n_rows)) return rc;
  if (U < 1 || U > 1024 || n_blocks < 1 || n_blocks > kGradwMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const int T = U * (U < kTpThreads ? kTpThreads / U : 1);
  const size_t smem = (size_t)n_rows * (kDescCols + 1) * sizeof(float) +
                      (size_t)(P + d1 + d2 + d3) * T * sizeof(float);
  const auto launch = [&](auto* xt, auto* gt) {
    using Tt = std::remove_const_t<std::remove_pointer_t<decltype(xt)>>;
    cudaError_t err = prepare_smem(gather_dw_partial_kernel<Tt>, smem);
    if (err != cudaSuccess) return err;
    gather_dw_partial_kernel<Tt><<<n_blocks, T, smem, (cudaStream_t)stream>>>(
        xt, env, gt, centers, desc, dscale, n_rows, eidx, ecoef, n_edges, n_atoms, d1, d2, d3, U,
        P, partial);
    return cudaGetLastError();
  };
  cudaError_t err = bf16 ? launch(static_cast<const __nv_bfloat16*>(x),
                                  static_cast<const __nv_bfloat16*>(g))
                         : launch(static_cast<const float*>(x), static_cast<const float*>(g));
  if (err != cudaSuccess) return (int)err;
  const int PU = P * U;
  partials_reduce_kernel<<<(PU + 255) / 256, 256, 0, (cudaStream_t)stream>>>(partial, n_blocks,
                                                                            PU, dw);
  return (int)cudaGetLastError();
}

// row_ptr [n_atoms + 1]: the CSR of the center-sorted edges; desc, dscale,
// eidx, ecoef: the path table of the table with roles (0, 2, 1), as in
// atpt_sparse_tp (its out is d2 wide). bf16: x and g are the bf16 track
// (__nv_bfloat16), otherwise float; w and denv are float either way, and so
// is the shared-memory layout (x and g are widened as they are staged).
int atpt_tp_scatter(const void* x, const void* g, const float* w, const int* row_ptr,
                    const int* desc, const float* dscale, int n_rows, const int* eidx,
                    const float* ecoef, int n_atoms, int d1, int d2, int d3, int U, int P,
                    float* denv, int bf16, void* stream) {
  if (int rc = check_tp_dims(d1, d2, d3, P, n_rows)) return rc;
  if (U < 1 || U > 1024) return (int)cudaErrorInvalidValue;
  const int T = U * (U < kTpThreads ? kTpThreads / U : 1);
  const size_t smem = (size_t)n_rows * (kDescCols + U) * sizeof(float) +
                      (size_t)(d2 + d1 + d3) * T * sizeof(float);
  const auto launch = [&](auto* xt, auto* gt) {
    using Tt = std::remove_const_t<std::remove_pointer_t<decltype(xt)>>;
    cudaError_t err = prepare_smem(tp_scatter_kernel<Tt>, smem);
    if (err != cudaSuccess) return (int)err;
    tp_scatter_kernel<Tt><<<n_atoms, T, smem, (cudaStream_t)stream>>>(
        xt, gt, w, row_ptr, desc, dscale, n_rows, eidx, ecoef, d1, d2, d3, U, denv);
    return (int)cudaGetLastError();
  };
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g));
  return launch(static_cast<const float*>(x), static_cast<const float*>(g));
}

}  // extern "C"
