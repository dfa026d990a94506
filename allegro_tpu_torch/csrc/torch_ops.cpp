// The force call's kernels as the ops of the `atpt` namespace, for a
// process without Python: the C++ MD driver (md_driver.cpp), which runs an
// AOTInductor package of the force call. AOTInductor calls each kernel of
// the package through the dispatcher, by these names and schemas, which are
// ops/custom_ops.py's letter for letter (tests/test_torch_export.py holds
// the two together). Each CUDA implementation does what the kernel's Python
// wrapper in ops/fused_tp.py does on a CUDA tensor: it checks the types,
// allocates the outputs and launches the kernel through its C interface
// (csrc/*.cu, the library ops/_build.py builds) on the current stream, or
// raises. There is no CPU implementation and no fallback: a package of the
// kernel route runs on the card. The tensor track of a kernel with a bf16
// form is float32 or bfloat16 as the op's flag says (the flag its launch
// takes); every other array is float32, and an op given another type raises.
//
// Built by allegro_tpu_torch/native/md_driver.py with g++ against PyTorch's
// headers and libraries, and linked into the driver.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <string>
#include <vector>

extern "C" {
int atpt_env_scatter(const float* sh, const void* wexp, const int* row_ptr, const int* dim_to_irr,
                     int n_atoms, int d2, int n_irr, int U, float* env, int bf16, void* stream);
int atpt_gather_tp(const void* x, const float* env, const float* w, const int* centers,
                   const int* desc, const float* dscale, int n_rows, const int* eidx,
                   const float* ecoef, long long n_edges, int n_atoms, int d1, int d2, int d3,
                   int U, int P, void* out, float* ts, int bf16, void* stream);
int atpt_bwd_fused(const void* x, const void* g, const float* gts, const float* env,
                   const float* w, const int* row_ptr, const int* eidx, const float* ecoef,
                   int n_entries, const int* desc_dx, const float* scale_dx, int rows_dx,
                   const int* eidx_dx, const float* ecoef_dx, const int* desc_den,
                   const float* scale_den, int rows_den, const int* eidx_den,
                   const float* ecoef_den, long long n_edges, int n_atoms, int d1, int d2, int d3,
                   int U, int P, int n_blocks, void* dx, float* denv, float* partial, float* dw,
                   int bf16, void* stream);
int atpt_unweight_both(const float* t, const float* sh, const void* wexp, const int* centers,
                       const int* dim_to_irr, long long n_edges, int n_atoms, int d2, int n_irr,
                       int U, float* dsh, void* dwexp, int bf16, int bf16_out, void* stream);
int atpt_center_gather(const float* a, const int* idx, long long n_edges, int n_atoms, int C,
                       float* out, void* stream);
int atpt_center_sum(const float* v, const int* row_ptr, const int* perm, int n_atoms, int C,
                    float* out, void* stream);
int atpt_center_sum_chunked(const float* v, const int* row_ptr, const int* perm, int n_rows,
                            int C, long long n_pos, int chunk, float* partial, float* out,
                            void* stream);
int atpt_readout_sum(const float* const* piece_ptrs, const long long* piece_strides,
                     const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                     const int* row_ptr, int n_atoms, int H, float* energy, void* stream);
int atpt_readout_bwd(const float* const* piece_ptrs, const long long* piece_strides,
                     float* const* dpiece_ptrs, const long long* dpiece_strides,
                     const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                     const float* y, const int* centers, long long n_edges, int n_atoms, int H,
                     void* stream);
int atpt_latent_env_scatter(const float* const* piece_ptrs, const long long* piece_strides,
                            const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                            const float* sh, const int* centers, const int* row_ptr,
                            const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
                            int S, int H, int N, float* lat_s, float* env, int bf16_wexp,
                            void* stream);
int atpt_latent_env_bwd(const float* const* piece_ptrs, const long long* piece_strides,
                        float* const* dpiece_ptrs, const long long* dpiece_strides,
                        const int* piece_dims, int n_pieces, const float* w0, const float* w1,
                        const float* sh, const float* t, const float* g_lat, const int* centers,
                        const int* irr_ranges, long long n_edges, int n_atoms, int d2, int U,
                        int S, int H, int N, float* dsh, int bf16_wexp, void* stream);
int atpt_gather_tp_embed(const float* sh, const float* w2b, const float* env, const float* w,
                         int n_w, const int* row_ptr, const int* desc, const float* dscale,
                         int n_paths, const int* eidx, const float* ecoef, const int* row_specs,
                         long long n_edges, int n_atoms, int d_sh, int n_irr, int d1, int d2,
                         int d3, int U, void* out, float* ts, int bf16, void* stream);
int atpt_bwd_embed(const float* sh, const float* w2b, const void* g, const float* gts,
                   const float* env, const float* w, int n_w, const int* row_ptr,
                   const int* desc, const float* dscale, int n_paths, const int* eidx,
                   const float* ecoef, const int* row_specs, long long n_edges, int n_atoms,
                   int d_sh, int n_irr, int d1, int d2, int d3, int U, float* dsh, float* dw2b,
                   float* denv, int bf16, void* stream);
int atpt_tp_scatter(const void* x, const void* g, const float* w, const int* row_ptr,
                    const int* desc, const float* dscale, int n_rows, const int* eidx,
                    const float* ecoef, int n_atoms, int d1, int d2, int d3, int U, int P,
                    float* denv, int bf16, void* stream);
int atpt_unweight_sh(const float* t, const void* wexp, const int* centers, const int* dim_to_irr,
                     long long n_edges, int n_atoms, int d2, int n_irr, int U, float* dsh,
                     int bf16, void* stream);
int atpt_unweight_w(const float* t, const void* sh, const int* centers, const int* dim_to_irr,
                    long long n_edges, int n_atoms, int d2, int n_irr, int U, void* dwexp,
                    int bf16, void* stream);
int atpt_sparse_tp(const float* a, const float* b, const float* w, const int* desc,
                   const float* dscale, int n_rows, const int* eidx, const float* ecoef,
                   long long n_edges, int d1, int d2, int d3, int U, int P, float* out,
                   void* stream);
const char* atpt_error_string(int code);

// the launches of each op's kernel in this process (ops/fused_tp.py's
// LAUNCHES), for the driver's report
long long atpt_op_launches(const char* name);
}

namespace {

using at::Tensor;

std::mutex g_mutex;
std::map<std::string, long long> g_launches;

constexpr int kCenterSumChunk = 256;  // fused_tp.CENTER_SUM_CHUNK
constexpr int kBwdMaxBlocks = 1024;   // fused_tp._BWD_DW_MAX_BLOCKS

void launched(const char* name, int rc) {
  TORCH_CHECK(rc == 0, "CUDA kernel ", name, " failed to launch: ", atpt_error_string(rc),
              " (error ", rc, ")");
  std::lock_guard<std::mutex> lock(g_mutex);
  g_launches[name] += 1;
}

void* stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

Tensor dense(const Tensor& t, at::ScalarType dtype, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, ": the atpt ops run on the CUDA card, got ", t.device());
  TORCH_CHECK(t.scalar_type() == dtype, name, ": expected ", dtype, ", got ", t.scalar_type());
  return t.contiguous();
}
Tensor f32(const Tensor& t, const char* name) { return dense(t, at::kFloat, name); }
// an array of the tensor track: bfloat16 where the op's bf16 flag says so
Tensor track(const Tensor& t, bool bf16, const char* name) {
  return dense(t, bf16 ? at::kBFloat16 : at::kFloat, name);
}
at::ScalarType storage(bool bf16) { return bf16 ? at::kBFloat16 : at::kFloat; }
Tensor i32(const Tensor& t, const char* name) { return dense(t, at::kInt, name); }
const float* fptr(const std::optional<Tensor>& t) {
  return t.has_value() ? t->data_ptr<float>() : nullptr;
}
std::optional<Tensor> f32_opt(const std::optional<Tensor>& t, const char* name) {
  return t.has_value() ? std::optional<Tensor>(f32(*t, name)) : std::nullopt;
}
int I(int64_t v) { return static_cast<int>(v); }

// the row table of the MLP kernels: each piece's row pointer, row stride
// and width (pieces with unit column stride; any row stride)
struct Pieces {
  std::vector<Tensor> tensors;
  std::vector<const float*> ptrs;
  std::vector<long long> strides;
  std::vector<int> dims;
  explicit Pieces(const std::vector<Tensor>& pieces) {
    for (const auto& p : pieces) {
      TORCH_CHECK(p.is_cuda() && p.scalar_type() == at::kFloat && p.dim() == 2,
                  "pieces: float32 [E, S_i] on the card");
      tensors.push_back(p.size(1) <= 1 || p.stride(1) == 1 ? p : p.contiguous());
      ptrs.push_back(tensors.back().data_ptr<float>());
      strides.push_back(tensors.back().stride(0));
      dims.push_back(I(p.size(1)));
    }
  }
};

struct Outputs {
  std::vector<Tensor> tensors;
  std::vector<float*> ptrs;
  std::vector<long long> strides;
  explicit Outputs(const std::vector<Tensor>& like) {
    for (const auto& p : like) {
      tensors.push_back(at::empty(p.sizes(), p.options()));
      ptrs.push_back(tensors.back().data_ptr<float>());
      strides.push_back(tensors.back().stride(0));
    }
  }
};

// a path table: desc [rows, 8] int32, scale [rows], entries by path
struct Paths {
  Tensor desc, scale, idx, coef;
  Paths(const Tensor& d, const Tensor& s, const Tensor& i, const Tensor& c)
      : desc(i32(d, "desc")), scale(f32(s, "scale")), idx(i32(i, "path_idx")),
        coef(f32(c, "path_coef")) {}
  int rows() const { return I(desc.size(0)); }
};

Tensor env_scatter(const Tensor& sh_, const Tensor& wexp_, const Tensor& centers,
                   const Tensor& row_ptr_, const Tensor& dim_to_irr_, int64_t U, bool bf16) {
  auto sh = f32(sh_, "sh"), wexp = track(wexp_, bf16, "wexp");
  auto row_ptr = i32(row_ptr_, "row_ptr"), dim_to_irr = i32(dim_to_irr_, "dim_to_irr");
  int64_t n_atoms = row_ptr.size(0) - 1, d2 = sh.size(1);
  auto env = at::empty({n_atoms, d2 * U}, sh.options());
  if (n_atoms == 0) return env;
  launched("env_scatter",
           atpt_env_scatter(sh.data_ptr<float>(), wexp.data_ptr(), row_ptr.data_ptr<int>(),
                            dim_to_irr.data_ptr<int>(), I(n_atoms), I(d2), I(wexp.size(1) / U),
                            I(U), env.data_ptr<float>(), bf16, stream()));
  return env;
}

std::tuple<Tensor, Tensor> gather_tp(const Tensor& x_, const Tensor& env_, const Tensor& w_,
                                     const Tensor& centers_, const Tensor& entry_idx,
                                     const Tensor& entry_coef, int64_t d3, bool split,
                                     const Tensor& desc, const Tensor& scale,
                                     const Tensor& path_idx, const Tensor& path_coef,
                                     bool bf16) {
  auto x = track(x_, bf16, "x"), env = f32(env_, "env"), w = f32(w_, "w");
  auto centers = i32(centers_, "centers");
  Paths paths(desc, scale, path_idx, path_coef);
  int64_t E = x.size(0), U = w.size(1);
  auto out = at::empty({E, d3 * U}, x.options());
  auto ts = at::empty({E, split ? U : 0}, env.options());
  if (E > 0)
    launched("gather_tp",
             atpt_gather_tp(x.data_ptr(), env.data_ptr<float>(), w.data_ptr<float>(),
                            centers.data_ptr<int>(), paths.desc.data_ptr<int>(),
                            paths.scale.data_ptr<float>(), paths.rows(),
                            paths.idx.data_ptr<int>(), paths.coef.data_ptr<float>(), E,
                            I(env.size(0)), I(x.size(1) / U), I(env.size(1) / U), I(d3), I(U),
                            I(w.size(0)), out.data_ptr(),
                            split ? ts.data_ptr<float>() : nullptr, bf16, stream()));
  return {out, ts};
}

std::tuple<Tensor, Tensor> bwd_fused(
    const Tensor& x_, const Tensor& g_, const std::optional<Tensor>& gts_, const Tensor& env_,
    const Tensor& w_, const Tensor& centers, const Tensor& row_ptr_, const Tensor& entry_idx,
    const Tensor& entry_coef, const Tensor& desc, const Tensor& scale, const Tensor& path_idx,
    const Tensor& path_coef, const Tensor& scatter_desc, const Tensor& scatter_scale,
    const Tensor& scatter_path_idx, const Tensor& scatter_path_coef, bool bf16) {
  auto x = track(x_, bf16, "x"), g = track(g_, bf16, "g"), env = f32(env_, "env");
  auto w = f32(w_, "w");
  auto gts = f32_opt(gts_, "gts");
  auto row_ptr = i32(row_ptr_, "row_ptr");
  Paths dx_paths(desc, scale, path_idx, path_coef);
  Paths denv_paths(scatter_desc, scatter_scale, scatter_path_idx, scatter_path_coef);
  int64_t E = x.size(0), U = w.size(1), n_atoms = row_ptr.size(0) - 1;
  int n_blocks = I(std::max<int64_t>(1, std::min<int64_t>(kBwdMaxBlocks, n_atoms + 1)));
  auto dx = at::empty_like(x), denv = at::empty_like(env);
  if (E > 0 || n_atoms > 0)
    launched("bwd_fused",
             atpt_bwd_fused(x.data_ptr(), g.data_ptr(), fptr(gts),
                            env.data_ptr<float>(), w.data_ptr<float>(), row_ptr.data_ptr<int>(),
                            nullptr, nullptr, 0, dx_paths.desc.data_ptr<int>(),
                            dx_paths.scale.data_ptr<float>(), dx_paths.rows(),
                            dx_paths.idx.data_ptr<int>(), dx_paths.coef.data_ptr<float>(),
                            denv_paths.desc.data_ptr<int>(), denv_paths.scale.data_ptr<float>(),
                            denv_paths.rows(), denv_paths.idx.data_ptr<int>(),
                            denv_paths.coef.data_ptr<float>(), E, I(n_atoms), I(x.size(1) / U),
                            I(env.size(1) / U), I(g.size(1) / U), I(U), I(w.size(0)), n_blocks,
                            dx.data_ptr(), denv.data_ptr<float>(), nullptr, nullptr, bf16,
                            stream()));
  return {dx, denv};
}

std::tuple<Tensor, Tensor> unweight_both(const Tensor& t_, const Tensor& sh_,
                                         const Tensor& wexp_, const Tensor& centers_,
                                         const Tensor& dim_to_irr_, bool bf16, bool bf16_out) {
  TORCH_CHECK(bf16 || !bf16_out, "unweight_both: a bfloat16 dwexp needs bfloat16 env weights");
  auto t = f32(t_, "t"), sh = f32(sh_, "sh"), wexp = track(wexp_, bf16, "wexp");
  auto centers = i32(centers_, "centers"), dim_to_irr = i32(dim_to_irr_, "dim_to_irr");
  int64_t E = sh.size(0), d2 = sh.size(1), U = t.size(1) / d2;
  auto dsh = at::empty_like(sh);
  auto dwexp = at::empty(wexp.sizes(), wexp.options().dtype(storage(bf16_out)));
  if (E == 0) return {dsh, dwexp};
  launched("unweight_both",
           atpt_unweight_both(t.data_ptr<float>(), sh.data_ptr<float>(), wexp.data_ptr(),
                              centers.data_ptr<int>(), dim_to_irr.data_ptr<int>(), E,
                              I(t.size(0)), I(d2), I(wexp.size(1) / U), I(U),
                              dsh.data_ptr<float>(), dwexp.data_ptr(), bf16, bf16_out,
                              stream()));
  return {dsh, dwexp};
}

Tensor center_gather(const Tensor& a_, const Tensor& idx_) {
  auto a = f32(a_, "a");
  auto idx = i32(idx_, "idx");
  int64_t E = idx.size(0), C = a.size(1);
  auto out = at::empty({E, C}, a.options());
  if (E == 0 || C == 0) return out;
  launched("center_gather", atpt_center_gather(a.data_ptr<float>(), idx.data_ptr<int>(), E,
                                               I(a.size(0)), I(C), out.data_ptr<float>(),
                                               stream()));
  return out;
}

Tensor center_sum(const Tensor& v_, const Tensor& row_ptr_, const std::optional<Tensor>& perm_,
                  bool chunked) {
  auto v = f32(v_, "v");
  auto row_ptr = i32(row_ptr_, "row_ptr");
  std::optional<Tensor> perm =
      perm_.has_value() ? std::optional<Tensor>(i32(*perm_, "perm")) : std::nullopt;
  const int* perm_ptr = perm.has_value() ? perm->data_ptr<int>() : nullptr;
  int64_t n_atoms = row_ptr.size(0) - 1, C = v.size(1);
  auto out = at::empty({n_atoms, C}, v.options());
  if (n_atoms == 0 || C == 0) return out;
  if (chunked) {
    int64_t n_chunks = (v.size(0) + kCenterSumChunk - 1) / kCenterSumChunk;
    auto partial = at::empty({n_chunks + n_atoms, C}, v.options());
    launched("center_sum",
             atpt_center_sum_chunked(v.data_ptr<float>(), row_ptr.data_ptr<int>(), perm_ptr,
                                     I(n_atoms), I(C), v.size(0), kCenterSumChunk,
                                     partial.data_ptr<float>(), out.data_ptr<float>(), stream()));
    return out;
  }
  launched("center_sum", atpt_center_sum(v.data_ptr<float>(), row_ptr.data_ptr<int>(), perm_ptr,
                                         I(n_atoms), I(C), out.data_ptr<float>(), stream()));
  return out;
}

std::tuple<Tensor, Tensor> latent_env_scatter(
    at::TensorList pieces_, const Tensor& sh_, const Tensor& w0_,
    const std::optional<Tensor>& w1_, const Tensor& centers_, const Tensor& row_ptr_,
    const Tensor& dim_to_irr, const Tensor& irr_ranges_, int64_t U, int64_t S, bool bf16_wexp) {
  Pieces pieces(pieces_.vec());
  auto sh = f32(sh_, "sh"), w0 = f32(w0_, "w0");
  auto w1 = f32_opt(w1_, "w1");
  auto centers = i32(centers_, "centers"), row_ptr = i32(row_ptr_, "row_ptr");
  auto irr_ranges = i32(irr_ranges_, "irr_ranges");
  int64_t E = sh.size(0), d2 = sh.size(1), n_atoms = row_ptr.size(0) - 1;
  int64_t N = w1.has_value() ? w1->size(1) : w0.size(1);
  auto lat_s = at::empty({E, S}, sh.options());
  auto env = at::empty({n_atoms, d2 * U}, sh.options());
  if (E == 0 && n_atoms == 0) return {lat_s, env};
  launched("latent_env_scatter",
           atpt_latent_env_scatter(pieces.ptrs.data(), pieces.strides.data(), pieces.dims.data(),
                                   I(pieces.ptrs.size()), w0.data_ptr<float>(), fptr(w1),
                                   sh.data_ptr<float>(), centers.data_ptr<int>(),
                                   row_ptr.data_ptr<int>(), irr_ranges.data_ptr<int>(), E,
                                   I(n_atoms), I(d2), I(U), I(S),
                                   w1.has_value() ? I(w0.size(1)) : 0, I(N),
                                   lat_s.data_ptr<float>(), env.data_ptr<float>(), bf16_wexp,
                                   stream()));
  return {lat_s, env};
}

std::vector<Tensor> latent_env_bwd(at::TensorList pieces_, const Tensor& sh_, const Tensor& w0_,
                                   const std::optional<Tensor>& w1_, const Tensor& t_,
                                   const Tensor& g_lat_, const Tensor& centers_,
                                   const Tensor& dim_to_irr, const Tensor& irr_ranges_,
                                   int64_t U, int64_t S, bool bf16_wexp) {
  Pieces pieces(pieces_.vec());
  Outputs dpieces(pieces.tensors);
  auto sh = f32(sh_, "sh"), w0 = f32(w0_, "w0"), t = f32(t_, "t"), g_lat = f32(g_lat_, "g_lat");
  auto w1 = f32_opt(w1_, "w1");
  auto centers = i32(centers_, "centers"), irr_ranges = i32(irr_ranges_, "irr_ranges");
  int64_t E = sh.size(0), d2 = sh.size(1);
  int64_t N = w1.has_value() ? w1->size(1) : w0.size(1);
  auto dsh = at::empty_like(sh);
  std::vector<Tensor> out = {dsh};
  out.insert(out.end(), dpieces.tensors.begin(), dpieces.tensors.end());
  if (E == 0) return out;
  launched("latent_env_bwd",
           atpt_latent_env_bwd(pieces.ptrs.data(), pieces.strides.data(), dpieces.ptrs.data(),
                               dpieces.strides.data(), pieces.dims.data(), I(pieces.ptrs.size()),
                               w0.data_ptr<float>(), fptr(w1), sh.data_ptr<float>(),
                               t.data_ptr<float>(), g_lat.data_ptr<float>(),
                               centers.data_ptr<int>(), irr_ranges.data_ptr<int>(), E,
                               I(t.size(0)), I(d2), I(U), I(S), w1.has_value() ? I(w0.size(1)) : 0,
                               I(N), dsh.data_ptr<float>(), bf16_wexp, stream()));
  return out;
}

std::tuple<Tensor, Tensor> gather_tp_embed(
    const Tensor& sh_, const Tensor& w2b_, const Tensor& env_, const Tensor& w_,
    const Tensor& centers, const Tensor& row_ptr_, const Tensor& entry_idx,
    const Tensor& entry_coef, const Tensor& row_specs_, int64_t d3, bool split,
    const Tensor& desc, const Tensor& scale, const Tensor& path_idx, const Tensor& path_coef,
    bool bf16) {
  auto sh = f32(sh_, "sh"), w2b = f32(w2b_, "w2b"), env = f32(env_, "env"), w = f32(w_, "w");
  auto row_ptr = i32(row_ptr_, "row_ptr"), row_specs = i32(row_specs_, "row_specs");
  Paths paths(desc, scale, path_idx, path_coef);
  int64_t E = sh.size(0), U = w.size(1), n_atoms = row_ptr.size(0) - 1;
  auto out = at::empty({E, d3 * U}, sh.options().dtype(storage(bf16)));
  auto ts = at::empty({E, split ? U : 0}, sh.options());
  if (E > 0)
    launched("gather_tp_embed",
             atpt_gather_tp_embed(sh.data_ptr<float>(), w2b.data_ptr<float>(),
                                  env.data_ptr<float>(), w.data_ptr<float>(), I(w.size(0)),
                                  row_ptr.data_ptr<int>(), paths.desc.data_ptr<int>(),
                                  paths.scale.data_ptr<float>(), paths.rows(),
                                  paths.idx.data_ptr<int>(), paths.coef.data_ptr<float>(),
                                  row_specs.data_ptr<int>(), E, I(n_atoms), I(sh.size(1)),
                                  I(w2b.size(1) / U), I(row_specs.size(0)), I(env.size(1) / U),
                                  I(d3), I(U), out.data_ptr(),
                                  split ? ts.data_ptr<float>() : nullptr, bf16, stream()));
  return {out, ts};
}

std::tuple<Tensor, Tensor, Tensor> bwd_embed(
    const Tensor& sh_, const Tensor& w2b_, const Tensor& g_, const std::optional<Tensor>& gts_,
    const Tensor& env_, const Tensor& w_, const Tensor& centers, const Tensor& row_ptr_,
    const Tensor& entry_idx, const Tensor& entry_coef, const Tensor& row_specs_,
    const Tensor& desc, const Tensor& scale, const Tensor& path_idx, const Tensor& path_coef,
    bool bf16) {
  auto sh = f32(sh_, "sh"), w2b = f32(w2b_, "w2b"), g = track(g_, bf16, "g");
  auto env = f32(env_, "env");
  auto w = f32(w_, "w");
  auto gts = f32_opt(gts_, "gts");
  auto row_ptr = i32(row_ptr_, "row_ptr"), row_specs = i32(row_specs_, "row_specs");
  Paths paths(desc, scale, path_idx, path_coef);
  int64_t E = sh.size(0), U = w.size(1), n_atoms = row_ptr.size(0) - 1;
  auto dsh = at::empty_like(sh), dw2b = at::empty_like(w2b), denv = at::empty_like(env);
  if (E == 0 && n_atoms == 0) return {dsh, dw2b, denv};
  launched("bwd_embed",
           atpt_bwd_embed(sh.data_ptr<float>(), w2b.data_ptr<float>(), g.data_ptr(),
                          fptr(gts), env.data_ptr<float>(), w.data_ptr<float>(), I(w.size(0)),
                          row_ptr.data_ptr<int>(), paths.desc.data_ptr<int>(),
                          paths.scale.data_ptr<float>(), paths.rows(), paths.idx.data_ptr<int>(),
                          paths.coef.data_ptr<float>(), row_specs.data_ptr<int>(), E,
                          I(n_atoms), I(sh.size(1)), I(w2b.size(1) / U), I(row_specs.size(0)),
                          I(env.size(1) / U), I(g.size(1) / U), I(U), dsh.data_ptr<float>(),
                          dw2b.data_ptr<float>(), denv.data_ptr<float>(), bf16, stream()));
  return {dsh, dw2b, denv};
}

Tensor readout_sum(at::TensorList pieces_, const Tensor& w0_, const std::optional<Tensor>& w1_,
                   const Tensor& row_ptr_) {
  Pieces pieces(pieces_.vec());
  auto w0 = f32(w0_, "w0");
  auto w1 = f32_opt(w1_, "w1");
  auto row_ptr = i32(row_ptr_, "row_ptr");
  int64_t n_atoms = row_ptr.size(0) - 1;
  auto energy = at::empty({n_atoms, 1}, w0.options());
  if (n_atoms == 0) return energy;
  launched("readout_sum",
           atpt_readout_sum(pieces.ptrs.data(), pieces.strides.data(), pieces.dims.data(),
                            I(pieces.ptrs.size()), w0.data_ptr<float>(), fptr(w1),
                            row_ptr.data_ptr<int>(), I(n_atoms), I(w0.size(1)),
                            energy.data_ptr<float>(), stream()));
  return energy;
}

std::vector<Tensor> readout_bwd(at::TensorList pieces_, const Tensor& w0_,
                                const std::optional<Tensor>& w1_, const Tensor& y_,
                                const Tensor& centers_) {
  Pieces pieces(pieces_.vec());
  Outputs dpieces(pieces.tensors);
  auto w0 = f32(w0_, "w0"), y = f32(y_, "y");
  auto w1 = f32_opt(w1_, "w1");
  auto centers = i32(centers_, "centers");
  int64_t E = centers.size(0);
  if (E == 0) return dpieces.tensors;
  launched("readout_bwd",
           atpt_readout_bwd(pieces.ptrs.data(), pieces.strides.data(), dpieces.ptrs.data(),
                            dpieces.strides.data(), pieces.dims.data(), I(pieces.ptrs.size()),
                            w0.data_ptr<float>(), fptr(w1), y.data_ptr<float>(),
                            centers.data_ptr<int>(), E, I(y.size(0)), I(w0.size(1)), stream()));
  return dpieces.tensors;
}

Tensor tp_scatter(const Tensor& x_, const Tensor& g_, const Tensor& w_, const Tensor& centers,
                  const Tensor& row_ptr_, const Tensor& entry_idx, const Tensor& entry_coef,
                  int64_t d2, const Tensor& desc, const Tensor& scale, const Tensor& path_idx,
                  const Tensor& path_coef, bool bf16) {
  auto x = track(x_, bf16, "x"), g = track(g_, bf16, "g"), w = f32(w_, "w");
  auto row_ptr = i32(row_ptr_, "row_ptr");
  Paths paths(desc, scale, path_idx, path_coef);
  int64_t U = w.size(1), n_atoms = row_ptr.size(0) - 1;
  auto denv = at::empty({n_atoms, d2 * U}, w.options());
  if (n_atoms == 0) return denv;
  launched("tp_scatter",
           atpt_tp_scatter(x.data_ptr(), g.data_ptr(), w.data_ptr<float>(),
                           row_ptr.data_ptr<int>(), paths.desc.data_ptr<int>(),
                           paths.scale.data_ptr<float>(), paths.rows(), paths.idx.data_ptr<int>(),
                           paths.coef.data_ptr<float>(), I(n_atoms), I(x.size(1) / U), I(d2),
                           I(g.size(1) / U), I(U), I(w.size(0)), denv.data_ptr<float>(), bf16,
                           stream()));
  return denv;
}

Tensor unweight_sh(const Tensor& t_, const Tensor& wexp_, const Tensor& centers_,
                   const Tensor& dim_to_irr_, bool bf16) {
  auto t = f32(t_, "t"), wexp = track(wexp_, bf16, "wexp");
  auto centers = i32(centers_, "centers"), dim_to_irr = i32(dim_to_irr_, "dim_to_irr");
  int64_t E = wexp.size(0), d2 = dim_to_irr.size(0), U = t.size(1) / d2;
  auto dsh = at::empty({E, d2}, t.options());
  if (E > 0)
    launched("unweight_sh",
             atpt_unweight_sh(t.data_ptr<float>(), wexp.data_ptr(), centers.data_ptr<int>(),
                              dim_to_irr.data_ptr<int>(), E, I(t.size(0)), I(d2),
                              I(wexp.size(1) / U), I(U), dsh.data_ptr<float>(), bf16, stream()));
  return dsh;
}

Tensor unweight_w(const Tensor& t_, const Tensor& sh_, const Tensor& centers_,
                  const Tensor& dim_to_irr_, int64_t n_irr, bool bf16) {
  auto t = f32(t_, "t"), sh = f32(sh_, "sh");
  auto centers = i32(centers_, "centers"), dim_to_irr = i32(dim_to_irr_, "dim_to_irr");
  int64_t E = sh.size(0), d2 = sh.size(1), U = t.size(1) / d2;
  auto dwexp = at::empty({E, n_irr * U}, t.options().dtype(storage(bf16)));
  if (E > 0)
    launched("unweight_w",
             atpt_unweight_w(t.data_ptr<float>(), sh.data_ptr<float>(), centers.data_ptr<int>(),
                             dim_to_irr.data_ptr<int>(), E, I(t.size(0)), I(d2), I(n_irr), I(U),
                             dwexp.data_ptr(), bf16, stream()));
  return dwexp;
}

Tensor sparse_tp(const Tensor& a_, const Tensor& b_, const Tensor& w_, const Tensor& entry_idx,
                 const Tensor& entry_coef, int64_t d3, const Tensor& desc, const Tensor& scale,
                 const Tensor& path_idx, const Tensor& path_coef) {
  auto a = f32(a_, "a"), b = f32(b_, "b"), w = f32(w_, "w");
  Paths paths(desc, scale, path_idx, path_coef);
  int64_t E = a.size(0), U = w.size(1);
  auto out = at::empty({E, d3 * U}, a.options());
  if (E > 0)
    launched("sparse_tp",
             atpt_sparse_tp(a.data_ptr<float>(), b.data_ptr<float>(), w.data_ptr<float>(),
                            paths.desc.data_ptr<int>(), paths.scale.data_ptr<float>(),
                            paths.rows(), paths.idx.data_ptr<int>(), paths.coef.data_ptr<float>(),
                            E, I(a.size(1) / U), I(b.size(1) / U), I(d3), I(U), I(w.size(0)),
                            out.data_ptr<float>(), stream()));
  return out;
}

}  // namespace

long long atpt_op_launches(const char* name) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_launches.find(name);
  return it == g_launches.end() ? 0 : it->second;
}

TORCH_LIBRARY(atpt, m) {
  m.def("env_scatter(Tensor sh, Tensor wexp, Tensor centers, Tensor row_ptr,"
        " Tensor dim_to_irr, int U, bool bf16) -> Tensor");
  m.def("gather_tp(Tensor x, Tensor env, Tensor w, Tensor centers, Tensor entry_idx,"
        " Tensor entry_coef, int d3, bool split, Tensor desc, Tensor scale, Tensor path_idx,"
        " Tensor path_coef, bool bf16) -> (Tensor, Tensor)");
  m.def("bwd_fused(Tensor x, Tensor g, Tensor? gts, Tensor env, Tensor w, Tensor centers,"
        " Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, Tensor desc, Tensor scale,"
        " Tensor path_idx, Tensor path_coef, Tensor scatter_desc, Tensor scatter_scale,"
        " Tensor scatter_path_idx, Tensor scatter_path_coef, bool bf16) -> (Tensor, Tensor)");
  m.def("unweight_both(Tensor t, Tensor sh, Tensor wexp, Tensor centers, Tensor dim_to_irr,"
        " bool bf16, bool bf16_out) -> (Tensor, Tensor)");
  m.def("center_gather(Tensor a, Tensor idx) -> Tensor");
  m.def("center_sum(Tensor v, Tensor row_ptr, Tensor? perm, bool chunked) -> Tensor");
  m.def("latent_env_scatter(Tensor[] pieces, Tensor sh, Tensor w0, Tensor? w1,"
        " Tensor centers, Tensor row_ptr, Tensor dim_to_irr, Tensor irr_ranges, int U, int S,"
        " bool bf16_wexp) -> (Tensor, Tensor)");
  m.def("latent_env_bwd(Tensor[] pieces, Tensor sh, Tensor w0, Tensor? w1, Tensor t,"
        " Tensor g_lat, Tensor centers, Tensor dim_to_irr, Tensor irr_ranges, int U, int S,"
        " bool bf16_wexp) -> Tensor[]");
  m.def("gather_tp_embed(Tensor sh, Tensor w2b, Tensor env, Tensor w, Tensor centers,"
        " Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, Tensor row_specs, int d3,"
        " bool split, Tensor desc, Tensor scale, Tensor path_idx, Tensor path_coef,"
        " bool bf16) -> (Tensor, Tensor)");
  m.def("bwd_embed(Tensor sh, Tensor w2b, Tensor g, Tensor? gts, Tensor env, Tensor w,"
        " Tensor centers, Tensor row_ptr, Tensor entry_idx, Tensor entry_coef,"
        " Tensor row_specs, Tensor desc, Tensor scale, Tensor path_idx, Tensor path_coef,"
        " bool bf16) -> (Tensor, Tensor, Tensor)");
  m.def("readout_sum(Tensor[] pieces, Tensor w0, Tensor? w1, Tensor row_ptr) -> Tensor");
  m.def("readout_bwd(Tensor[] pieces, Tensor w0, Tensor? w1, Tensor y, Tensor centers)"
        " -> Tensor[]");
  m.def("tp_scatter(Tensor x, Tensor g, Tensor w, Tensor centers, Tensor row_ptr,"
        " Tensor entry_idx, Tensor entry_coef, int d2, Tensor desc, Tensor scale,"
        " Tensor path_idx, Tensor path_coef, bool bf16) -> Tensor");
  m.def("unweight_sh(Tensor t, Tensor wexp, Tensor centers, Tensor dim_to_irr, bool bf16)"
        " -> Tensor");
  m.def("unweight_w(Tensor t, Tensor sh, Tensor centers, Tensor dim_to_irr, int n_irr,"
        " bool bf16) -> Tensor");
  m.def("sparse_tp(Tensor a, Tensor b, Tensor w, Tensor entry_idx, Tensor entry_coef, int d3,"
        " Tensor desc, Tensor scale, Tensor path_idx, Tensor path_coef) -> Tensor");
}

TORCH_LIBRARY_IMPL(atpt, CUDA, m) {
  m.impl("env_scatter", &env_scatter);
  m.impl("gather_tp", &gather_tp);
  m.impl("bwd_fused", &bwd_fused);
  m.impl("unweight_both", &unweight_both);
  m.impl("center_gather", &center_gather);
  m.impl("center_sum", &center_sum);
  m.impl("latent_env_scatter", &latent_env_scatter);
  m.impl("latent_env_bwd", &latent_env_bwd);
  m.impl("gather_tp_embed", &gather_tp_embed);
  m.impl("bwd_embed", &bwd_embed);
  m.impl("readout_sum", &readout_sum);
  m.impl("readout_bwd", &readout_bwd);
  m.impl("tp_scatter", &tp_scatter);
  m.impl("unweight_sh", &unweight_sh);
  m.impl("unweight_w", &unweight_w);
  m.impl("sparse_tp", &sparse_tp);
}
