// allegro_md: the native MD driver on an AOTInductor package of the force
// call (the port's twin of the JAX package's csrc/md_driver.cpp, which runs
// an .atpu through PJRT).
//
// The fully native runtime role of pair_allegro: a C++ binary that loads a
// compiled force call (`python -m allegro_tpu_torch compile`, a .pt2), runs
// it on the CUDA card through libtorch's AOTIModelPackageLoader, and runs
// velocity-Verlet MD with skin-based re-neighboring on the port's cell list
// (csrc/neighborlist.cpp). No Python anywhere in the loop.
//
//   allegro_md --artifact model.pt2 --init system.npz --steps 200 --dt 0.001
//              [--skin 0.5] [--device cuda|cpu] [--out-prefix traj_]
//              [--dump-every N]
//   allegro_md --selftest
//
//   (JAX's driver's options, its PJRT --plugin and --option gone, --device
//   added; --artifact names a .pt2 here, not an .atpu)
//
//   system.npz: positions [N,3] f8, types [N] i4, masses [N] f8, optional
//   velocities [N,3] f8, optional cell [3,3] f8 (rows are lattice vectors)
//   with pbc [3] i4/b1 for periodic systems.
//   Package contract (its metadata, compile/export.py): inputs
//   (positions [Na,3], edge_index [2,Ne] i4, atom_types [Na] i4, node_mask
//   [Na] b1, edge_mask [Ne] b1), outputs (atomic_energy, forces,
//   total_energy[, virial]).
//
//   Periodic boundaries run through the ghost-atom conversion (the LAMMPS /
//   pair_allegro data contract, compile/targets.py): at every re-neighboring
//   each distinct (neighbor, nonzero cell shift) pair becomes a ghost row
//   after the N real atoms (its owner's type, node_mask 1 so the model emits
//   its force), and the edges are rewired to the ghosts. Every step the ghost
//   positions are refreshed as pos[owner] + shift @ cell and the ghost forces
//   are collapsed onto their owners. The energy reported is the per-atom
//   energy summed over the REAL rows only (a ghost row carries its type's
//   energy shift by construction).
//
// The package calls the kernels as the ops of the `atpt` namespace, which
// csrc/torch_ops.cpp registers in this process. Its matrix-product policy
// (metadata "precision") sets TF32 for the run.
//
// Build: allegro_tpu_torch/native/md_driver.py (g++ against PyTorch's
// headers and libraries, with md_core.cpp, neighborlist.cpp, torch_ops.cpp
// and the kernels' library).

#include <ATen/ATen.h>
#include <c10/core/InferenceMode.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "md_core.h"

extern "C" long long atpt_op_launches(const char* name);

using namespace atpt_md;

namespace {

const char* kFormat = "allegro-tpu-torch-pt2-v1";
const char* kOps[] = {"env_scatter",    "gather_tp",       "bwd_fused",   "unweight_both",
                      "center_gather",  "center_sum",      "latent_env_scatter",
                      "latent_env_bwd", "gather_tp_embed", "bwd_embed",   "readout_sum",
                      "readout_bwd",    "tp_scatter",      "unweight_sh", "unweight_w",
                      "sparse_tp"};

std::string meta_at(const std::unordered_map<std::string, std::string>& meta,
                    const std::string& key) {
  auto it = meta.find(key);
  if (it == meta.end()) die("package metadata has no " + key);
  return it->second;
}

}  // namespace

int main(int argc, char** argv) {
  std::string package, init, device_name = "cuda", out_prefix = "allegro_md_";
  int64_t steps = 100, dump_every = 0;
  double dt = 1e-3, skin = 0.5;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) die("missing value for " + a);
      return argv[++i];
    };
    if (a == "--selftest") return selftest();
    if (a == "--artifact") package = next();
    else if (a == "--init") init = next();
    else if (a == "--steps") steps = std::atoll(next().c_str());
    else if (a == "--dt") dt = std::atof(next().c_str());
    else if (a == "--skin") skin = std::atof(next().c_str());
    else if (a == "--device") device_name = next();
    else if (a == "--out-prefix") out_prefix = next();
    else if (a == "--dump-every") dump_every = std::atoll(next().c_str());
    else die("unknown argument " + a);
  }
  if (package.empty() || init.empty()) die("required: --artifact and --init (or --selftest)");

  c10::InferenceMode inference;
  const c10::Device device(device_name);
  torch::inductor::AOTIModelPackageLoader loader(package);
  auto meta = loader.get_metadata();
  if (meta_at(meta, "format") != kFormat) die("not a package of compile/export.py: " + package);
  if (meta_at(meta, "device") != device.str())
    die("the package runs on " + meta_at(meta, "device") + ", asked for " + device.str());
  const int64_t n_atoms_pad = std::atoll(meta_at(meta, "n_atoms").c_str());
  const int64_t n_edges_pad = std::atoll(meta_at(meta, "n_edges").c_str());
  const double r_max = std::atof(meta_at(meta, "r_max").c_str());
  const auto dtype = meta_at(meta, "dtype") == "float64" ? at::kDouble : at::kFloat;
  // the model's matrix-product policy: TF32 only where its precision is None
  const bool tf32 = meta_at(meta, "precision") == "None";
  at::globalContext().setAllowTF32CuBLAS(tf32);
  at::globalContext().setAllowTF32CuDNN(tf32);
  std::fprintf(stderr, "allegro_md: package n_atoms=%lld n_edges=%lld r_max=%.3f %s on %s\n",
               (long long)n_atoms_pad, (long long)n_edges_pad, r_max,
               meta_at(meta, "dtype").c_str(), device.str().c_str());

  System sys = load_system(init);
  if (sys.n > n_atoms_pad) die("the system has more atoms than the package's padded shape");

  const auto on_device = [&](const at::Tensor& host) { return host.to(device); };
  at::Tensor eidx_dev, emask_dev, types_dev, nmask_dev;
  EdgeSet edges;
  GhostSet ghosts;
  std::vector<double> ref_pos, rows(3 * n_atoms_pad, 0.0), row_forces(3 * n_atoms_pad, 0.0);
  std::vector<double> force(3 * sys.n, 0.0), force_new(3 * sys.n, 0.0);
  int64_t rebuilds = 0;

  auto need_rebuild = [&]() {
    if (ref_pos.empty()) return true;
    const double lim = 0.25 * skin * skin;
    for (int64_t i = 0; i < 3 * sys.n; i += 3) {
      double dx = sys.pos[i] - ref_pos[i], dy = sys.pos[i + 1] - ref_pos[i + 1],
             dz = sys.pos[i + 2] - ref_pos[i + 2];
      if (dx * dx + dy * dy + dz * dz > lim) return true;
    }
    return false;
  };

  // re-neighboring: wrap, list, ghosts; the static inputs go to the device
  auto rebuild = [&]() {
    wrap_positions(sys);
    edges = build_edges(sys, r_max + skin, n_edges_pad, n_atoms_pad, ghosts);
    const int64_t G = int64_t(ghosts.owner.size());
    if (sys.n + G > n_atoms_pad)
      die("atoms + ghosts (" + std::to_string(sys.n + G) + ") exceed the package's n_atoms " +
          std::to_string(n_atoms_pad));
    auto types = at::zeros({n_atoms_pad}, at::kInt);
    auto nmask = at::zeros({n_atoms_pad}, at::kBool);
    auto* t = types.data_ptr<int32_t>();
    auto* m = nmask.data_ptr<bool>();
    for (int64_t i = 0; i < sys.n + G; ++i) {
      t[i] = sys.types[i < sys.n ? i : ghosts.owner[i - sys.n]];
      m[i] = true;  // ghosts too: the forces are NODE_MASK-gated on the device
    }
    types_dev = on_device(types);
    nmask_dev = on_device(nmask);
    eidx_dev = on_device(at::from_blob(edges.eidx.data(), {2, n_edges_pad}, at::kInt));
    emask_dev = on_device(at::from_blob(edges.edge_mask.data(), {n_edges_pad}, at::kBool));
    ref_pos = sys.pos;
    rebuilds++;
  };

  double energy = 0.0;
  double virial[9] = {0};  // Σ rᵢ ⊗ fᵢ over real + ghost rows (fdotr)
  auto eval_forces = [&](std::vector<double>& f_out) {
    const int64_t n_rows = sys.n + int64_t(ghosts.owner.size());
    fill_rows(sys, ghosts, rows);
    auto pos = at::from_blob(rows.data(), {n_atoms_pad, 3}, at::kDouble).to(dtype);
    std::vector<at::Tensor> inputs = {on_device(pos), eidx_dev, types_dev, nmask_dev, emask_dev};
    auto out = loader.run(inputs);
    if (out.size() < 3) die("the package returned fewer than 3 outputs");
    auto aenergy = out[0].to(at::kCPU, at::kDouble).contiguous();
    auto forces = out[1].to(at::kCPU, at::kDouble).contiguous();
    const double* fe = forces.data_ptr<double>();
    std::copy(fe, fe + 3 * n_atoms_pad, row_forces.begin());
    energy = 0.0;
    for (int64_t i = 0; i < sys.n; ++i) energy += aenergy.data_ptr<double>()[i];
    collapse_ghost_forces(sys, ghosts, row_forces, f_out);
    std::fill(virial, virial + 9, 0.0);
    for (int64_t i = 0; i < n_rows; ++i)
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) virial[3 * a + b] += rows[3 * i + a] * row_forces[3 * i + b];
  };

  const auto t0 = std::chrono::steady_clock::now();
  rebuild();
  eval_forces(force);
  std::fprintf(stderr, "allegro_md: step 0 E=%.6f\n", energy);
  const auto t1 = std::chrono::steady_clock::now();
  std::vector<float> traj;
  for (int64_t step = 1; step <= steps; ++step) {
    verlet_positions(sys, force, dt);
    if (need_rebuild()) rebuild();
    eval_forces(force_new);
    verlet_velocities(sys, force, force_new, dt);
    std::swap(force, force_new);
    if (dump_every && step % dump_every == 0) {
      for (int64_t i = 0; i < 3 * sys.n; ++i) traj.push_back(float(sys.pos[i]));
      double ke = kinetic_energy(sys);
      std::fprintf(stderr, "allegro_md: step %lld E=%.6f KE=%.6f E+KE=%.6f\n", (long long)step,
                   energy, ke, energy + ke);
    }
  }
  const auto t2 = std::chrono::steady_clock::now();
  write_npy(out_prefix + "positions.npy", sys.pos.data(), {sys.n, 3}, "<f8");
  write_npy(out_prefix + "velocities.npy", sys.vel.data(), {sys.n, 3}, "<f8");
  write_npy(out_prefix + "virial.npy", virial, {3, 3}, "<f8");
  if (!traj.empty())
    write_npy(out_prefix + "trajectory.npy", traj.data(),
              {int64_t(traj.size() / (3 * sys.n)), sys.n, 3}, "<f4");
  const double ms_first = std::chrono::duration<double, std::milli>(t1 - t0).count();
  const double ms_step =
      steps ? std::chrono::duration<double, std::milli>(t2 - t1).count() / double(steps) : 0.0;
  std::string launches;
  for (const char* op : kOps)
    launches += std::string(launches.empty() ? "" : ", ") + "\"" + op +
                "\": " + std::to_string(atpt_op_launches(op));
  std::fprintf(stderr, "allegro_md: done (%lld steps, %lld rebuilds) E=%.6f\n", (long long)steps,
               (long long)rebuilds, energy);
  std::printf("{\"steps\": %lld, \"rebuilds\": %lld, \"final_energy\": %.8f, "
              "\"first_call_ms\": %.3f, \"ms_per_step\": %.4f, \"launches\": {%s}}\n",
              (long long)steps, (long long)rebuilds, energy, ms_first, ms_step, launches.c_str());
  return 0;
}
