// The torch-free core of the native MD driver (csrc/md_driver.cpp): npy/zip
// reading and writing, the system file, the center-sorted neighbor list with
// sentinel padding and ghost atoms, and the velocity-Verlet integrator.
//
// It compiles with plain g++ in seconds (with csrc/neighborlist.cpp), so the
// CPU tests build it and run its --selftest; md_driver.cpp adds the model,
// an AOTInductor package run through libtorch.

#pragma once

#include <array>
#include <cstdint>
#include <map>
#include <string>
#include <vector>

// from neighborlist.cpp (the C interface the Python ctypes binding uses)
extern "C" long long atpt_neighbor_list(const double* pos_in, long long n,
                                        const double* cell_in, const int* pbc,
                                        double r_max, long long cap, int* out_i,
                                        int* out_j, double* out_shift);

namespace atpt_md {

[[noreturn]] void die(const std::string& msg);

// --- minimal ZIP (stored entries only: what np.savez writes by default) ---

struct ZipEntry {
  std::string name;
  std::vector<uint8_t> data;
};

std::vector<ZipEntry> read_zip(const std::vector<uint8_t>& buf);
std::vector<uint8_t> write_zip(const std::vector<ZipEntry>& entries);
std::vector<uint8_t> read_file(const std::string& path);

// --- minimal NPY ---

struct NpyArray {
  std::string descr;  // e.g. "<f8"
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;
  int64_t numel() const;
};

NpyArray parse_npy(const std::vector<uint8_t>& buf);
std::vector<uint8_t> npy_bytes(const void* data, const std::vector<int64_t>& shape,
                               const std::string& descr);
void write_npy(const std::string& path, const void* data, const std::vector<int64_t>& shape,
               const std::string& descr);
std::map<std::string, NpyArray> parse_npz(const std::vector<uint8_t>& buf);

// --- the system and its neighbor list ---

struct System {
  int64_t n = 0;
  std::vector<double> pos;     // [N,3]
  std::vector<double> vel;     // [N,3]
  std::vector<double> mass;    // [N]
  std::vector<int32_t> types;  // [N]
  double cell[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};  // rows are lattice vectors
  int pbc[3] = {0, 0, 0};
  bool periodic = false;
};

// system.npz: positions [N,3] f8, types [N] i4, masses [N] f8, optional
// velocities [N,3] f8, optional cell [3,3] f8 with pbc [3] i4/i8/b1
System load_system(const std::string& path);

// wraps the positions into the cell along periodic axes (at re-neighboring)
void wrap_positions(System& s);

// ghost atoms appended after the N real rows of a periodic system: each
// distinct (neighbor, nonzero cell shift) pair of the list, at
// pos[owner] + shift @ cell (the port's compile/targets.py
// ghost_atom_conversion)
struct GhostSet {
  std::vector<int32_t> owner;      // [G] the owning real atom
  std::vector<double> shift_cart;  // [G*3] shift @ cell
};

// the center-sorted list padded to n_edges_pad: padded edges carry the
// sentinel atom in both rows and edge_mask 0
struct EdgeSet {
  std::vector<int32_t> eidx;       // [2 * n_edges_pad]
  std::vector<uint8_t> edge_mask;  // [n_edges_pad]
  int64_t n_real = 0;
};

EdgeSet build_edges(const System& s, double r_max, int64_t n_edges_pad, int64_t sentinel,
                    GhostSet& ghosts);

// the model's input rows: the N real positions, then every ghost at its
// owner's current position + its shift (refreshed every step)
void fill_rows(const System& s, const GhostSet& ghosts, std::vector<double>& rows);

// per-row forces [N+G,3] → per-atom forces [N,3]: each ghost's force added
// to its owner's (pair_allegro's force return)
void collapse_ghost_forces(const System& s, const GhostSet& ghosts,
                           const std::vector<double>& row_forces, std::vector<double>& f_out);

// velocity Verlet: the position update, then (after the new forces) the
// velocity update
void verlet_positions(System& s, const std::vector<double>& force, double dt);
void verlet_velocities(System& s, const std::vector<double>& f_old,
                       const std::vector<double>& f_new, double dt);
double kinetic_energy(const System& s);

// the artifact-free checks: npy/zip round trip, the sentinel-padded
// center-sorted list, the ghost refresh, NVE drift on a harmonic field
int selftest();

}  // namespace atpt_md
