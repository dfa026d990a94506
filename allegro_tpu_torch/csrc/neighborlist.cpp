// Cell-list neighbor list for periodic/open triclinic boxes (host C++).
//
// The port's own copy of the JAX package's csrc/neighborlist.cpp, built with
// g++ at first use and called through ctypes by
// allegro_tpu_torch/native/neighborlist.py; the scipy cKDTree list of
// allegro_tpu_torch/data/neighborlist.py is the fallback where no toolchain
// exists.
//
// Semantics (must match allegro_tpu_torch.data.neighborlist's scipy list):
//   directed edges (i=center, j=neighbor) with integer cell shifts such that
//   r_ij = pos[j] - pos[i] + shift @ cell and |r_ij| < r_max; both directions
//   emitted; self-edges excluded only at zero shift. Each center's edges are
//   written together, in the order below, whatever the thread count.
//
// Algorithm: fractional-coordinate binning with bin width >= r_max along each
// cell height; neighbor bins enumerated within the exact reach (handles thin
// cells needing multiple periodic images). O(N * avg_neighbors).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Mat3 {
  double m[3][3];
};

// invert a 3x3 matrix (rows are lattice vectors)
static bool invert3(const double* a, double* inv) {
  double det = a[0] * (a[4] * a[8] - a[5] * a[7]) -
               a[1] * (a[3] * a[8] - a[5] * a[6]) +
               a[2] * (a[3] * a[7] - a[4] * a[6]);
  if (std::fabs(det) < 1e-300) return false;
  double id = 1.0 / det;
  inv[0] = (a[4] * a[8] - a[5] * a[7]) * id;
  inv[1] = (a[2] * a[7] - a[1] * a[8]) * id;
  inv[2] = (a[1] * a[5] - a[2] * a[4]) * id;
  inv[3] = (a[5] * a[6] - a[3] * a[8]) * id;
  inv[4] = (a[0] * a[8] - a[2] * a[6]) * id;
  inv[5] = (a[2] * a[3] - a[0] * a[5]) * id;
  inv[6] = (a[3] * a[7] - a[4] * a[6]) * id;
  inv[7] = (a[1] * a[6] - a[0] * a[7]) * id;
  inv[8] = (a[0] * a[4] - a[1] * a[3]) * id;
  return true;
}

}  // namespace

extern "C" {

// Returns the number of edges written, or -(required capacity) if `cap` was
// too small (caller should retry with a larger buffer), or -1 on error.
long long atpt_neighbor_list(const double* pos_in, long long n,
                             const double* cell_in, const int* pbc,
                             double r_max, long long cap, int* out_i,
                             int* out_j, double* out_shift) {
  if (n <= 0) return 0;
  double cell[9];
  std::memcpy(cell, cell_in, sizeof(cell));
  double inv[9];
  if (!invert3(cell, inv)) return -1;

  // fractional coordinates; wrap along periodic axes
  std::vector<double> frac(3 * n);
  std::vector<double> pos(3 * n);
  std::memcpy(pos.data(), pos_in, sizeof(double) * 3 * n);
  for (long long a = 0; a < n; ++a) {
    for (int k = 0; k < 3; ++k) {
      double f = pos[3 * a + 0] * inv[0 + k] + pos[3 * a + 1] * inv[3 + k] +
                 pos[3 * a + 2] * inv[6 + k];
      if (pbc[k]) f -= std::floor(f);
      frac[3 * a + k] = f;
    }
    // recompute wrapped cartesian
    for (int k = 0; k < 3; ++k) {
      pos[3 * a + k] = frac[3 * a + 0] * cell[0 + k] +
                       frac[3 * a + 1] * cell[3 + k] +
                       frac[3 * a + 2] * cell[6 + k];
    }
  }

  // heights: distance between opposite faces along each axis
  double height[3];
  for (int k = 0; k < 3; ++k) {
    double nrm = std::sqrt(inv[3 * 0 + k] * inv[3 * 0 + k] +
                           inv[3 * 1 + k] * inv[3 * 1 + k] +
                           inv[3 * 2 + k] * inv[3 * 2 + k]);
    height[k] = 1.0 / nrm;
  }

  // fractional extents (for non-periodic axes the atoms may span any range)
  double flo[3] = {0, 0, 0}, fhi[3] = {1, 1, 1};
  for (int k = 0; k < 3; ++k) {
    if (!pbc[k]) {
      flo[k] = 1e300;
      fhi[k] = -1e300;
      for (long long a = 0; a < n; ++a) {
        double f = frac[3 * a + k];
        if (f < flo[k]) flo[k] = f;
        if (f > fhi[k]) fhi[k] = f;
      }
      fhi[k] += 1e-9;
      flo[k] -= 1e-9;
    }
  }

  int nb[3], reach[3];
  for (int k = 0; k < 3; ++k) {
    double span_dist = height[k] * (fhi[k] - flo[k]);
    nb[k] = (int)std::floor(span_dist / r_max);
    if (nb[k] < 1) nb[k] = 1;
    if (nb[k] > 1024) nb[k] = 1024;
    double bin_width = span_dist / nb[k];
    reach[k] = (int)std::ceil(r_max / bin_width - 1e-12);
    if (!pbc[k] && reach[k] > nb[k]) reach[k] = nb[k];
  }

  const long long nbins = (long long)nb[0] * nb[1] * nb[2];
  std::vector<int> bin_of(n);
  std::vector<int> count(nbins, 0);
  auto bin_index = [&](long long a) {
    int b[3];
    for (int k = 0; k < 3; ++k) {
      double rel = (frac[3 * a + k] - flo[k]) / (fhi[k] - flo[k]);
      int bi = (int)(rel * nb[k]);
      if (bi >= nb[k]) bi = nb[k] - 1;
      if (bi < 0) bi = 0;
      b[k] = bi;
    }
    return (b[0] * nb[1] + b[1]) * nb[2] + b[2];
  };
  for (long long a = 0; a < n; ++a) {
    bin_of[a] = (int)bin_index(a);
    count[bin_of[a]]++;
  }
  std::vector<long long> start(nbins + 1, 0);
  for (long long b = 0; b < nbins; ++b) start[b + 1] = start[b] + count[b];
  std::vector<int> order(n);
  {
    std::vector<long long> cur(start.begin(), start.end() - 1);
    for (long long a = 0; a < n; ++a) order[cur[bin_of[a]]++] = (int)a;
  }

  const double r2 = r_max * r_max;

  struct Rec {
    int i, j;
    int8_t s0, s1, s2;
  };
  int n_threads = 1;
#ifdef _OPENMP
  n_threads = omp_get_max_threads();
#endif
  std::vector<std::vector<Rec>> results(n_threads);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (long long a = 0; a < n; ++a) {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    std::vector<Rec>& out = results[tid];
    int ba[3];
    {
      long long idx = bin_of[a];
      ba[2] = (int)(idx % nb[2]);
      ba[1] = (int)((idx / nb[2]) % nb[1]);
      ba[0] = (int)(idx / ((long long)nb[1] * nb[2]));
    }
    for (int o0 = -reach[0]; o0 <= reach[0]; ++o0) {
      int b0 = ba[0] + o0;
      int s0 = 0;
      if (pbc[0]) {
        while (b0 < 0) { b0 += nb[0]; --s0; }
        while (b0 >= nb[0]) { b0 -= nb[0]; ++s0; }
      } else if (b0 < 0 || b0 >= nb[0]) continue;
      // dedupe multiple offsets mapping to the same (bin, shift): with the
      // enumeration above each (o) gives a unique shift when nb is small, so
      // (b0, s0) pairs are distinct across o.
      for (int o1 = -reach[1]; o1 <= reach[1]; ++o1) {
        int b1 = ba[1] + o1;
        int s1 = 0;
        if (pbc[1]) {
          while (b1 < 0) { b1 += nb[1]; --s1; }
          while (b1 >= nb[1]) { b1 -= nb[1]; ++s1; }
        } else if (b1 < 0 || b1 >= nb[1]) continue;
        for (int o2 = -reach[2]; o2 <= reach[2]; ++o2) {
          int b2 = ba[2] + o2;
          int s2 = 0;
          if (pbc[2]) {
            while (b2 < 0) { b2 += nb[2]; --s2; }
            while (b2 >= nb[2]) { b2 -= nb[2]; ++s2; }
          } else if (b2 < 0 || b2 >= nb[2]) continue;
          long long nbidx = ((long long)b0 * nb[1] + b1) * nb[2] + b2;
          double sc[3];  // shift in cartesian
          for (int k = 0; k < 3; ++k)
            sc[k] = s0 * cell[0 + k] + s1 * cell[3 + k] + s2 * cell[6 + k];
          for (long long t = start[nbidx]; t < start[nbidx + 1]; ++t) {
            int jj = order[t];
            if (jj == (int)a && s0 == 0 && s1 == 0 && s2 == 0) continue;
            double dx = pos[3 * jj + 0] + sc[0] - pos[3 * a + 0];
            double dy = pos[3 * jj + 1] + sc[1] - pos[3 * a + 1];
            double dz = pos[3 * jj + 2] + sc[2] - pos[3 * a + 2];
            double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < r2) {
              out.push_back(Rec{(int)a, jj, (int8_t)s0, (int8_t)s1, (int8_t)s2});
            }
          }
        }
      }
    }
  }

  long long needed = 0;
  for (const auto& v : results) needed += (long long)v.size();
  if (needed > cap) return -needed;
  long long n_out = 0;
  for (const auto& v : results) {
    for (const Rec& r : v) {
      out_i[n_out] = r.i;
      out_j[n_out] = r.j;
      out_shift[3 * n_out + 0] = (double)r.s0;
      out_shift[3 * n_out + 1] = (double)r.s1;
      out_shift[3 * n_out + 2] = (double)r.s2;
      ++n_out;
    }
  }
  return n_out;
}

}  // extern "C"
