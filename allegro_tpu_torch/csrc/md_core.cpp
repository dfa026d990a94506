// The torch-free core of the native MD driver (see md_core.h): the port's
// copy of what the JAX package's csrc/md_driver.cpp does besides running the
// model, with the same system file and the same list contract.
//
// Built alone with -DATPT_MD_CORE_MAIN, it is a binary that runs --selftest:
//   g++ -O2 -std=c++17 -fopenmp -DATPT_MD_CORE_MAIN md_core.cpp neighborlist.cpp

#include "md_core.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <numeric>

namespace atpt_md {

void die(const std::string& msg) {
  std::fprintf(stderr, "allegro_md: %s\n", msg.c_str());
  std::exit(1);
}

namespace {

uint32_t rd32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
uint16_t rd16(const uint8_t* p) { return uint16_t(p[0]) | uint16_t(p[1]) << 8; }
void put16(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(uint8_t(v));
  b.push_back(uint8_t(v >> 8));
}
void put32(std::vector<uint8_t>& b, uint32_t v) {
  put16(b, v & 0xffff);
  put16(b, v >> 16);
}

uint32_t crc32(const std::vector<uint8_t>& data) {
  uint32_t c = 0xffffffffu;
  for (uint8_t byte : data) {
    c ^= byte;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0xedb88320u & (0u - (c & 1u)));
  }
  return ~c;
}

// 3x3 inverse (rows are lattice vectors); false on a singular cell
bool invert3x3(const double* a, double* inv) {
  double det = a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
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

template <typename T>
std::vector<T> as_vector(const NpyArray& a, const char* descr, int64_t count, const char* what) {
  if (a.descr != descr || a.numel() != count)
    die(std::string("init: ") + what + " must be " + descr + " with " + std::to_string(count) +
        " elements");
  const T* p = reinterpret_cast<const T*>(a.data.data());
  return std::vector<T>(p, p + count);
}

}  // namespace

// ---------------------------------------------------------------------------
// ZIP
// ---------------------------------------------------------------------------

std::vector<ZipEntry> read_zip(const std::vector<uint8_t>& buf) {
  std::vector<ZipEntry> out;
  size_t pos = 0;
  while (pos + 30 <= buf.size()) {
    if (rd32(&buf[pos]) != 0x04034b50u) break;  // local file header magic
    uint16_t flags = rd16(&buf[pos + 6]);
    uint16_t method = rd16(&buf[pos + 8]);
    uint64_t comp_size = rd32(&buf[pos + 18]);
    uint64_t uncomp_size = rd32(&buf[pos + 22]);
    uint16_t name_len = rd16(&buf[pos + 26]);
    uint16_t extra_len = rd16(&buf[pos + 28]);
    std::string name(reinterpret_cast<const char*>(&buf[pos + 30]), name_len);
    // zip64 (np.savez may force it): the 32-bit sizes read 0xFFFFFFFF and
    // the real ones are in extra record 0x0001 (uncompressed, compressed)
    if (comp_size == 0xFFFFFFFFu || uncomp_size == 0xFFFFFFFFu) {
      size_t ep = pos + 30 + name_len, eend = ep + extra_len;
      while (ep + 4 <= eend) {
        uint16_t hid = rd16(&buf[ep]), hsz = rd16(&buf[ep + 2]);
        if (hid == 0x0001 && ep + 4 + hsz <= eend) {
          const uint8_t* f = &buf[ep + 4];
          if (uncomp_size == 0xFFFFFFFFu && hsz >= 8) {
            uncomp_size = uint64_t(rd32(f)) | uint64_t(rd32(f + 4)) << 32;
            f += 8;
          }
          if (comp_size == 0xFFFFFFFFu && hsz >= 16)
            comp_size = uint64_t(rd32(f)) | uint64_t(rd32(f + 4)) << 32;
          break;
        }
        ep += 4 + hsz;
      }
      if (comp_size == 0xFFFFFFFFu) comp_size = uncomp_size;  // stored entries
    }
    size_t data_off = pos + 30 + name_len + extra_len;
    if (flags & 0x8) die("zip: streamed entries (data descriptors) unsupported: " + name);
    if (method != 0)
      die("zip: compressed entry (method " + std::to_string(method) + ") unsupported: " + name +
          " (write the system with np.savez, not savez_compressed)");
    if (data_off + comp_size > buf.size()) die("zip: truncated entry " + name);
    out.push_back({name, std::vector<uint8_t>(buf.begin() + data_off,
                                              buf.begin() + data_off + comp_size)});
    pos = data_off + comp_size;
  }
  if (out.empty()) die("zip: no entries (bad magic?)");
  return out;
}

std::vector<uint8_t> write_zip(const std::vector<ZipEntry>& entries) {
  std::vector<uint8_t> out, central;
  for (const auto& e : entries) {
    uint32_t offset = uint32_t(out.size()), crc = crc32(e.data), size = uint32_t(e.data.size());
    put32(out, 0x04034b50u);
    put16(out, 20);  // version needed
    put16(out, 0);   // flags
    put16(out, 0);   // stored
    put32(out, 0);   // time, date
    put32(out, crc);
    put32(out, size);
    put32(out, size);
    put16(out, uint32_t(e.name.size()));
    put16(out, 0);
    out.insert(out.end(), e.name.begin(), e.name.end());
    out.insert(out.end(), e.data.begin(), e.data.end());
    put32(central, 0x02014b50u);
    put16(central, 20);
    put16(central, 20);
    put16(central, 0);
    put16(central, 0);
    put32(central, 0);
    put32(central, crc);
    put32(central, size);
    put32(central, size);
    put16(central, uint32_t(e.name.size()));
    for (int k = 0; k < 4; ++k) put16(central, 0);  // extra, comment, disk, internal attrs
    put32(central, 0);                              // external attrs
    put32(central, offset);
    central.insert(central.end(), e.name.begin(), e.name.end());
  }
  uint32_t cd_offset = uint32_t(out.size()), cd_size = uint32_t(central.size());
  out.insert(out.end(), central.begin(), central.end());
  put32(out, 0x06054b50u);
  put16(out, 0);
  put16(out, 0);
  put16(out, uint32_t(entries.size()));
  put16(out, uint32_t(entries.size()));
  put32(out, cd_size);
  put32(out, cd_offset);
  put16(out, 0);
  return out;
}

std::vector<uint8_t> read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) die("cannot open " + path);
  return std::vector<uint8_t>((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
}

// ---------------------------------------------------------------------------
// NPY
// ---------------------------------------------------------------------------

int64_t NpyArray::numel() const {
  int64_t n = 1;
  for (auto d : shape) n *= d;
  return n;
}

NpyArray parse_npy(const std::vector<uint8_t>& buf) {
  if (buf.size() < 10 || std::memcmp(buf.data(), "\x93NUMPY", 6) != 0) die("npy: bad magic");
  size_t hlen = buf[6] == 1 ? rd16(&buf[8]) : rd32(&buf[8]);
  size_t hoff = buf[6] == 1 ? 10 : 12;
  if (hoff + hlen > buf.size()) die("npy: truncated header");
  std::string hdr(reinterpret_cast<const char*>(&buf[hoff]), hlen);
  NpyArray a;
  auto dpos = hdr.find("'descr'");
  auto q1 = hdr.find('\'', dpos + 7);
  auto q2 = hdr.find('\'', q1 + 1);
  a.descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (hdr.find("'fortran_order': True") != std::string::npos) die("npy: fortran order unsupported");
  auto p1 = hdr.find('(', hdr.find("'shape'"));
  auto p2 = hdr.find(')', p1);
  std::string shp = hdr.substr(p1 + 1, p2 - p1 - 1);
  for (size_t i = 0; i < shp.size();) {
    while (i < shp.size() && !isdigit(shp[i])) i++;
    if (i >= shp.size()) break;
    a.shape.push_back(std::atoll(shp.c_str() + i));
    while (i < shp.size() && isdigit(shp[i])) i++;
  }
  a.data.assign(buf.begin() + hoff + hlen, buf.end());
  size_t itemsize = size_t(std::atoi(a.descr.c_str() + 2));
  if (a.data.size() < size_t(a.numel()) * itemsize) die("npy: truncated data");
  return a;
}

std::vector<uint8_t> npy_bytes(const void* data, const std::vector<int64_t>& shape,
                               const std::string& descr) {
  std::string shp = "(";
  for (size_t i = 0; i < shape.size(); ++i)
    shp += std::to_string(shape[i]) + (shape.size() == 1 || i + 1 < shape.size() ? "," : "");
  shp += ")";
  std::string hdr = "{'descr': '" + descr + "', 'fortran_order': False, 'shape': " + shp + ", }";
  hdr += std::string((64 - (10 + hdr.size() + 1) % 64) % 64, ' ') + '\n';
  std::vector<uint8_t> out = {0x93, 'N', 'U', 'M', 'P', 'Y', 1, 0};
  put16(out, uint32_t(hdr.size()));
  out.insert(out.end(), hdr.begin(), hdr.end());
  int64_t n = 1;
  for (auto d : shape) n *= d;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(data);
  out.insert(out.end(), p, p + n * std::atoi(descr.c_str() + 2));
  return out;
}

void write_npy(const std::string& path, const void* data, const std::vector<int64_t>& shape,
               const std::string& descr) {
  auto bytes = npy_bytes(data, shape, descr);
  std::ofstream f(path, std::ios::binary);
  if (!f) die("cannot write " + path);
  f.write(reinterpret_cast<const char*>(bytes.data()), bytes.size());
}

std::map<std::string, NpyArray> parse_npz(const std::vector<uint8_t>& buf) {
  std::map<std::string, NpyArray> out;
  for (auto& e : read_zip(buf)) {
    std::string key = e.name;
    if (key.size() > 4 && key.substr(key.size() - 4) == ".npy") key.resize(key.size() - 4);
    out[key] = parse_npy(e.data);
  }
  return out;
}

// ---------------------------------------------------------------------------
// the system and its list
// ---------------------------------------------------------------------------

System load_system(const std::string& path) {
  auto npz = parse_npz(read_file(path));
  for (const char* k : {"positions", "types", "masses"})
    if (!npz.count(k)) die(std::string("init: missing ") + k);
  System s;
  s.n = npz.at("positions").shape.empty() ? 0 : npz.at("positions").shape[0];
  s.pos = as_vector<double>(npz.at("positions"), "<f8", 3 * s.n, "positions");
  s.types = as_vector<int32_t>(npz.at("types"), "<i4", s.n, "types");
  s.mass = as_vector<double>(npz.at("masses"), "<f8", s.n, "masses");
  s.vel = npz.count("velocities")
              ? as_vector<double>(npz.at("velocities"), "<f8", 3 * s.n, "velocities")
              : std::vector<double>(3 * s.n, 0.0);
  if (npz.count("cell")) {
    auto c = as_vector<double>(npz.at("cell"), "<f8", 9, "cell");
    std::copy(c.begin(), c.end(), s.cell);
    if (npz.count("pbc")) {
      const auto& p = npz.at("pbc");
      for (int k = 0; k < 3; ++k) {
        if (p.descr == "<i4") s.pbc[k] = reinterpret_cast<const int32_t*>(p.data.data())[k] != 0;
        else if (p.descr == "<i8") s.pbc[k] = reinterpret_cast<const int64_t*>(p.data.data())[k] != 0;
        else if (p.descr == "|b1") s.pbc[k] = p.data[k] != 0;
        else die("init: pbc must be i4, i8 or b1");
      }
    } else {
      s.pbc[0] = s.pbc[1] = s.pbc[2] = 1;
    }
    s.periodic = s.pbc[0] || s.pbc[1] || s.pbc[2];
  }
  return s;
}

void wrap_positions(System& s) {
  if (!s.periodic) return;
  double inv[9];
  if (!invert3x3(s.cell, inv)) die("singular cell");
  for (int64_t a = 0; a < s.n; ++a) {
    double f[3];
    for (int k = 0; k < 3; ++k)
      f[k] = s.pos[3 * a] * inv[k] + s.pos[3 * a + 1] * inv[3 + k] + s.pos[3 * a + 2] * inv[6 + k];
    for (int k = 0; k < 3; ++k)
      if (s.pbc[k]) f[k] -= std::floor(f[k]);
    for (int k = 0; k < 3; ++k)
      s.pos[3 * a + k] = f[0] * s.cell[k] + f[1] * s.cell[3 + k] + f[2] * s.cell[6 + k];
  }
}

EdgeSet build_edges(const System& s, double r_max, int64_t n_edges_pad, int64_t sentinel,
                    GhostSet& ghosts) {
  const double open_cell[9] = {1e6, 0, 0, 0, 1e6, 0, 0, 0, 1e6};
  const int open_pbc[3] = {0, 0, 0};
  int64_t cap = std::max<int64_t>(n_edges_pad, 1);
  std::vector<int> oi(cap), oj(cap);
  std::vector<double> oshift(3 * cap);
  long long ne = atpt_neighbor_list(s.pos.data(), s.n, s.periodic ? s.cell : open_cell,
                                    s.periodic ? s.pbc : open_pbc, r_max, cap, oi.data(),
                                    oj.data(), oshift.data());
  if (ne < -1)
    die("edge overflow: the list needs " + std::to_string(-ne) + " edges, the package takes " +
        std::to_string(n_edges_pad));
  if (ne < 0) die("neighbor list error");
  // each distinct (neighbor, nonzero integer shift) pair becomes one ghost
  // row; its edges are rewired to it
  ghosts.owner.clear();
  ghosts.shift_cart.clear();
  std::vector<int32_t> newj(oj.begin(), oj.begin() + ne);
  if (s.periodic) {
    std::map<std::array<int64_t, 4>, int32_t> gmap;
    for (int64_t k = 0; k < ne; ++k) {
      std::array<int64_t, 4> key = {oj[k], llround(oshift[3 * k]), llround(oshift[3 * k + 1]),
                                    llround(oshift[3 * k + 2])};
      if (key[1] == 0 && key[2] == 0 && key[3] == 0) continue;
      auto it = gmap.find(key);
      if (it == gmap.end()) {
        it = gmap.emplace(key, int32_t(s.n + int64_t(ghosts.owner.size()))).first;
        ghosts.owner.push_back(oj[k]);
        for (int m = 0; m < 3; ++m)
          ghosts.shift_cart.push_back(double(key[1]) * s.cell[m] + double(key[2]) * s.cell[3 + m] +
                                      double(key[3]) * s.cell[6 + m]);
      }
      newj[k] = it->second;
    }
  }
  // stable sort by center; the padding after it carries the sentinel
  std::vector<int64_t> order(ne);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) { return oi[a] < oi[b]; });
  EdgeSet es;
  es.n_real = ne;
  es.eidx.assign(2 * n_edges_pad, int32_t(sentinel));
  es.edge_mask.assign(n_edges_pad, 0);
  for (int64_t k = 0; k < ne; ++k) {
    es.eidx[k] = oi[order[k]];
    es.eidx[n_edges_pad + k] = newj[order[k]];
    es.edge_mask[k] = 1;
  }
  return es;
}

void fill_rows(const System& s, const GhostSet& ghosts, std::vector<double>& rows) {
  std::copy(s.pos.begin(), s.pos.end(), rows.begin());
  for (size_t g = 0; g < ghosts.owner.size(); ++g)
    for (int m = 0; m < 3; ++m)
      rows[3 * (s.n + g) + m] = s.pos[3 * ghosts.owner[g] + m] + ghosts.shift_cart[3 * g + m];
}

void collapse_ghost_forces(const System& s, const GhostSet& ghosts,
                           const std::vector<double>& row_forces, std::vector<double>& f_out) {
  std::copy(row_forces.begin(), row_forces.begin() + 3 * s.n, f_out.begin());
  for (size_t g = 0; g < ghosts.owner.size(); ++g)
    for (int m = 0; m < 3; ++m) f_out[3 * ghosts.owner[g] + m] += row_forces[3 * (s.n + g) + m];
}

void verlet_positions(System& s, const std::vector<double>& force, double dt) {
  for (int64_t i = 0; i < s.n; ++i)
    for (int k = 0; k < 3; ++k)
      s.pos[3 * i + k] += dt * s.vel[3 * i + k] + 0.5 * dt * dt / s.mass[i] * force[3 * i + k];
}

void verlet_velocities(System& s, const std::vector<double>& f_old,
                       const std::vector<double>& f_new, double dt) {
  for (int64_t i = 0; i < s.n; ++i)
    for (int k = 0; k < 3; ++k)
      s.vel[3 * i + k] += 0.5 * dt / s.mass[i] * (f_old[3 * i + k] + f_new[3 * i + k]);
}

double kinetic_energy(const System& s) {
  double ke = 0;
  for (int64_t i = 0; i < s.n; ++i)
    for (int k = 0; k < 3; ++k) ke += 0.5 * s.mass[i] * s.vel[3 * i + k] * s.vel[3 * i + k];
  return ke;
}

// ---------------------------------------------------------------------------
// --selftest
// ---------------------------------------------------------------------------

namespace {

void expect(bool ok, const std::string& what) {
  if (!ok) die("selftest: " + what);
}

void selftest_files() {
  std::vector<double> x = {1.0, 2.0, 3.0, 4.0, 5.0, 6.0};
  std::vector<int32_t> t = {3, -1, 7};
  const char* tmp = std::getenv("TMPDIR");
  std::string path = std::string(tmp && *tmp ? tmp : ".") + "/allegro_md_selftest.npy";
  write_npy(path, x.data(), {2, 3}, "<f8");
  auto back = parse_npy(read_file(path));
  std::remove(path.c_str());
  expect(back.shape == std::vector<int64_t>({2, 3}) && back.descr == "<f8", "npy header");
  expect(std::memcmp(back.data.data(), x.data(), sizeof(double) * 6) == 0, "npy data");
  auto npz = parse_npz(write_zip({{"x.npy", npy_bytes(x.data(), {6}, "<f8")},
                                  {"t.npy", npy_bytes(t.data(), {3}, "<i4")}}));
  expect(npz.size() == 2 && npz.at("t").shape == std::vector<int64_t>({3}), "zip entries");
  expect(std::memcmp(npz.at("t").data.data(), t.data(), sizeof(int32_t) * 3) == 0, "zip data");
}

void selftest_list() {
  // 3 atoms on a line, the cutoff reaching the nearest neighbor only: 4
  // directed edges, center-sorted, the rest sentinel padding
  System s;
  s.n = 3;
  s.pos = {0, 0, 0, 1, 0, 0, 2.5, 0, 0};
  GhostSet ghosts;
  EdgeSet es = build_edges(s, 1.8, 8, 5, ghosts);
  expect(es.n_real == 4 && ghosts.owner.empty(), "expected 4 edges and no ghost");
  for (int64_t k = 0; k < 8; ++k) {
    bool real = k < 4;
    expect(es.edge_mask[k] == (real ? 1 : 0), "edge mask");
    if (!real) expect(es.eidx[k] == 5 && es.eidx[8 + k] == 5, "sentinel padding");
    if (k > 0 && real) expect(es.eidx[k] >= es.eidx[k - 1], "centers sorted");
  }
}

void selftest_ghosts() {
  // a periodic box whose images are within the cutoff: every edge through a
  // ghost row has its minimum-image length, also after the atoms move
  System s;
  s.n = 3;
  s.pos = {0.2, 0.2, 0.2, 1.6, 0.3, 0.25, 2.7, 2.8, 0.1};
  const double L = 3.0;
  s.cell[0] = s.cell[4] = s.cell[8] = L;
  s.pbc[0] = s.pbc[1] = s.pbc[2] = 1;
  s.periodic = true;
  GhostSet ghosts;
  EdgeSet es = build_edges(s, 1.4, 256, 0, ghosts);
  expect(!ghosts.owner.empty(), "expected ghost rows");
  for (int64_t i = 0; i < 3 * s.n; ++i) s.pos[i] += 0.01 * double((i * 7) % 5 - 2);
  std::vector<double> rows(3 * (s.n + ghosts.owner.size()));
  fill_rows(s, ghosts, rows);
  for (int64_t k = 0; k < es.n_real; ++k) {
    int64_t i = es.eidx[k], j = es.eidx[256 + k];
    int64_t oj = j < s.n ? j : ghosts.owner[j - s.n];
    double r_rows = 0, r_image = 0;
    for (int m = 0; m < 3; ++m) {
      double d = rows[3 * j + m] - rows[3 * i + m];
      double di = s.pos[3 * oj + m] - s.pos[3 * i + m];
      di -= L * std::nearbyint(di / L);
      r_rows += d * d;
      r_image += di * di;
    }
    expect(std::fabs(std::sqrt(r_rows) - std::sqrt(r_image)) < 1e-12, "ghost refresh");
  }
  std::vector<double> row_f(rows.size(), 1.0), f(3 * s.n);
  collapse_ghost_forces(s, ghosts, row_f, f);
  double total = 0;
  for (double v : f) total += v;
  expect(std::fabs(total - double(rows.size())) < 1e-12, "ghost force collapse");
}

void selftest_nve() {
  // a harmonic dimer: the energy is conserved to O(dt^2)
  System s;
  s.n = 2;
  s.pos = {-0.6, 0, 0, 0.6, 0, 0};
  s.vel = {0.1, 0.02, 0, -0.1, -0.02, 0};
  s.mass = {1.0, 2.0};
  const double k = 4.0, r0 = 1.0, dt = 1e-3;
  auto forces = [&](std::vector<double>& f, double& e) {
    double d[3], r = 0;
    for (int m = 0; m < 3; ++m) {
      d[m] = s.pos[3 + m] - s.pos[m];
      r += d[m] * d[m];
    }
    r = std::sqrt(r);
    e = 0.5 * k * (r - r0) * (r - r0);
    for (int m = 0; m < 3; ++m) {
      double fm = -k * (r - r0) * d[m] / r;
      f[3 + m] = fm;
      f[m] = -fm;
    }
  };
  std::vector<double> f(6), fn(6);
  double e;
  forces(f, e);
  double e0 = e + kinetic_energy(s);
  for (int step = 0; step < 20000; ++step) {
    verlet_positions(s, f, dt);
    forces(fn, e);
    verlet_velocities(s, f, fn, dt);
    std::swap(f, fn);
  }
  double e1 = e + kinetic_energy(s);
  expect(std::fabs(e1 - e0) < 1e-6 * std::max(1.0, std::fabs(e0)),
         "NVE drift " + std::to_string(e1 - e0));
}

}  // namespace

int selftest() {
  selftest_files();
  selftest_list();
  selftest_ghosts();
  selftest_nve();
  std::printf("selftest OK\n");
  return 0;
}

}  // namespace atpt_md

#ifdef ATPT_MD_CORE_MAIN
int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "--selftest") return atpt_md::selftest();
  atpt_md::die("this build is the torch-free core: it runs --selftest only "
               "(native/md_driver.py builds the driver)");
}
#endif
