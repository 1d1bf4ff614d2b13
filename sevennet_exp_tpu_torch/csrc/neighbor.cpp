// Native neighbor list for the host graph build (copy of the JAX package's
// runtime/neighbor.cpp, the port's own).
//
// Plays the role of the reference's host-side graph construction
// (pair_e3gnn.cpp:157-195 neighbor scan; train/dataload.py matscipy
// usage): builds the full directed edge list with periodic images using a
// binned cell list over the replicated domain. Exposed as a C ABI for
// ctypes. Edges come grouped by center in ascending order; within a center
// they follow the cell bins, not the neighbor index.
//
// Built at first use by sevennet_exp_tpu_torch/data/native.py:
//   g++ -O3 -shared -fPIC neighbor.cpp -o _build/libsevenn_neighbor_<hash>.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 matvec(const double* c, double a, double b, double d) {
  // row-major cell, rows are lattice vectors: r = a*c0 + b*c1 + d*c2
  return {a * c[0] + b * c[3] + d * c[6],
          a * c[1] + b * c[4] + d * c[7],
          a * c[2] + b * c[5] + d * c[8]};
}

inline double det3(const double* c) {
  return c[0] * (c[4] * c[8] - c[5] * c[7]) -
         c[1] * (c[3] * c[8] - c[5] * c[6]) +
         c[2] * (c[3] * c[7] - c[4] * c[6]);
}

inline void inv3(const double* c, double* inv) {
  double d = det3(c);
  inv[0] = (c[4] * c[8] - c[5] * c[7]) / d;
  inv[1] = (c[2] * c[7] - c[1] * c[8]) / d;
  inv[2] = (c[1] * c[5] - c[2] * c[4]) / d;
  inv[3] = (c[5] * c[6] - c[3] * c[8]) / d;
  inv[4] = (c[0] * c[8] - c[2] * c[6]) / d;
  inv[5] = (c[2] * c[3] - c[0] * c[5]) / d;
  inv[6] = (c[3] * c[7] - c[4] * c[6]) / d;
  inv[7] = (c[1] * c[6] - c[0] * c[7]) / d;
  inv[8] = (c[0] * c[4] - c[1] * c[3]) / d;
}

}  // namespace

extern "C" {

// Returns the number of edges, or -(needed) if max_edges is too small.
// out_i/out_j: edge endpoints (i = center). out_vec: pos[j]+S@cell-pos[i].
// out_shift: integer image shifts S (3 per edge).
int64_t sevenn_neighbor_list(const double* pos, int64_t n,
                             const double* cell, const uint8_t* pbc,
                             double cutoff, int64_t max_edges,
                             int32_t* out_i, int32_t* out_j,
                             double* out_vec, int32_t* out_shift) {
  if (n == 0) return 0;
  const double cut2 = cutoff * cutoff;

  // how many images per periodic axis
  int reps[3] = {0, 0, 0};
  double vol = std::fabs(det3(cell));
  bool any_pbc = pbc[0] || pbc[1] || pbc[2];
  double inv[9] = {0};
  if (any_pbc) {
    inv3(cell, inv);
    for (int ax = 0; ax < 3; ++ax) {
      if (!pbc[ax]) continue;
      int j = (ax + 1) % 3, k = (ax + 2) % 3;
      // plane distance = vol / |c_j x c_k|
      V3 cj = {cell[3 * j], cell[3 * j + 1], cell[3 * j + 2]};
      V3 ck = {cell[3 * k], cell[3 * k + 1], cell[3 * k + 2]};
      V3 cr = {cj.y * ck.z - cj.z * ck.y, cj.z * ck.x - cj.x * ck.z,
               cj.x * ck.y - cj.y * ck.x};
      double area = std::sqrt(cr.x * cr.x + cr.y * cr.y + cr.z * cr.z);
      double d = vol / area;
      reps[ax] = (int)std::ceil(cutoff / d);
    }
  }

  // wrap home positions into the cell along periodic axes
  std::vector<double> base(3 * n);        // wrapped cartesian
  std::vector<int32_t> bshift(3 * n, 0);  // applied integer shift
  for (int64_t a = 0; a < n; ++a) {
    double fx = 0, fy = 0, fz = 0;
    if (any_pbc) {
      const double* p = pos + 3 * a;
      fx = p[0] * inv[0] + p[1] * inv[3] + p[2] * inv[6];
      fy = p[0] * inv[1] + p[1] * inv[4] + p[2] * inv[7];
      fz = p[0] * inv[2] + p[1] * inv[5] + p[2] * inv[8];
    }
    double wx = pbc[0] ? std::floor(fx) : 0.0;
    double wy = pbc[1] ? std::floor(fy) : 0.0;
    double wz = pbc[2] ? std::floor(fz) : 0.0;
    bshift[3 * a] = (int32_t)(-wx);
    bshift[3 * a + 1] = (int32_t)(-wy);
    bshift[3 * a + 2] = (int32_t)(-wz);
    V3 off = matvec(cell, -wx, -wy, -wz);
    base[3 * a] = pos[3 * a] + off.x;
    base[3 * a + 1] = pos[3 * a + 1] + off.y;
    base[3 * a + 2] = pos[3 * a + 2] + off.z;
  }

  // replicate images
  struct Image {
    double x, y, z;
    int32_t atom;
    int32_t sx, sy, sz;
  };
  std::vector<Image> images;
  int64_t n_images_per_atom = (int64_t)(2 * reps[0] + 1) *
                              (2 * reps[1] + 1) * (2 * reps[2] + 1);
  images.reserve(n * n_images_per_atom);
  double minx = 1e300, miny = 1e300, minz = 1e300;
  double maxx = -1e300, maxy = -1e300, maxz = -1e300;
  for (int sx = -reps[0]; sx <= reps[0]; ++sx)
    for (int sy = -reps[1]; sy <= reps[1]; ++sy)
      for (int sz = -reps[2]; sz <= reps[2]; ++sz) {
        V3 off = matvec(cell, sx, sy, sz);
        for (int64_t a = 0; a < n; ++a) {
          Image im{base[3 * a] + off.x, base[3 * a + 1] + off.y,
                   base[3 * a + 2] + off.z, (int32_t)a, sx, sy, sz};
          images.push_back(im);
          minx = std::min(minx, im.x);
          miny = std::min(miny, im.y);
          minz = std::min(minz, im.z);
          maxx = std::max(maxx, im.x);
          maxy = std::max(maxy, im.y);
          maxz = std::max(maxz, im.z);
        }
      }

  // bin images into a grid of cell width >= cutoff
  double eps = 1e-9;
  int nbx = std::max(1, (int)((maxx - minx) / cutoff));
  int nby = std::max(1, (int)((maxy - miny) / cutoff));
  int nbz = std::max(1, (int)((maxz - minz) / cutoff));
  double wx = (maxx - minx + eps) / nbx;
  double wy = (maxy - miny + eps) / nby;
  double wz = (maxz - minz + eps) / nbz;
  int64_t nbins = (int64_t)nbx * nby * nbz;
  std::vector<int32_t> bin_count(nbins, 0);
  std::vector<int64_t> bin_of(images.size());
  for (size_t t = 0; t < images.size(); ++t) {
    int bx = (int)((images[t].x - minx) / wx);
    int by = (int)((images[t].y - miny) / wy);
    int bz = (int)((images[t].z - minz) / wz);
    bx = std::min(std::max(bx, 0), nbx - 1);
    by = std::min(std::max(by, 0), nby - 1);
    bz = std::min(std::max(bz, 0), nbz - 1);
    int64_t b = ((int64_t)bx * nby + by) * nbz + bz;
    bin_of[t] = b;
    bin_count[b]++;
  }
  std::vector<int64_t> bin_start(nbins + 1, 0);
  for (int64_t b = 0; b < nbins; ++b)
    bin_start[b + 1] = bin_start[b] + bin_count[b];
  std::vector<int32_t> bin_items(images.size());
  std::vector<int64_t> cursor(bin_start.begin(), bin_start.end() - 1);
  for (size_t t = 0; t < images.size(); ++t)
    bin_items[cursor[bin_of[t]]++] = (int32_t)t;

  int64_t cnt = 0;
  int64_t needed = 0;
  for (int64_t i = 0; i < n; ++i) {
    double xi = base[3 * i], yi = base[3 * i + 1], zi = base[3 * i + 2];
    int bx = (int)((xi - minx) / wx);
    int by = (int)((yi - miny) / wy);
    int bz = (int)((zi - minz) / wz);
    for (int dx = -1; dx <= 1; ++dx) {
      int cx = bx + dx;
      if (cx < 0 || cx >= nbx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        int cy = by + dy;
        if (cy < 0 || cy >= nby) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          int cz = bz + dz;
          if (cz < 0 || cz >= nbz) continue;
          int64_t b = ((int64_t)cx * nby + cy) * nbz + cz;
          for (int64_t t = bin_start[b]; t < bin_start[b + 1]; ++t) {
            const Image& im = images[bin_items[t]];
            double ddx = im.x - xi, ddy = im.y - yi, ddz = im.z - zi;
            double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 >= cut2) continue;
            bool self = (im.atom == (int32_t)i) && im.sx == 0 &&
                        im.sy == 0 && im.sz == 0;
            if (self) continue;
            ++needed;
            if (cnt < max_edges) {
              int64_t j = im.atom;
              // total shift in ORIGINAL coordinates:
              // S = s_img + wrap_j - wrap_i
              int32_t tsx = im.sx + bshift[3 * j] - bshift[3 * i];
              int32_t tsy = im.sy + bshift[3 * j + 1] - bshift[3 * i + 1];
              int32_t tsz = im.sz + bshift[3 * j + 2] - bshift[3 * i + 2];
              out_i[cnt] = (int32_t)i;
              out_j[cnt] = (int32_t)j;
              V3 sh = matvec(cell, tsx, tsy, tsz);
              out_vec[3 * cnt] = pos[3 * j] + sh.x - pos[3 * i];
              out_vec[3 * cnt + 1] = pos[3 * j + 1] + sh.y - pos[3 * i + 1];
              out_vec[3 * cnt + 2] = pos[3 * j + 2] + sh.z - pos[3 * i + 2];
              out_shift[3 * cnt] = tsx;
              out_shift[3 * cnt + 1] = tsy;
              out_shift[3 * cnt + 2] = tsz;
              ++cnt;
            }
          }
        }
      }
    }
  }
  if (needed > max_edges) return -needed;
  return cnt;
}

}  // extern "C"
