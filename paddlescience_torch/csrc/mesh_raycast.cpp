// Host ray cast and exact point-triangle distance for triangle meshes
// (paddlescience_torch/geometry/mesh.py), C++ with one std::thread per
// core over the points.
//
// The same arithmetic as the numpy version of Mesh._ray_hits and
// Mesh._unsigned_distance, per point over every triangle, with no
// temporaries: the inside test then keeps exactly the points numpy keeps.
// Built at first use by paddlescience_torch/geometry/raycast.py
// (g++ -O3 -pthread -ffp-contract=off -shared -fPIC; no -march, so the
// library runs on any host of the architecture; no OpenMP, which not every
// toolchain ships) and loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// body(p) for p in [0, P), the points split evenly over the cores.
template <typename Body>
void parallel_points(int64_t P, Body body) {
  const int64_t cores = std::max(1u, std::thread::hardware_concurrency());
  const int64_t n = std::max<int64_t>(1, std::min<int64_t>(cores, P / 64));
  const int64_t chunk = (P + n - 1) / n;
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < n; ++t)
    pool.emplace_back([=] {
      for (int64_t p = t * chunk; p < std::min(P, (t + 1) * chunk); ++p) body(p);
    });
  for (int64_t p = 0; p < std::min(P, chunk); ++p) body(p);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Ray-triangle hits along +z in a frame rotated so the ray is +z.
// tri: (F, 9) = [ax, ay, az, bx, by, bz, cx, cy, cz]; pts: (P, 3);
// out: (P,) hit counts.
void psci_ray_hits_z(const double* tri, int64_t F, const double* pts, int64_t P, int64_t* out) {
  parallel_points(P, [=](int64_t p) {
    const double px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
    int64_t count = 0;
    for (int64_t f = 0; f < F; ++f) {
      const double* t = tri + 9 * f;
      const double ax = t[0], ay = t[1], az = t[2];
      const double bx = t[3], by = t[4], bz = t[5];
      const double cx = t[6], cy = t[7], cz = t[8];
      const double denom = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
      if (!(std::fabs(denom) > 1e-12)) continue;
      const double inv = 1.0 / denom;
      const double w1 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) * inv;
      const double w2 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) * inv;
      const double w3 = 1.0 - w1 - w2;
      if (w1 >= -1e-9 && w2 >= -1e-9 && w3 >= -1e-9 && w1 * az + w2 * bz + w3 * cz > pz + 1e-9) ++count;
    }
    out[p] = count;
  });
}

// Exact min point-triangle distance by the clamped projection of the
// numpy version: (s, t) = the unconstrained minimiser of |v0 + s e1 +
// t e2 - p|^2, each clamped to [0, 1] and rescaled onto s + t <= 1.
// tri as above; out: (P,) unsigned distances.
void psci_unsigned_distance(const double* tri, int64_t F, const double* pts, int64_t P, double* out) {
  parallel_points(P, [=](int64_t p) {
    const double px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
    double best = 1e300;
    for (int64_t f = 0; f < F; ++f) {
      const double* t = tri + 9 * f;
      const double v0x = t[0], v0y = t[1], v0z = t[2];
      const double e1x = t[3] - v0x, e1y = t[4] - v0y, e1z = t[5] - v0z;
      const double e2x = t[6] - v0x, e2y = t[7] - v0y, e2z = t[8] - v0z;
      const double a = e1x * e1x + e1y * e1y + e1z * e1z;
      const double b = e1x * e2x + e1y * e2y + e1z * e2z;
      const double c = e2x * e2x + e2y * e2y + e2z * e2z;
      double det = a * c - b * b;
      if (det <= 0) det = 1e-30;
      const double dx = v0x - px, dy = v0y - py, dz = v0z - pz;
      const double d = dx * e1x + dy * e1y + dz * e1z;
      const double e = dx * e2x + dy * e2y + dz * e2z;
      double s = (b * e - c * d) / det;
      double tt = (b * d - a * e) / det;
      s = s < 0 ? 0 : (s > 1 ? 1 : s);
      tt = tt < 0 ? 0 : (tt > 1 ? 1 : tt);
      const double sum = s + tt;
      if (sum > 1) {
        s /= sum;
        tt /= sum;
      }
      const double dist2 = dx * dx + dy * dy + dz * dz + 2 * s * d + 2 * tt * e + s * s * a + 2 * s * tt * b +
                           tt * tt * c;
      if (dist2 < best) best = dist2;
    }
    out[p] = best > 0 ? std::sqrt(best) : 0.0;
  });
}

}  // extern "C"
