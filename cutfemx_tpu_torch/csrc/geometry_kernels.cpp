// Native host-side geometry kernels for cutfemx_tpu.
//
// TPU-native re-design of the reference's C++ runtime components that are
// host-side preprocessing rather than device compute:
//  - robust orientation predicates (the role of
//    reference/cpp/cutfemx/distance/stl/mp_predicates.h:30-128, using
//    a static floating-point filter + compensated double-double fallback
//    instead of the geogram MultiPrecision PSM)
//  - batch binary-STL triangle parsing (stl/reader.h:18-160)
//  - batch separating-axis triangle/cell overlap (the narrow phase of
//    stl/cell_triangle_map.h)
//
// Exposed with a plain C ABI for ctypes; arrays are dense float64/int64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// -- compensated arithmetic (double-double) ---------------------------------

struct dd { double hi, lo; };

static inline dd two_sum(double a, double b)
{
  double s = a + b;
  double bb = s - a;
  double err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

static inline dd two_prod(double a, double b)
{
  double p = a * b;
  double err = std::fma(a, b, -p);
  return {p, err};
}

static inline dd dd_add(dd a, dd b)
{
  dd s = two_sum(a.hi, b.hi);
  double lo = s.lo + a.lo + b.lo;
  dd r = two_sum(s.hi, lo);
  return r;
}

static inline dd dd_neg(dd a) { return {-a.hi, -a.lo}; }

static inline dd dd_mul(dd a, dd b)
{
  dd p = two_prod(a.hi, b.hi);
  p.lo += a.hi * b.lo + a.lo * b.hi;
  dd r = two_sum(p.hi, p.lo);
  return r;
}

static inline dd dd_sub(dd a, dd b) { return dd_add(a, dd_neg(b)); }

static inline dd dd_from(double a) { return {a, 0.0}; }

// -- orientation predicates --------------------------------------------------

// orient2d(a, b, c): sign of det[b-a; c-a]; exact-filtered.
double cutfemx_orient2d(const double* a, const double* b, const double* c)
{
  double detleft = (a[0] - c[0]) * (b[1] - c[1]);
  double detright = (a[1] - c[1]) * (b[0] - c[0]);
  double det = detleft - detright;
  double detsum = std::fabs(detleft) + std::fabs(detright);
  // Shewchuk-style static filter
  const double errbound = 3.3306690738754716e-16 * detsum;
  if (det > errbound || -det > errbound)
    return det;
  // double-double fallback
  dd ax = dd_sub(dd_from(a[0]), dd_from(c[0]));
  dd ay = dd_sub(dd_from(a[1]), dd_from(c[1]));
  dd bx = dd_sub(dd_from(b[0]), dd_from(c[0]));
  dd by = dd_sub(dd_from(b[1]), dd_from(c[1]));
  dd d = dd_sub(dd_mul(ax, by), dd_mul(ay, bx));
  return d.hi + d.lo;
}

// orient3d(a, b, c, d): sign of det[a-d; b-d; c-d] (positive when d is
// below the plane abc with counterclockwise orientation).
double cutfemx_orient3d(const double* a, const double* b, const double* c,
                        const double* d)
{
  double adx = a[0] - d[0], ady = a[1] - d[1], adz = a[2] - d[2];
  double bdx = b[0] - d[0], bdy = b[1] - d[1], bdz = b[2] - d[2];
  double cdx = c[0] - d[0], cdy = c[1] - d[1], cdz = c[2] - d[2];

  double bdxcdy = bdx * cdy, cdxbdy = cdx * bdy;
  double cdxady = cdx * ady, adxcdy = adx * cdy;
  double adxbdy = adx * bdy, bdxady = bdx * ady;

  double det = adz * (bdxcdy - cdxbdy) + bdz * (cdxady - adxcdy)
               + cdz * (adxbdy - bdxady);
  double permanent = (std::fabs(bdxcdy) + std::fabs(cdxbdy)) * std::fabs(adz)
                   + (std::fabs(cdxady) + std::fabs(adxcdy)) * std::fabs(bdz)
                   + (std::fabs(adxbdy) + std::fabs(bdxady)) * std::fabs(cdz);
  const double errbound = 7.7715611723760958e-16 * permanent;
  if (det > errbound || -det > errbound)
    return det;

  // double-double fallback
  dd ax = dd_sub(dd_from(a[0]), dd_from(d[0]));
  dd ay = dd_sub(dd_from(a[1]), dd_from(d[1]));
  dd az = dd_sub(dd_from(a[2]), dd_from(d[2]));
  dd bx = dd_sub(dd_from(b[0]), dd_from(d[0]));
  dd by = dd_sub(dd_from(b[1]), dd_from(d[1]));
  dd bz = dd_sub(dd_from(b[2]), dd_from(d[2]));
  dd cx = dd_sub(dd_from(c[0]), dd_from(d[0]));
  dd cy = dd_sub(dd_from(c[1]), dd_from(d[1]));
  dd cz = dd_sub(dd_from(c[2]), dd_from(d[2]));

  dd m1 = dd_sub(dd_mul(bx, cy), dd_mul(cx, by));
  dd m2 = dd_sub(dd_mul(cx, ay), dd_mul(ax, cy));
  dd m3 = dd_sub(dd_mul(ax, by), dd_mul(bx, ay));
  dd r = dd_add(dd_add(dd_mul(az, m1), dd_mul(bz, m2)), dd_mul(cz, m3));
  return r.hi + r.lo;
}

void cutfemx_orient3d_batch(const double* pa, const double* pb,
                            const double* pc, const double* pd,
                            int64_t n, double* out)
{
  for (int64_t i = 0; i < n; ++i)
    out[i] = cutfemx_orient3d(pa + 3 * i, pb + 3 * i, pc + 3 * i,
                              pd + 3 * i);
}

// -- binary STL parsing ------------------------------------------------------

// data: raw 50-byte records (normal[3] float32, verts[9] float32, attr u16)
// out_normals: (n, 3) f64; out_verts: (n, 3, 3) f64
void cutfemx_parse_stl_records(const uint8_t* data, int64_t n,
                               double* out_normals, double* out_verts)
{
  for (int64_t i = 0; i < n; ++i)
  {
    const uint8_t* rec = data + 50 * i;
    float f[12];
    std::memcpy(f, rec, 48);
    for (int k = 0; k < 3; ++k)
      out_normals[3 * i + k] = static_cast<double>(f[k]);
    for (int k = 0; k < 9; ++k)
      out_verts[9 * i + k] = static_cast<double>(f[3 + k]);
  }
}

// -- separating-axis triangle / convex-cell overlap --------------------------

static inline void cross3(const double* u, const double* v, double* w)
{
  w[0] = u[1] * v[2] - u[2] * v[1];
  w[1] = u[2] * v[0] - u[0] * v[2];
  w[2] = u[0] * v[1] - u[1] * v[0];
}

static inline bool axis_separates(const double* axis, const double* cell,
                                  int nv, const double* tri)
{
  double cmin = 1e300, cmax = -1e300;
  for (int v = 0; v < nv; ++v)
  {
    double p = axis[0] * cell[3 * v] + axis[1] * cell[3 * v + 1]
             + axis[2] * cell[3 * v + 2];
    cmin = p < cmin ? p : cmin;
    cmax = p > cmax ? p : cmax;
  }
  double tmin = 1e300, tmax = -1e300;
  for (int v = 0; v < 3; ++v)
  {
    double p = axis[0] * tri[3 * v] + axis[1] * tri[3 * v + 1]
             + axis[2] * tri[3 * v + 2];
    tmin = p < tmin ? p : tmin;
    tmax = p > tmax ? p : tmax;
  }
  const double eps = 1e-14;
  return (cmax < tmin - eps) || (tmax < cmin - eps);
}

// cells: (m, nv, 3); tris: (m, 3, 3); out: (m,) uint8 overlap flags
void cutfemx_tri_cell_overlap(const double* cells, const double* tris,
                              int64_t m, int nv, uint8_t* out)
{
  for (int64_t i = 0; i < m; ++i)
  {
    const double* cell = cells + 3 * nv * i;
    const double* tri = tris + 9 * i;
    double e1[3], e2[3], e3[3], axis[3];
    for (int k = 0; k < 3; ++k)
    {
      e1[k] = tri[3 + k] - tri[k];
      e2[k] = tri[6 + k] - tri[k];
      e3[k] = tri[6 + k] - tri[3 + k];
    }
    bool sep = false;
    cross3(e1, e2, axis);
    sep = axis_separates(axis, cell, nv, tri);
    for (int k = 0; k < 3 && !sep; ++k)
    {
      double unit[3] = {0, 0, 0};
      unit[k] = 1.0;
      sep = axis_separates(unit, cell, nv, tri);
    }
    const double* edges[3] = {e1, e2, e3};
    for (int e = 0; e < 3 && !sep; ++e)
    {
      for (int k = 0; k < 3 && !sep; ++k)
      {
        double unit[3] = {0, 0, 0};
        unit[k] = 1.0;
        cross3(edges[e], unit, axis);
        double norm2 = axis[0] * axis[0] + axis[1] * axis[1]
                     + axis[2] * axis[2];
        if (norm2 > 1e-28)
          sep = axis_separates(axis, cell, nv, tri);
      }
    }
    out[i] = sep ? 0 : 1;
  }
}

// -- exact segment-triangle / triangle-triangle intersection ------------------
//
// Predicate-only tests with the exact-filtered orientation predicates above
// (the role of reference/cpp/cutfemx/distance/stl/tri_intersection.h:
// 132-186). Closed semantics: touching counts as intersecting — matching the
// "block the flood fill" use in the ComponentAnchor sign mode.

static inline int sgn(double v) { return (v > 0.0) - (v < 0.0); }

static int dominant_axis(const double* a, const double* b, const double* c)
{
  double u[3], v[3], n[3];
  for (int k = 0; k < 3; ++k)
  {
    u[k] = b[k] - a[k];
    v[k] = c[k] - a[k];
  }
  cross3(u, v, n);
  double ax = std::fabs(n[0]), ay = std::fabs(n[1]), az = std::fabs(n[2]);
  if (ax >= ay && ax >= az) return 0;
  if (ay >= az) return 1;
  return 2;
}

static inline void proj2(const double* p, int drop, double* out)
{
  int i = 0;
  for (int k = 0; k < 3; ++k)
    if (k != drop) out[i++] = p[k];
}

static bool pt_in_tri2(const double* p, const double* a, const double* b,
                       const double* c)
{
  int s1 = sgn(cutfemx_orient2d(a, b, p));
  int s2 = sgn(cutfemx_orient2d(b, c, p));
  int s3 = sgn(cutfemx_orient2d(c, a, p));
  return (s1 >= 0 && s2 >= 0 && s3 >= 0)
      || (s1 <= 0 && s2 <= 0 && s3 <= 0);
}

static bool on_seg2(const double* a, const double* b, const double* x,
                    int orient)
{
  if (orient != 0) return false;
  return std::min(a[0], b[0]) <= x[0] && x[0] <= std::max(a[0], b[0])
      && std::min(a[1], b[1]) <= x[1] && x[1] <= std::max(a[1], b[1]);
}

static bool seg_seg2(const double* p, const double* q, const double* r,
                     const double* s)
{
  int o1 = sgn(cutfemx_orient2d(p, q, r));
  int o2 = sgn(cutfemx_orient2d(p, q, s));
  int o3 = sgn(cutfemx_orient2d(r, s, p));
  int o4 = sgn(cutfemx_orient2d(r, s, q));
  if (o1 * o2 < 0 && o3 * o4 < 0) return true;
  return on_seg2(p, q, r, o1) || on_seg2(p, q, s, o2)
      || on_seg2(r, s, p, o3) || on_seg2(r, s, q, o4);
}

static bool seg_tri_coplanar(const double* p, const double* q,
                             const double* a, const double* b,
                             const double* c)
{
  int drop = dominant_axis(a, b, c);
  double P[2], Q[2], A[2], B[2], C[2];
  proj2(p, drop, P);
  proj2(q, drop, Q);
  proj2(a, drop, A);
  proj2(b, drop, B);
  proj2(c, drop, C);
  if (pt_in_tri2(P, A, B, C) || pt_in_tri2(Q, A, B, C)) return true;
  return seg_seg2(P, Q, A, B) || seg_seg2(P, Q, B, C)
      || seg_seg2(P, Q, C, A);
}

// closed segment pq vs closed triangle abc
int cutfemx_seg_tri_isect(const double* p, const double* q, const double* a,
                          const double* b, const double* c)
{
  int sp = sgn(cutfemx_orient3d(a, b, c, p));
  int sq = sgn(cutfemx_orient3d(a, b, c, q));
  if ((sp > 0 && sq > 0) || (sp < 0 && sq < 0)) return 0;
  if (sp == 0 && sq == 0) return seg_tri_coplanar(p, q, a, b, c) ? 1 : 0;
  int s1 = sgn(cutfemx_orient3d(p, q, a, b));
  int s2 = sgn(cutfemx_orient3d(p, q, b, c));
  int s3 = sgn(cutfemx_orient3d(p, q, c, a));
  return ((s1 >= 0 && s2 >= 0 && s3 >= 0)
          || (s1 <= 0 && s2 <= 0 && s3 <= 0)) ? 1 : 0;
}

static bool tri_tri_coplanar(const double* t1, const double* t2)
{
  int drop = dominant_axis(t2, t2 + 3, t2 + 6);
  double A[3][2], B[3][2];
  for (int i = 0; i < 3; ++i)
  {
    proj2(t1 + 3 * i, drop, A[i]);
    proj2(t2 + 3 * i, drop, B[i]);
  }
  for (int i = 0; i < 3; ++i)
    if (pt_in_tri2(A[i], B[0], B[1], B[2])
        || pt_in_tri2(B[i], A[0], A[1], A[2]))
      return true;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      if (seg_seg2(A[i], A[(i + 1) % 3], B[j], B[(j + 1) % 3]))
        return true;
  return false;
}

// closed triangle t1 (9 doubles) vs closed triangle t2
int cutfemx_tri_tri_isect(const double* t1, const double* t2)
{
  int s[3], r[3];
  for (int i = 0; i < 3; ++i)
    s[i] = sgn(cutfemx_orient3d(t2, t2 + 3, t2 + 6, t1 + 3 * i));
  if ((s[0] > 0 && s[1] > 0 && s[2] > 0)
      || (s[0] < 0 && s[1] < 0 && s[2] < 0))
    return 0;
  for (int i = 0; i < 3; ++i)
    r[i] = sgn(cutfemx_orient3d(t1, t1 + 3, t1 + 6, t2 + 3 * i));
  if ((r[0] > 0 && r[1] > 0 && r[2] > 0)
      || (r[0] < 0 && r[1] < 0 && r[2] < 0))
    return 0;
  if (s[0] == 0 && s[1] == 0 && s[2] == 0)
    return tri_tri_coplanar(t1, t2) ? 1 : 0;
  // non-coplanar: some edge of one triangle must cross the other
  for (int i = 0; i < 3; ++i)
  {
    if (cutfemx_seg_tri_isect(t1 + 3 * i, t1 + 3 * ((i + 1) % 3),
                              t2, t2 + 3, t2 + 6))
      return 1;
    if (cutfemx_seg_tri_isect(t2 + 3 * i, t2 + 3 * ((i + 1) % 3),
                              t1, t1 + 3, t1 + 6))
      return 1;
  }
  return 0;
}

void cutfemx_seg_tri_isect_batch(const double* segs, const double* tris,
                                 int64_t n, uint8_t* out)
{
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)cutfemx_seg_tri_isect(
        segs + 6 * i, segs + 6 * i + 3, tris + 9 * i, tris + 9 * i + 3,
        tris + 9 * i + 6);
}

void cutfemx_tri_tri_isect_batch(const double* t1, const double* t2,
                                 int64_t n, uint8_t* out)
{
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)cutfemx_tri_tri_isect(t1 + 9 * i, t2 + 9 * i);
}

}  // extern "C"
