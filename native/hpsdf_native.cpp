// hpsdf_tpu native host library: .obj parsing + half-edge pairing.
//
// The reference implements its data pipeline in C++ (Meshing::ObjParser,
// Source/Meshing/ObjParser.cpp, and Mesh::CreateHalfEdges,
// Source/Meshing/Mesh.cpp:87-131). These are host-side, allocation-heavy
// tasks with no device mapping, so this framework keeps them native too: a
// small C ABI shared library bound via ctypes (hpsdf_tpu/native.py), with
// the pure-numpy implementations as behavioral oracles and fallback.
//
// Semantics intentionally mirror hpsdf_tpu/mesh/obj.py and core.py exactly
// (same fan triangulation, negative-index resolution, vertex-normal
// accumulation, watertightness checks) so the Python and native paths are
// differential-testable against each other.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

struct ObjData {
  double* verts;     // (n_verts, 3)
  double* normals;   // (n_verts, 3) unit vertex normals
  int32_t* faces;    // (n_faces, 3) 0-based
  int64_t n_verts;
  int64_t n_faces;
};

// ---------------------------------------------------------------------------
// .obj parsing (ObjParser equivalent)
// ---------------------------------------------------------------------------

namespace {

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

// Parse one face token "v", "v/vt", "v//vn", "v/vt/vn". Returns vertex index
// (1-based or negative) in *vi and normal index in *ni (0 = absent).
inline const char* parse_face_token(const char* p, long* vi, long* ni) {
  char* end;
  *vi = std::strtol(p, &end, 10);
  *ni = 0;
  p = end;
  if (*p == '/') {
    ++p;
    if (*p != '/') std::strtol(p, &end, 10), p = end;  // vt (ignored)
    if (*p == '/') {
      ++p;
      *ni = std::strtol(p, &end, 10);
      p = end;
    }
  }
  return p;
}

}  // namespace

// Returns 0 on success, 1 on file-open failure, 2 on malformed data.
int hpsdf_parse_obj(const char* path, ObjData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  std::vector<double> verts, norms;
  std::vector<int32_t> faces;
  std::vector<int64_t> face_norm_idx;  // 3 per tri when present
  verts.reserve(3 << 12);
  faces.reserve(3 << 12);

  char line[8192];
  std::vector<long> idx, nidx;
  while (std::fgets(line, sizeof line, f)) {
    const char* p = line;
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* end;
      p += 2;
      double x = std::strtod(p, &end);
      double y = std::strtod(end, &end);
      double z = std::strtod(end, &end);
      verts.push_back(x);
      verts.push_back(y);
      verts.push_back(z);
    } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
      char* end;
      p += 3;
      double x = std::strtod(p, &end);
      double y = std::strtod(end, &end);
      double z = std::strtod(end, &end);
      norms.push_back(x);
      norms.push_back(y);
      norms.push_back(z);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p = skip_ws(p + 2);
      idx.clear();
      nidx.clear();
      const long nv = (long)(verts.size() / 3);
      const long nn = (long)(norms.size() / 3);
      while (*p && *p != '\n' && *p != '\r' && *p != '#') {
        long vi, ni;
        p = parse_face_token(p, &vi, &ni);
        idx.push_back(vi > 0 ? vi - 1 : nv + vi);
        if (ni != 0) nidx.push_back(ni > 0 ? ni - 1 : nn + ni);
        p = skip_ws(p);
      }
      const bool with_n = nidx.size() == idx.size() && !nidx.empty();
      for (size_t k = 1; k + 1 < idx.size(); ++k) {  // fan triangulation
        long a = idx[0], b = idx[k], c = idx[k + 1];
        if (a < 0 || b < 0 || c < 0 || a >= nv || b >= nv || c >= nv) {
          std::fclose(f);
          return 2;
        }
        faces.push_back((int32_t)a);
        faces.push_back((int32_t)b);
        faces.push_back((int32_t)c);
        if (with_n) {
          face_norm_idx.push_back(nidx[0]);
          face_norm_idx.push_back(nidx[k]);
          face_norm_idx.push_back(nidx[k + 1]);
        }
      }
    }
  }
  std::fclose(f);

  const int64_t V = (int64_t)(verts.size() / 3);
  const int64_t F = (int64_t)(faces.size() / 3);
  double* vout = (double*)std::malloc(sizeof(double) * 3 * (size_t)V);
  double* nout = (double*)std::calloc(3 * (size_t)V, sizeof(double));
  int32_t* fout = (int32_t*)std::malloc(sizeof(int32_t) * 3 * (size_t)F);
  if ((V && (!vout || !nout)) || (F && !fout)) {
    std::free(vout); std::free(nout); std::free(fout);
    return 2;
  }
  std::memcpy(vout, verts.data(), sizeof(double) * 3 * (size_t)V);
  std::memcpy(fout, faces.data(), sizeof(int32_t) * 3 * (size_t)F);

  // Vertex normals: average the file's normals onto vertices when every
  // face corner carried one; otherwise accumulate unit face normals
  // (reference: ObjParser.cpp:141-164; mirrors mesh/obj.py).
  if (!norms.empty() && (int64_t)face_norm_idx.size() == 3 * F) {
    const int64_t nn = (int64_t)(norms.size() / 3);
    for (int64_t t = 0; t < 3 * F; ++t) {
      int64_t vtx = fout[t];
      int64_t ni = face_norm_idx[(size_t)t];
      if (ni < 0 || ni >= nn) continue;
      for (int d = 0; d < 3; ++d)
        nout[3 * vtx + d] += norms[(size_t)(3 * ni + d)];
    }
  } else {
    for (int64_t t = 0; t < F; ++t) {
      const int32_t* fc = fout + 3 * t;
      const double* a = vout + 3 * fc[0];
      const double* b = vout + 3 * fc[1];
      const double* c = vout + 3 * fc[2];
      double e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      double e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      double fn[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                      e1[2] * e2[0] - e1[0] * e2[2],
                      e1[0] * e2[1] - e1[1] * e2[0]};
      double len = std::sqrt(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
      if (len > 0)
        for (int d = 0; d < 3; ++d) fn[d] /= len;
      for (int k = 0; k < 3; ++k)
        for (int d = 0; d < 3; ++d) nout[3 * fc[k] + d] += fn[d];
    }
  }
  for (int64_t vtx = 0; vtx < V; ++vtx) {
    double* n = nout + 3 * vtx;
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 0)
      for (int d = 0; d < 3; ++d) n[d] /= len;
  }

  out->verts = vout;
  out->normals = nout;
  out->faces = fout;
  out->n_verts = V;
  out->n_faces = F;
  return 0;
}

void hpsdf_free_obj(ObjData* d) {
  std::free(d->verts);
  std::free(d->normals);
  std::free(d->faces);
  d->verts = d->normals = nullptr;
  d->faces = nullptr;
  d->n_verts = d->n_faces = 0;
}

// ---------------------------------------------------------------------------
// Half-edge pairing (Mesh::CreateHalfEdges equivalent, Mesh.cpp:87-131)
// ---------------------------------------------------------------------------

// faces: (n_faces, 3) int32; twin_out: (3 * n_faces) int32 receiving the
// paired half-edge of flat half-edge 3*f+e (edge faces[f,e]->faces[f,e+1]).
// Returns 0 ok, 1 = unpaired edge (boundary / non-manifold),
// 2 = inconsistently oriented pair (both half-edges same direction).
int hpsdf_half_edges(const int32_t* faces, int64_t n_faces, int64_t n_verts,
                     int32_t* twin_out) {
  const int64_t H = 3 * n_faces;
  std::unordered_map<uint64_t, int64_t> open;  // undirected key -> half-edge
  open.reserve((size_t)H);
  for (int64_t h = 0; h < H; ++h) {
    const int64_t f = h / 3, e = h % 3;
    const int64_t u = faces[3 * f + e];
    const int64_t w = faces[3 * f + (e + 1) % 3];
    const uint64_t lo = (uint64_t)(u < w ? u : w);
    const uint64_t hi = (uint64_t)(u < w ? w : u);
    const uint64_t key = lo * (uint64_t)n_verts + hi;
    auto it = open.find(key);
    if (it == open.end()) {
      open.emplace(key, h);
    } else {
      const int64_t g = it->second;
      const int64_t gf = g / 3, ge = g % 3;
      const int64_t gu = faces[3 * gf + ge];
      // opposite orientation required: this he runs u->w, stored runs w->u
      if (gu != w) return 2;
      twin_out[h] = (int32_t)g;
      twin_out[g] = (int32_t)h;
      open.erase(it);
    }
  }
  return open.empty() ? 0 : 1;
}

// ---------------------------------------------------------------------------
// BVH support: median-split (kd) ordering + triangle-row packing
// ---------------------------------------------------------------------------
//
// Device-side BVH traversal (hpsdf_tpu/mesh/bvh.py) wants triangles laid out so
// every power-of-two-aligned index range is a compact spatial box (a perfect
// heap over a recursive median split). The numpy path builds this order with
// one full argsort per level (O(n log^2 n) and single-threaded); here it is
// the textbook O(n log n) selection recursion: per segment, pick the axis of
// max extent and std::nth_element the midpoint. The reference's counterpart
// is the agglomerative bottom-up build (Source/Meshing/BVH.cpp:26-129),
// whose greedy pairing has no batched equivalent.

namespace {

struct KdCtx {
  const float* cent;   // (T, 3)
  int64_t T;           // real triangles; slots >= T are BIG dummies
  int32_t* idx;        // (T2,) permutation being built
};

inline float kd_coord(const KdCtx& c, int32_t i, int axis) {
  return i < c.T ? c.cent[3 * (int64_t)i + axis] : 1e30f;
}

void kd_recurse(KdCtx& c, int64_t lo, int64_t hi) {
  const int64_t n = hi - lo;
  if (n <= 2) return;
  // axis of max extent over REAL points in the segment (dummies sort last
  // on any axis, so they never drive the choice)
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  bool any = false;
  for (int64_t k = lo; k < hi; ++k) {
    const int32_t i = c.idx[k];
    if (i >= c.T) continue;
    any = true;
    const float* p = c.cent + 3 * (int64_t)i;
    for (int a = 0; a < 3; ++a) {
      mn[a] = p[a] < mn[a] ? p[a] : mn[a];
      mx[a] = p[a] > mx[a] ? p[a] : mx[a];
    }
  }
  int axis = 0;
  if (any) {
    float best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a)
      if (mx[a] - mn[a] > best) best = mx[a] - mn[a], axis = a;
  }
  const int64_t mid = lo + n / 2;
  std::nth_element(c.idx + lo, c.idx + mid, c.idx + hi,
                   [&c, axis](int32_t a, int32_t b) {
                     return kd_coord(c, a, axis) < kd_coord(c, b, axis);
                   });
  kd_recurse(c, lo, mid);
  kd_recurse(c, mid, hi);
}

}  // namespace

// cent: (T, 3) f32 centroids; order_out: (T2,) int32 receiving the kd
// permutation (values < T are real triangles, >= T dummy slots). T2 must be
// a power of two >= T.
void hpsdf_kd_order(const float* cent, int64_t T, int64_t T2,
                    int32_t* order_out) {
  for (int64_t i = 0; i < T2; ++i) order_out[i] = (int32_t)i;
  KdCtx c{cent, T, order_out};
  kd_recurse(c, 0, T2);
}

// Pack kd-ordered triangle rows (bvh.pack_triangles equivalent): rows is
// (T2, 32) f32, filled with `big` everywhere and, for each k, row slots[k]
// gets triangle order[k]'s [v0 v1 v2 face_n vpn0 vpn1 vpn2 epn0 epn1 epn2].
// verts: (V,3) f64, faces: (F,3) i32, face_n: (F,3) f64,
// vertex_pn: (V,3) f64, edge_pn: (F,3,3) f64.
void hpsdf_pack_tris(const double* verts, const int32_t* faces,
                     const double* face_n, const double* vertex_pn,
                     const double* edge_pn, const int32_t* order,
                     const int64_t* slots, int64_t K, int64_t T2,
                     float big, float* rows) {
  const int W = 32;
  for (int64_t i = 0; i < T2 * W; ++i) rows[i] = big;
  for (int64_t k = 0; k < K; ++k) {
    const int64_t t = order[k];
    float* r = rows + (int64_t)W * slots[k];
    const int32_t* fc = faces + 3 * t;
    for (int v = 0; v < 3; ++v)
      for (int d = 0; d < 3; ++d)
        r[3 * v + d] = (float)verts[3 * (int64_t)fc[v] + d];
    for (int d = 0; d < 3; ++d) r[9 + d] = (float)face_n[3 * t + d];
    for (int v = 0; v < 3; ++v)
      for (int d = 0; d < 3; ++d)
        r[12 + 3 * v + d] = (float)vertex_pn[3 * (int64_t)fc[v] + d];
    for (int e = 0; e < 3; ++e)
      for (int d = 0; d < 3; ++d)
        r[21 + 3 * e + d] = (float)edge_pn[9 * t + 3 * e + d];
  }
}

// Heap node rows from packed triangle rows (bvh.build_bvh's leaf-AABB +
// level-union stages): rows (T2, 32) f32 as written by hpsdf_pack_tris
// (vertices in lanes 0..8; dummy rows all `big`, whose degenerate boxes
// never pass pruning). node_rows (T2, 16) f32 out: heap node i (1..T2-1)
// gets [left_min left_max right_min right_max pad4]; row 0 unused. One
// linear pass for the leaf boxes plus a geometric-series union sweep --
// the numpy equivalent paid ~1.6 s of the 3.4 s build at 1.3M tris.
void hpsdf_bvh_nodes(const float* rows, int64_t T2, float* node_rows) {
  const int W = 32;
  std::vector<float> mn((size_t)3 * T2), mx((size_t)3 * T2);
  for (int64_t i = 0; i < T2; ++i) {
    const float* r = rows + (int64_t)W * i;
    for (int a = 0; a < 3; ++a) {
      float lo = r[a], hi = r[a];
      lo = r[3 + a] < lo ? r[3 + a] : lo;
      hi = r[3 + a] > hi ? r[3 + a] : hi;
      lo = r[6 + a] < lo ? r[6 + a] : lo;
      hi = r[6 + a] > hi ? r[6 + a] : hi;
      mn[3 * i + a] = lo;
      mx[3 * i + a] = hi;
    }
  }
  for (int64_t i = 0; i < 16 * T2; ++i) node_rows[i] = 0.0f;
  std::vector<float> nmn, nmx;
  for (int64_t first = T2 / 2; first >= 1; first /= 2) {
    nmn.resize((size_t)3 * first);
    nmx.resize((size_t)3 * first);
    for (int64_t j = 0; j < first; ++j) {
      float* out = node_rows + 16 * (first + j);
      const float* lmin = mn.data() + 6 * j;
      const float* lmax = mx.data() + 6 * j;
      const float* rmin = lmin + 3;
      const float* rmax = lmax + 3;
      for (int a = 0; a < 3; ++a) {
        out[a] = lmin[a];
        out[3 + a] = lmax[a];
        out[6 + a] = rmin[a];
        out[9 + a] = rmax[a];
        nmn[3 * j + a] = lmin[a] < rmin[a] ? lmin[a] : rmin[a];
        nmx[3 * j + a] = lmax[a] > rmax[a] ? lmax[a] : rmax[a];
      }
    }
    mn.swap(nmn);
    mx.swap(nmx);
  }
}

// Mesh geometry (Baerentzen-Aanaes pseudo-normal precompute, the native
// counterpart of mesh/core.py build_mesh's numpy phase; reference:
// Source/Meshing/Mesh.cpp:200-242): face normals, angle-weighted vertex
// pseudo-normals, and edge pseudo-normals in one pass over the faces.
// verts (V,3) f64, faces (F,3) i32, twin (3F,) i32 (flat half-edge twins).
// Outputs: fn (F,3), vpn (V,3), epn (F,3,3), all f64, unit (zero where
// degenerate). The numpy path pays ~4.3 s at 1.3M faces on this host's 2
// vCPUs; this loop runs it in a few hundred ms.
void hpsdf_mesh_geom(const double* verts, const int32_t* faces,
                     const int32_t* twin, int64_t V, int64_t F,
                     double* fn, double* vpn, double* epn) {
  auto norm3 = [](double* p) {
    double l = std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
    if (l > 0.0) { p[0] /= l; p[1] /= l; p[2] /= l; }
    else { p[0] = p[1] = p[2] = 0.0; }
  };
  for (int64_t i = 0; i < 3 * V; ++i) vpn[i] = 0.0;
  for (int64_t f = 0; f < F; ++f) {
    const int32_t* fc = faces + 3 * f;
    const double* p0 = verts + 3 * (int64_t)fc[0];
    const double* p1 = verts + 3 * (int64_t)fc[1];
    const double* p2 = verts + 3 * (int64_t)fc[2];
    double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    double* n = fn + 3 * f;
    n[0] = e1[1] * e2[2] - e1[2] * e2[1];
    n[1] = e1[2] * e2[0] - e1[0] * e2[2];
    n[2] = e1[0] * e2[1] - e1[1] * e2[0];
    norm3(n);
    // incident angle at each corner -> angle-weighted accumulation
    const double* pts[3] = {p0, p1, p2};
    for (int e = 0; e < 3; ++e) {
      const double* a = pts[e];
      const double* b = pts[(e + 1) % 3];
      const double* c = pts[(e + 2) % 3];
      double u1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      double u2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      double l1 = std::sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
      double l2 = std::sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
      double denom = l1 * l2;
      double cosang = denom > 0.0
          ? (u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2]) / denom : 1.0;
      cosang = cosang > 1.0 ? 1.0 : (cosang < -1.0 ? -1.0 : cosang);
      double ang = std::acos(cosang);
      double* acc = vpn + 3 * (int64_t)fc[e];
      acc[0] += ang * n[0];
      acc[1] += ang * n[1];
      acc[2] += ang * n[2];
    }
  }
  for (int64_t i = 0; i < V; ++i) norm3(vpn + 3 * i);
  for (int64_t f = 0; f < F; ++f) {
    for (int e = 0; e < 3; ++e) {
      int64_t tf = twin[3 * f + e] / 3;
      double* o = epn + 9 * f + 3 * e;
      o[0] = fn[3 * f + 0] + fn[3 * tf + 0];
      o[1] = fn[3 * f + 1] + fn[3 * tf + 1];
      o[2] = fn[3 * f + 2] + fn[3 * tf + 2];
      norm3(o);
    }
  }
}

const char* hpsdf_version() { return "hpsdf_native 4"; }

}  // extern "C"
