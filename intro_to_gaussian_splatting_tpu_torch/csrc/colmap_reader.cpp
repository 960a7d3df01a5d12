// Native COLMAP binary parser.
//
// The port's own copy of the JAX package's reader, with the same C ABI.
// The reference parses images.bin / points3D.bin with a per-record Python
// struct loop (ref splat/read_colmap.py:201-238). This walks the same
// fixed record formats (colmap/src/colmap/scene/reconstruction.cc) in C++
// into flat arrays, through a two-pass C ABI (pass 0 counts, pass 1
// fills) so that the Python side owns all allocations. A record that runs
// past the end of the buffer makes a pass return -1. io/colmap.py uses it
// through utils/native.py whenever a C++ compiler is available.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  template <typename T> T get() {
    if (!ok || (size_t)(end - p) < sizeof(T)) { ok = false; return T{}; }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
  // skip count records of elem bytes; a count read from a corrupt file
  // may be anything, so compare without multiplying
  void skip(uint64_t count, uint64_t elem) {
    if (!ok || count > (uint64_t)(end - p) / elem) { ok = false; return; }
    p += count * elem;
  }
};

}  // namespace

extern "C" {

// ---- points3D.bin ----------------------------------------------------
// Pass 0: returns n_points and writes total track length to *total_track.
// Pass 1 (fill != 0): fills ids(i64), xyz(f64*3), rgb(u8*3), error(f64),
// track_lengths(i64), track_image_ids(i64), track_p2d(i64).
int64_t colmap_read_points3d(const uint8_t* buf, int64_t size, int fill,
                             int64_t* ids, double* xyz, uint8_t* rgb,
                             double* error, int64_t* track_lengths,
                             int64_t* track_image_ids, int64_t* track_p2d,
                             int64_t* total_track) {
  Reader r{buf, buf + size};
  const uint64_t n = r.get<uint64_t>();
  int64_t tt = 0;
  for (uint64_t i = 0; i < n && r.ok; ++i) {
    const uint64_t pid = r.get<uint64_t>();
    double x = r.get<double>(), y = r.get<double>(), z = r.get<double>();
    uint8_t cr = r.get<uint8_t>(), cg = r.get<uint8_t>(), cb = r.get<uint8_t>();
    double err = r.get<double>();
    const uint64_t tl = r.get<uint64_t>();
    if (fill) {
      ids[i] = (int64_t)pid;
      xyz[i * 3] = x; xyz[i * 3 + 1] = y; xyz[i * 3 + 2] = z;
      rgb[i * 3] = cr; rgb[i * 3 + 1] = cg; rgb[i * 3 + 2] = cb;
      error[i] = err;
      track_lengths[i] = (int64_t)tl;
      for (uint64_t k = 0; k < tl && r.ok; ++k) {
        track_image_ids[tt + (int64_t)k] = r.get<int32_t>();
        track_p2d[tt + (int64_t)k] = r.get<int32_t>();
      }
    } else {
      r.skip(tl, 8);
    }
    tt += (int64_t)tl;
  }
  if (!r.ok) return -1;
  *total_track = tt;
  return (int64_t)n;
}

// ---- images.bin -------------------------------------------------------
// Pass 0: returns n_images; *total_pts = sum of per-image 2D point counts,
// *total_name_bytes = sum of name lengths (no NULs).
// Pass 1: fills ids(i32), qvec(f64*4), tvec(f64*3), camera_ids(i32),
// name_lengths(i64), names(char, concatenated), pt_counts(i64),
// xys(f64*2), point3d_ids(i64).
int64_t colmap_read_images(const uint8_t* buf, int64_t size, int fill,
                           int32_t* ids, double* qvec, double* tvec,
                           int32_t* camera_ids, int64_t* name_lengths,
                           char* names, int64_t* pt_counts, double* xys,
                           int64_t* point3d_ids, int64_t* total_pts,
                           int64_t* total_name_bytes) {
  Reader r{buf, buf + size};
  const uint64_t n = r.get<uint64_t>();
  int64_t tp = 0, tn = 0;
  for (uint64_t i = 0; i < n && r.ok; ++i) {
    const int32_t iid = r.get<int32_t>();
    double q[4], t[3];
    for (double& v : q) v = r.get<double>();
    for (double& v : t) v = r.get<double>();
    const int32_t cid = r.get<int32_t>();
    int64_t name_len = 0;
    while (r.ok) {
      const char c = (char)r.get<uint8_t>();
      if (c == '\0') break;
      if (fill) names[tn + name_len] = c;
      ++name_len;
    }
    const uint64_t npts = r.get<uint64_t>();
    if (fill) {
      ids[i] = iid;
      std::memcpy(qvec + i * 4, q, sizeof(q));
      std::memcpy(tvec + i * 3, t, sizeof(t));
      camera_ids[i] = cid;
      name_lengths[i] = name_len;
      pt_counts[i] = (int64_t)npts;
      for (uint64_t k = 0; k < npts && r.ok; ++k) {
        xys[(tp + (int64_t)k) * 2] = r.get<double>();
        xys[(tp + (int64_t)k) * 2 + 1] = r.get<double>();
        point3d_ids[tp + (int64_t)k] = r.get<int64_t>();
      }
    } else {
      r.skip(npts, 24);
    }
    tp += (int64_t)npts;
    tn += name_len;
  }
  if (!r.ok) return -1;
  *total_pts = tp;
  *total_name_bytes = tn;
  return (int64_t)n;
}

}  // extern "C"
