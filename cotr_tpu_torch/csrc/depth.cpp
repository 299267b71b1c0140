// Host-side inner loops of the MegaDepth data path. Plain C interface for
// ctypes; built with the host C++ compiler into build/ at first use
// (cotr_tpu_torch/native.py).
//
//   * synth_corrs: depth-consistent correspondences between two RGBD
//     captures, the inner loop of data.dataset.compute_corrs;
//   * count_valid_depth: the number of pixels with depth > 0;
//   * parse_images_txt: the image lines of a COLMAP images.txt.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// Reads one whole line into buf (at most cap - 1 bytes kept, the rest of a
// longer line skipped). Returns false at the end of the file.
bool read_line(std::FILE* f, char* buf, int cap) {
  if (!std::fgets(buf, cap, f)) return false;
  const size_t n = std::strlen(buf);
  if (n > 0 && buf[n - 1] != '\n') {
    int c;
    while ((c = std::fgetc(f)) != EOF && c != '\n') {
    }
  }
  return true;
}

}  // namespace

extern "C" {

// from_depth: (h1, w1) row-major float32, > 0 marks a valid pixel
// inv_k_from: 3x3 row-major inverse intrinsics of the source camera
// c2w_from:   4x4 row-major camera-to-world of the source camera
// p_to:       3x4 row-major K_to @ world-to-camera of the target camera
// to_depth:   (h2, w2) row-major float32 depth of the target camera
// out:        (max_out, 4) float32 [x_from, y_from, x_to, y_to]
// Returns the number of rows written.
//
// The numpy path's semantics, in its order: pixels scanned row-major (the
// order of np.where), lifted where z > 0, moved to the world (dropped where
// w == 0), projected where the camera's z > 0, kept where
// 0 <= x < w2 - 1 and 0 <= y < h2 - 1 and
// |to_depth[floor(y), floor(x)] - z| < 0.5.
int64_t synth_corrs(const float* from_depth, int64_t h1, int64_t w1,
                    const double* inv_k_from, const double* c2w_from,
                    const double* p_to, const float* to_depth,
                    int64_t h2, int64_t w2, float* out, int64_t max_out) {
  int64_t n = 0;
  for (int64_t y = 0; y < h1 && n < max_out; ++y) {
    for (int64_t x = 0; x < w1 && n < max_out; ++x) {
      const float z = from_depth[y * w1 + x];
      if (z <= 0.0f) continue;
      const double px = static_cast<double>(x);
      const double py = static_cast<double>(y);
      const double cx =
          (inv_k_from[0] * px + inv_k_from[1] * py + inv_k_from[2]) * z;
      const double cy =
          (inv_k_from[3] * px + inv_k_from[4] * py + inv_k_from[5]) * z;
      const double cz =
          (inv_k_from[6] * px + inv_k_from[7] * py + inv_k_from[8]) * z;
      if (cz <= 0.0) continue;
      double wx = c2w_from[0] * cx + c2w_from[1] * cy + c2w_from[2] * cz +
                  c2w_from[3];
      double wy = c2w_from[4] * cx + c2w_from[5] * cy + c2w_from[6] * cz +
                  c2w_from[7];
      double wz = c2w_from[8] * cx + c2w_from[9] * cy + c2w_from[10] * cz +
                  c2w_from[11];
      const double ww = c2w_from[12] * cx + c2w_from[13] * cy +
                        c2w_from[14] * cz + c2w_from[15];
      if (ww == 0.0) continue;
      wx /= ww;
      wy /= ww;
      wz /= ww;
      const double ix = p_to[0] * wx + p_to[1] * wy + p_to[2] * wz + p_to[3];
      const double iy = p_to[4] * wx + p_to[5] * wy + p_to[6] * wz + p_to[7];
      const double iz =
          p_to[8] * wx + p_to[9] * wy + p_to[10] * wz + p_to[11];
      if (iz <= 0.0) continue;
      const double ux = ix / iz;
      const double uy = iy / iz;
      if (!(ux >= 0.0 && ux < static_cast<double>(w2 - 1) && uy >= 0.0 &&
            uy < static_cast<double>(h2 - 1)))
        continue;
      const int64_t fx = static_cast<int64_t>(ux);
      const int64_t fy = static_cast<int64_t>(uy);
      const float zt = to_depth[fy * w2 + fx];
      if (!(std::fabs(static_cast<double>(zt) - iz) < 0.5)) continue;
      out[n * 4 + 0] = static_cast<float>(x);
      out[n * 4 + 1] = static_cast<float>(y);
      out[n * 4 + 2] = static_cast<float>(ux);
      out[n * 4 + 3] = static_cast<float>(uy);
      ++n;
    }
  }
  return n;
}

int64_t count_valid_depth(const float* depth, int64_t h, int64_t w) {
  int64_t n = 0;
  const int64_t total = h * w;
  for (int64_t i = 0; i < total; ++i) n += depth[i] > 0.0f;
  return n;
}

// COLMAP images.txt: after the 4 header lines, two lines an image, the
// first "IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME", the second its
// POINTS2D (skipped, however long). Fills image_ids (n), camera_ids (n),
// qtvec (n, 7) [qw qx qy qz tx ty tz] and names (n, name_len), each name
// NUL-terminated. Returns the number of images read (it stops at the first
// line that is not an image line, or at max_images), or -1 when the file
// cannot be opened or has fewer than 4 lines.
int64_t parse_images_txt(const char* path, int64_t max_images,
                         int64_t* image_ids, int64_t* camera_ids,
                         double* qtvec, char* names, int64_t name_len) {
  std::FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  static const int kLine = 8192;
  char line[kLine];
  for (int i = 0; i < 4; ++i) {
    if (!read_line(f, line, kLine)) {
      std::fclose(f);
      return -1;
    }
  }
  int64_t n = 0;
  char name[4096];
  while (n < max_images && read_line(f, line, kLine)) {
    long long iid, cid;
    double q[7];
    const int got = std::sscanf(
        line, "%lld %lf %lf %lf %lf %lf %lf %lf %lld %4095s", &iid, &q[0],
        &q[1], &q[2], &q[3], &q[4], &q[5], &q[6], &cid, name);
    if (got != 10) break;
    read_line(f, line, kLine);  // POINTS2D
    image_ids[n] = iid;
    camera_ids[n] = cid;
    std::memcpy(qtvec + n * 7, q, sizeof(q));
    std::strncpy(names + n * name_len, name, name_len - 1);
    names[n * name_len + name_len - 1] = '\0';
    ++n;
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
