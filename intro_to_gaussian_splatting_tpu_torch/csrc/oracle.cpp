// CPU oracle rasterizer: scalar front-to-back alpha compositing.
//
// The port's own copy of the JAX package's golden oracle, with the same C
// ABI. It consumes the packed splat records of the projection pass
// (ops/projection.py, the REC_* rows) and composites each pixel with the
// exact sequential loop semantics of the reference Python/CUDA renderers
// (splat/gaussian_scene.py:146-171, splat/c/render.cu:49-81), including
// the tile-overlap pre-cull, the per-pixel bbox test (CUDA mode), the alpha
// clamp and the permanent early-exit break. It shares no code or formula
// with the port's torch renderers, so tests hold those against it.
//
// Exposed through ctypes by utils/native.py, which builds it at first use
// (ops/cuda_build.py HostSource: g++ -O3 -march=native -fPIC -shared).

#include <cmath>
#include <cstdint>

namespace {

// record rows, keep in sync with ops/projection.py (REC_*)
enum Row {
  MEAN_X = 0, MEAN_Y, CONIC_A, CONIC_B, CONIC_C, OPACITY,
  MIN_X, MAX_X, MIN_Y, MAX_Y, TILE,
  COLOR_R, COLOR_G, COLOR_B, DEPTH, ONE,
  NUM_ROWS
};

struct Config {
  int tile_size;
  float t_threshold;
  float alpha_clamp;
  float alpha_min;
  int pixel_bbox_test;        // CUDA-compat per-pixel bbox reject
  int inclusive_tile_overlap; // reference tile-overlap quirk
  int skip_last_tile;         // reference margin quirk
};

}  // namespace

extern "C" {

// records: (NUM_ROWS, n) row-major, depth-sorted front to back.
// valid:   (n,) uint8.
// image:   (height, width, 3) f32, zero-initialized by the caller.
void oracle_render(const float* records, const uint8_t* valid, int64_t n,
                   int width, int height, const Config* cfg, float* image) {
  const float* mx = records + (int64_t)MEAN_X * n;
  const float* my = records + (int64_t)MEAN_Y * n;
  const float* ca = records + (int64_t)CONIC_A * n;
  const float* cb = records + (int64_t)CONIC_B * n;
  const float* cc = records + (int64_t)CONIC_C * n;
  const float* op = records + (int64_t)OPACITY * n;
  const float* minx = records + (int64_t)MIN_X * n;
  const float* maxx = records + (int64_t)MAX_X * n;
  const float* miny = records + (int64_t)MIN_Y * n;
  const float* maxy = records + (int64_t)MAX_Y * n;
  const float* cr = records + (int64_t)COLOR_R * n;
  const float* cg = records + (int64_t)COLOR_G * n;
  const float* cbl = records + (int64_t)COLOR_B * n;

  const int ts = cfg->tile_size;
  const float hi = cfg->inclusive_tile_overlap ? (float)ts : (float)(ts - 1);

  int lim_x = width, lim_y = height;
  if (cfg->skip_last_tile) {
    lim_x = width > ts ? ((width - ts - 1) / ts + 1) * ts : 0;
    lim_y = height > ts ? ((height - ts - 1) / ts + 1) * ts : 0;
  }

  for (int py = 0; py < height; ++py) {
    for (int px = 0; px < width; ++px) {
      float* out = image + ((int64_t)py * width + px) * 3;
      if (px >= lim_x || py >= lim_y) continue;
      const float tx0 = (float)((px / ts) * ts);
      const float ty0 = (float)((py / ts) * ts);
      float T = 1.0f;
      float r = 0.f, g = 0.f, b = 0.f;
      for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        // tile-level binning cull (gaussian_scene.py:209-218 semantics)
        if (!(minx[i] <= tx0 + hi && maxx[i] >= tx0 &&
              miny[i] <= ty0 + hi && maxy[i] >= ty0))
          continue;
        if (cfg->pixel_bbox_test &&
            !(px >= minx[i] && px <= maxx[i] &&
              py >= miny[i] && py <= maxy[i]))
          continue;
        const float dx = (float)px - mx[i];
        const float dy = (float)py - my[i];
        const float power =
            ca[i] * dx * dx + 2.0f * cb[i] * dx * dy + cc[i] * dy * dy;
        const float w = std::exp(-0.5f * power);
        float alpha = op[i] * w;
        if (cfg->alpha_min > 0.0f && alpha < cfg->alpha_min) continue;
        if (alpha > cfg->alpha_clamp) alpha = cfg->alpha_clamp;
        const float test_T = T * (1.0f - alpha);
        if (test_T < cfg->t_threshold) break;  // permanent early exit
        r += T * alpha * cr[i];
        g += T * alpha * cg[i];
        b += T * alpha * cbl[i];
        T = test_T;
      }
      out[0] = r; out[1] = g; out[2] = b;
    }
  }
}

}  // extern "C"
