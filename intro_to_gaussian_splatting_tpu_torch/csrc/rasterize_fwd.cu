// Forward tile rasterizer for Hopper (sm_90a): kernel B1 of the port.
//
// Replaces the TPU kernel `_fwd_kernel` (`_fwd_pallas`, entry point
// `rasterize_pairs`) of intro_to_gaussian_splatting_tpu/ops/rasterize_pallas.py.
// It computes the same function: front-to-back alpha compositing of the
// (tile, depth)-sorted pair stream,
//     alpha = clip(opacity * exp(-0.5 * conic quadratic), 0, alpha_clamp)
// with the optional alpha_min and pixel-bbox masks, a pair counting while
// T * (1 - alpha) >= t_threshold, and out = sum of w * [r, g, b, depth, 1].
// The TPU kernel's one-hot MXU matmuls, segmented scans and chunk DMA exist
// for the TPU and are not carried over.
//
// Design: one block per tile slot (grid = NG * GT, so padded slots write
// zeros). A thread owns kPpt = 4 horizontally adjacent pixels of one tile
// row (64 threads per 16x16 tile, 256 at tile size 32; the tile side is a
// template parameter). The block stages its tile's records in shared
// memory in batches of kBatch pairs, each pair as three float4s (four with
// the bbox test), so that one 128-bit broadcast load serves a thread's 4
// pixels; only the 11 record rows the compositing reads (15 with the bbox
// test) are staged. The records are double-buffered: one __syncthreads
// per batch publishes the next batch, whose loads are issued before the
// current batch is composited and stored after it. Each thread composites
// its pixels with their own T and drops a pixel at the first pair where
// T * (1 - alpha) < t_threshold; that is exact because alpha <=
// alpha_clamp < 1 keeps T monotone. The block stops at the first batch
// boundary where all its pixels are done (__syncthreads_count). The
// rasterizer's alpha_min and bbox options are template flags, so the
// default path tests neither per pixel. Each thread writes its 5 channels
// into the (NG, 5, GT, ts*ts) layout as one float4 per channel; tiles
// without pairs and padded slots write their zeros and stage nothing.
//
// What bounds it on an H100: at the reference init (about 1.2 pairs per
// tile) the 5-channel output, 338 MB, is almost all the traffic, so it is
// bound by bytes; at the KNN init (about 440 pairs per tile, 57 of them
// before the tile's pixels have all exited) by the issue rate of the
// per-(pair, pixel) arithmetic, about 45 instructions per evaluation under
// -fmad=false with IEEE expf. Four pixels per thread share the record
// loads, the row's dy and conic term (cc * dy * dy) and the loop.
//
// Numerics: expf, not __expf, and the build passes -fmad=false, so each
// step rounds as the plain PyTorch version's does (its `_alpha_terms`, in
// its order) and an exit decision at the threshold does not flip between
// the two: the output is the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 32;        // pairs staged per shared-memory batch
constexpr int kOutChannels = 5;   // [r, g, b, depth, alpha]
// pixels per thread: 64 threads at tile size 16, 256 at tile size 32
// (1, 2 and 8 were slower)
constexpr int kPpt = 4;

// Staged record fields, four floats each (record rows, ops/projection.py
// REC_*): 0 {mean_x, mean_y, conic_a, conic_b}, 1 {conic_c, opacity, r, g},
// 2 {b, depth, one, -}, 3 {min_x, max_x, min_y, max_y} (bbox test only).
// Slot r of the 16 = field r / 4, component r % 4; slot 11 is unused.
__device__ __forceinline__ int record_row(int slot) {
  return slot < 6 ? slot : (slot < 11 ? slot + 5 : slot - 6);
}

// a thread's kPpt = 4 adjacent pixels of one channel, one 16-byte store
__device__ __forceinline__ void store_pixels(float* p,
                                             const float (&v)[kPpt]) {
  static_assert(kPpt == 4, "one float4 per channel");
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int TS, bool ALPHA_MIN, bool BBOX>
__global__ void __launch_bounds__(TS * TS / kPpt) rasterize_fwd_kernel(
    const float* __restrict__ rec, int64_t mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    int num_tiles, int group_tiles, float alpha_clamp, float alpha_min,
    float t_threshold, float* __restrict__ out) {
  constexpr int kPix = TS * TS;
  constexpr int kThreads = kPix / kPpt;
  constexpr int kFields = BBOX ? 4 : 3;
  constexpr int kUnits = kFields * kBatch;          // float4s per batch
  constexpr int kLoads = (kUnits + kThreads - 1) / kThreads;
  __shared__ float4 s[2][kFields][kBatch];

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = slot / group_tiles;
  const int jt = slot - g * group_tiles;
  const int64_t plane = (int64_t)group_tiles * kPix;
  float* dst = out + (int64_t)g * kOutChannels * plane + (int64_t)jt * kPix
               + tid * kPpt;

  int start = 0, count = 0;
  if (slot < num_tiles) {
    start = tile_starts[slot];
    count = tile_counts[slot];
  }
  float T[kPpt], acc[kOutChannels][kPpt];
  bool done[kPpt];
#pragma unroll
  for (int i = 0; i < kPpt; ++i) {
    T[i] = 1.0f;
    done[i] = false;
#pragma unroll
    for (int c = 0; c < kOutChannels; ++c) acc[c][i] = 0.0f;
  }
  if (count == 0) {
#pragma unroll
    for (int c = 0; c < kOutChannels; ++c)
      store_pixels(dst + c * plane, acc[c]);
    return;
  }

  // a batch's records: thread loads float4 units tid, tid + kThreads, ...
  float4 v[kLoads];
  auto load = [&](int b0) {
    const int n = min(kBatch, count - b0);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int u = tid + q * kThreads;
      const int f = u / kBatch;
      const int j = u - f * kBatch;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (u < kUnits && j < n) {
        const float* col = rec + start + b0 + j;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int slot_r = f * 4 + c;
          if (slot_r != 11) x[c] = col[(int64_t)record_row(slot_r) * mp];
        }
      }
      v[q] = make_float4(x[0], x[1], x[2], x[3]);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int u = tid + q * kThreads;
      if (u < kUnits) (&s[buf][0][0])[u] = v[q];
    }
  };

  const int px0 = (tid * kPpt) % TS;
  const float py = (float)((tid * kPpt) / TS);

  load(0);
  store(0);
  const int nb = (count + kBatch - 1) / kBatch;
  for (int b = 0; b < nb; ++b) {
    const int cur = b & 1;
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPpt; ++i) any = any || !done[i];
    // publishes batch b's records and lets every read of the other
    // buffer (batch b - 1) finish
    if (__syncthreads_count(any) == 0) break;
    const bool more = b + 1 < nb;
    if (more) load((b + 1) * kBatch);
    const int n = min(kBatch, count - b * kBatch);
    for (int j = 0; any && j < n; ++j) {
      const float4 f0 = s[cur][0][j];
      const float4 f1 = s[cur][1][j];
      const float4 f2 = s[cur][2][j];
      const float mx = f0.x, my = f0.y, ca = f0.z;
      // 2 * b is exact: the products round as 2.0f * b * dx * dy does
      const float cb2 = 2.0f * f0.w;
      const float cc = f1.x, op = f1.y;
      const float dy = py - my;
      const float qy = cc * dy * dy;
      const float4 box = BBOX ? s[cur][BBOX ? 3 : 0][j] : f0;
      any = false;
#pragma unroll
      for (int i = 0; i < kPpt; ++i) {
        if (done[i]) continue;
        const float px = (float)(px0 + i);
        const float dx = px - mx;
        const float q = ca * dx * dx + cb2 * dx * dy + qy;
        const float weight = expf(-0.5f * q);
        const float alpha_raw = op * weight;
        float a = fminf(fmaxf(alpha_raw, 0.0f), alpha_clamp);
        if (ALPHA_MIN && !(alpha_raw >= alpha_min)) a = 0.0f;
        if (BBOX && !(px >= box.x && px <= box.y && py >= box.z &&
                      py <= box.w))
          a = 0.0f;
        const float t_incl = T[i] * (1.0f - a);
        if (!(t_incl >= t_threshold)) {
          done[i] = true;
          continue;
        }
        const float w = T[i] * a;
        acc[0][i] = acc[0][i] + f1.z * w;
        acc[1][i] = acc[1][i] + f1.w * w;
        acc[2][i] = acc[2][i] + f2.x * w;
        acc[3][i] = acc[3][i] + f2.y * w;
        acc[4][i] = acc[4][i] + f2.z * w;
        T[i] = t_incl;
        any = true;
      }
    }
    if (more) store(cur ^ 1);
  }

#pragma unroll
  for (int c = 0; c < kOutChannels; ++c)
    store_pixels(dst + c * plane, acc[c]);
}

template <int TS>
cudaError_t launch_tiles(const float* records, int64_t mp,
                         const int* tile_starts, const int* tile_counts,
                         int num_tiles, int num_slots, int group_tiles,
                         float alpha_clamp, float alpha_min,
                         float t_threshold, int pixel_bbox_test, float* out,
                         cudaStream_t st) {
  const bool amin = alpha_min > 0.0f;
  const auto kernel =
      amin ? (pixel_bbox_test ? rasterize_fwd_kernel<TS, true, true>
                              : rasterize_fwd_kernel<TS, true, false>)
           : (pixel_bbox_test ? rasterize_fwd_kernel<TS, false, true>
                              : rasterize_fwd_kernel<TS, false, false>);
  kernel<<<num_slots, TS * TS / kPpt, 0, st>>>(
      records, mp, tile_starts, tile_counts, num_tiles, group_tiles,
      alpha_clamp, alpha_min, t_threshold, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// records (16, mp) f32; tile_starts, tile_counts (num_tiles,) i32;
// out (num_slots / group_tiles, 5, group_tiles, tile_size^2) f32, 16-byte
// aligned. tile_size is 16 or 32.
int rasterize_fwd(const float* records, long long mp, const int* tile_starts,
                  const int* tile_counts, int num_tiles, int num_slots,
                  int group_tiles, int tile_size, float alpha_clamp,
                  float alpha_min, float t_threshold, int pixel_bbox_test,
                  float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tile_size != 16 && tile_size != 32) return (int)cudaErrorInvalidValue;
  if (num_slots > 0) {
    err = (tile_size == 16 ? launch_tiles<16> : launch_tiles<32>)(
        records, (int64_t)mp, tile_starts, tile_counts, num_tiles, num_slots,
        group_tiles, alpha_clamp, alpha_min, t_threshold, pixel_bbox_test,
        out, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* rasterize_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
