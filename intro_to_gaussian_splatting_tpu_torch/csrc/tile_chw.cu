// Channel-major image -> tile-group layout for Hopper (sm_90a): kernel
// B5-tile of the port, the gradient of B5-untile.
//
// Replaces the TPU kernel `_tile_kernel` (`_tile_impl`, the VJP of
// `untile_chw_fast`) of intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py.
// It computes the adjoint of `untile_chw` restricted to the 3 colour
// channels: for the (NG, C, GT, ts*ts) output,
//     out[g, c, j, p] = img[c, y, x]   if c < 3, t < ntx*nty, y < H, x < W
//                     = 0              otherwise
// with t = g * GT + j, y = (t / ntx) * ts + p / ts, x = (t % ntx) * ts +
// p % ts. Channels >= 3 (depth, alpha), pixels of edge tiles outside the
// image and the phantom tiles of the group padding all get exactly 0, so the
// rasterizer's backward sees no cotangent there. The TPU version's band
// and 128-lane padding were Mosaic DMA constraints and are gone.
//
// What bounds it on an H100: it is a copy, bound by bytes (the 3-channel
// image read once, the C-channel tile layout written once: about 540 MB at
// 5068 x 3324 with C = 5). Both layouts hold pixels in runs of ts
// contiguous floats, so every fetched sector is used in full; what limits
// a copy is the bytes in flight per SM, about 18 KB to keep 3.35 TB/s busy
// at 700 ns of DRAM latency (3.35 TB/s x 0.7 us / 132 SMs), and how long
// the runs of one warp's access are. The first version moved one float per
// thread in one block per (tile slot, channel): 330k blocks of 1 KB each
// at that size, 40% of them storing nothing but zeros.
//
// The design: one block moves a strip of K tiles side by side (one band of
// ts image rows, 128 pixels wide at ts = 16, 64 at ts = 32) through shared
// memory. Each thread issues its 6 float4 loads of the image (2 per colour
// channel, 96 bytes in flight), zero outside the image; a warp reads 512
// contiguous bytes of one row (256 at ts = 32). After a barrier the block
// writes the strip's tile slots in every output channel, the image's
// values or exact zeros, as float4s: a warp writes 512 contiguous bytes of
// one tile. Blocks past the strips write the phantom slots' zeros, so each
// output float4 is written exactly once. 5 blocks share an SM. A first
// design without shared memory (one float4 of a tile slot per thread,
// reading 64-byte runs of 8 image rows) and a TMA design (one 3-D box load
// with zero fill, one 5-D box store per tile) were slower; PERF.md has the
// times. ts is a template parameter, so every index is a shift or a mask.
// The image side is read as float4 where the wrapper says it is aligned
// (W % 4 == 0 and a 16-byte aligned image), else as 4 scalar loads, each
// masked at W. A 1-D grid, so the group count does not meet the grid's
// 65,535 limit in z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 3;   // image channels
// blocks that share an SM: 5 and not the 8 that fit, faster at 5068 x 3324
// on the H100 (PERF.md)
constexpr int kBlocksPerSm = 5;

template <int TS>
struct Strip {
  static constexpr int K = 2048 / (TS * TS);    // tiles per strip: 8 or 2
  static constexpr int kWidth = K * TS;          // pixels: 128 or 64
  static constexpr int kRow = kWidth + 16;       // shared row, padded
  static constexpr int kTileQuads = TS * TS / 4; // float4s of a tile slot
  static constexpr int kRowQuads = kWidth / 4;
  static constexpr int kPer = kChannels * TS * kRowQuads / kThreads;  // 6
  // shared memory a block reserves beyond its strip, so that kBlocksPerSm
  // blocks share an SM's 228 KB (each also takes 1 KB of the system's)
  static constexpr int kOccupancyPad = 233472 / kBlocksPerSm - 1024 -
                                       (int)sizeof(float) * kChannels * TS *
                                           kRow;
};

template <int TS, bool kVecImage>
__global__ void __launch_bounds__(kThreads)
tile_chw_kernel(const float* __restrict__ img, int out_channels,
                int group_tiles, int ntx, int strips_x, int num_strips,
                int num_tiles, int num_slots, int height, int width,
                float* __restrict__ out) {
  using S = Strip<TS>;
  __shared__ __align__(16) float strip[kChannels][TS][S::kRow];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int64_t plane = (int64_t)group_tiles * TS * TS;
  if ((int)blockIdx.x >= num_strips) {
    // the phantom slots of the group padding: zeros in every channel
    const int64_t f =
        (int64_t)(blockIdx.x - num_strips) * kThreads + threadIdx.x;
    const int64_t slot_quads = (int64_t)out_channels * S::kTileQuads;
    const int64_t t = num_tiles + f / slot_quads;
    if (t >= num_slots) return;
    const int c = (int)(f % slot_quads) / S::kTileQuads;
    const int q = (int)(f % S::kTileQuads);
    const int64_t g = t / group_tiles, j = t - g * group_tiles;
    reinterpret_cast<float4*>(
        out + (g * out_channels * group_tiles + j) * TS * TS + c * plane)[q] =
        zero;
    return;
  }
  const int ty = blockIdx.x / strips_x;
  const int tx0 = (blockIdx.x - ty * strips_x) * S::K;
  // image side: a warp reads contiguous float4s of one row
  const int64_t hw = (int64_t)height * width;
  float4 v[S::kPer];
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const int f = threadIdx.x + r * kThreads;
    const int c = f / (TS * S::kRowQuads);
    const int y = f / S::kRowQuads % TS;
    const int x4 = f % S::kRowQuads;
    const int yi = ty * TS + y, xi = tx0 * TS + x4 * 4;
    v[r] = zero;
    if (yi < height && xi < width) {
      const float* s = img + c * hw + (int64_t)yi * width + xi;
      if (kVecImage) {
        v[r] = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        v[r].x = __ldg(s);
        if (xi + 1 < width) v[r].y = __ldg(s + 1);
        if (xi + 2 < width) v[r].z = __ldg(s + 2);
        if (xi + 3 < width) v[r].w = __ldg(s + 3);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const int f = threadIdx.x + r * kThreads;
    const int c = f / (TS * S::kRowQuads);
    const int y = f / S::kRowQuads % TS;
    const int x4 = f % S::kRowQuads;
    *reinterpret_cast<float4*>(&strip[c][y][x4 * 4]) = v[r];
  }
  __syncthreads();
  // tile side: a warp writes 512 contiguous bytes of one tile and channel
  for (int f = threadIdx.x; f < out_channels * S::K * S::kTileQuads;
       f += kThreads) {
    const int c = f / (S::K * S::kTileQuads);
    const int k = f / S::kTileQuads % S::K;
    const int q = f % S::kTileQuads;
    if (tx0 + k >= ntx) continue;
    const int t = ty * ntx + tx0 + k;
    const int g = t / group_tiles, j = t - g * group_tiles;
    const float4 w = c < kChannels
        ? *reinterpret_cast<const float4*>(
              &strip[c][q / (TS / 4)][k * TS + q % (TS / 4) * 4])
        : zero;
    reinterpret_cast<float4*>(
        out + ((int64_t)g * out_channels * group_tiles + j) * TS * TS +
        c * plane)[q] = w;
  }
}

template <int TS>
void launch(bool vec_image, const float* img, int out_channels,
            int num_groups, int group_tiles, int ntx, int nty, int height,
            int width, float* out, cudaStream_t stream) {
  const int strips_x = (ntx + Strip<TS>::K - 1) / Strip<TS>::K;
  const int num_strips = strips_x * nty;
  const int num_tiles = ntx * nty, num_slots = num_groups * group_tiles;
  const int64_t phantom_quads =
      (int64_t)(num_slots - num_tiles) * out_channels * Strip<TS>::kTileQuads;
  const int blocks =
      num_strips + (int)((phantom_quads + kThreads - 1) / kThreads);
  if (vec_image)
    tile_chw_kernel<TS, true>
        <<<blocks, kThreads, Strip<TS>::kOccupancyPad, stream>>>(
        img, out_channels, group_tiles, ntx, strips_x, num_strips, num_tiles,
        num_slots, height, width, out);
  else
    tile_chw_kernel<TS, false>
        <<<blocks, kThreads, Strip<TS>::kOccupancyPad, stream>>>(
        img, out_channels, group_tiles, ntx, strips_x, num_strips, num_tiles,
        num_slots, height, width, out);
}

}  // namespace

extern "C" {

// img (channels, height, width) f32 -> out
// (num_groups, out_channels, group_tiles, tile_size^2) f32, 16-byte aligned.
// channels = 3 <= out_channels, tile_size 16 or 32, num_groups *
// group_tiles >= ntx * nty, height <= nty * tile_size, width <= ntx *
// tile_size; vec_image: width % 4 == 0 and img 16-byte aligned (the
// wrapper checks all of these).
int tile_chw(const float* img, int channels, int out_channels, int num_groups,
             int group_tiles, int ntx, int nty, int tile_size, int height,
             int width, int vec_image, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (channels != kChannels || out_channels < kChannels ||
      (tile_size != 16 && tile_size != 32) ||
      (int64_t)num_groups * group_tiles < (int64_t)ntx * nty)
    return (int)cudaErrorInvalidValue;
  if (num_groups > 0 && group_tiles > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (tile_size == 16)
      launch<16>(vec_image != 0, img, out_channels, num_groups, group_tiles,
                 ntx, nty, height, width, out, st);
    else
      launch<32>(vec_image != 0, img, out_channels, num_groups, group_tiles,
                 ntx, nty, height, width, out, st);
  }
  return (int)cudaGetLastError();
}

const char* tile_chw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
