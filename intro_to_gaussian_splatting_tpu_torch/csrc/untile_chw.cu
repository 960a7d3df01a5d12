// Tile-group layout -> channel-major image for Hopper (sm_90a): kernel
// B5-untile of the port.
//
// Replaces the TPU kernel `_untile_kernel` (`_untile_impl`, entry point
// `untile_chw_fast`) of intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py.
// It computes the same permutation as `untile_chw`:
//     out[c, y, x] = tiles[g, c, j, (y % ts) * ts + x % ts]
// with tile t = (y / ts) * ntx + x / ts = g * GT + j, cropped to H x W, for
// the 3 colour channels of a (NG, in_channels, GT, ts*ts) input. The TPU
// version's 4-channel padding was a DMA-alignment need and is gone: the
// kernel reads the rasterizer's 5-channel output in place.
//
// What bounds it on an H100: it is a copy, bound by bytes (3 channels read
// and written once, about 404 MB at 5068 x 3324). Both layouts hold pixels
// in runs of ts contiguous floats (a tile row is a piece of an image row),
// so every fetched sector is used in full; what limits a copy is the bytes
// in flight per SM and how long the runs of one warp's access are. Keeping
// 3.35 TB/s busy at about 700 ns of DRAM latency takes about 18 KB in
// flight per SM (3.35 TB/s x 0.7 us / 132 SMs); one 4-byte load per
// thread, as the first version had, puts about 8 KB in flight.
//
// The design: one block moves a strip of K tiles side by side (one band of
// ts image rows, 128 pixels wide at ts = 16, 64 at ts = 32), all 3
// channels, through shared memory. Each thread issues its 6 float4 loads
// (2 per channel, 96 bytes in flight; about 120 KB per SM at the 5 blocks
// that its registers allow) before any store: a warp reads 512 contiguous
// bytes of one tile. After a barrier each thread writes 6 float4s of image
// rows: a warp writes 512 contiguous bytes of one row (256 at ts = 32). A
// first design without shared memory (one float4 of an image row per
// thread, reading 64-byte runs of 8 tiles) and a TMA design (one 5-D box
// load of a tile's 3 channels, one 3-D box store of ts x ts pixels) were
// slower; PERF.md has the times. ts is a template parameter, so every
// index is a shift or a mask. The image side is written as float4 where
// the wrapper says it is aligned (W % 4 == 0 and a 16-byte aligned
// output), else as 4 scalar stores, each cropped at W. A 1-D grid over the
// strips, so neither the image height nor the group count meets the grid's
// 65,535 limit in y and z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 3;

template <int TS>
struct Strip {
  static constexpr int K = 2048 / (TS * TS);    // tiles per strip: 8 or 2
  static constexpr int kWidth = K * TS;          // pixels: 128 or 64
  static constexpr int kRow = kWidth + 16;       // shared row, padded
  static constexpr int kTileQuads = TS * TS / 4; // float4s of a tile
  static constexpr int kRowQuads = kWidth / 4;
  static constexpr int kPer = kChannels * K * kTileQuads / kThreads;  // 6
};

template <int TS, bool kVecImage>
__global__ void __launch_bounds__(kThreads)
untile_chw_kernel(const float* __restrict__ tiles, int in_channels,
                  int group_tiles, int ntx, int strips_x, int height,
                  int width, float* __restrict__ out) {
  using S = Strip<TS>;
  __shared__ __align__(16) float strip[kChannels][TS][S::kRow];
  const int ty = blockIdx.x / strips_x;
  const int tx0 = (blockIdx.x - ty * strips_x) * S::K;
  const int64_t plane = (int64_t)group_tiles * TS * TS;
  // tile side: a warp reads 512 contiguous bytes of one tile and channel
  float4 v[S::kPer];
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const int f = threadIdx.x + r * kThreads;
    const int c = f / (S::K * S::kTileQuads);
    const int k = f / S::kTileQuads % S::K;
    const int q = f % S::kTileQuads;
    if (tx0 + k < ntx) {
      const int t = ty * ntx + tx0 + k;
      const int g = t / group_tiles, j = t - g * group_tiles;
      v[r] = __ldg(reinterpret_cast<const float4*>(
          tiles + ((int64_t)g * in_channels * group_tiles + j) * TS * TS +
          c * plane) + q);
    }
  }
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const int f = threadIdx.x + r * kThreads;
    const int c = f / (S::K * S::kTileQuads);
    const int k = f / S::kTileQuads % S::K;
    const int q = f % S::kTileQuads;
    if (tx0 + k < ntx)
      *reinterpret_cast<float4*>(
          &strip[c][q / (TS / 4)][k * TS + q % (TS / 4) * 4]) = v[r];
  }
  __syncthreads();
  // image side: a warp writes contiguous float4s of one row
  const int64_t hw = (int64_t)height * width;
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const int f = threadIdx.x + r * kThreads;
    const int c = f / (TS * S::kRowQuads);
    const int y = f / S::kRowQuads % TS;
    const int x4 = f % S::kRowQuads;
    const int yi = ty * TS + y, xi = tx0 * TS + x4 * 4;
    if (yi >= height || xi >= width) continue;
    const float4 w = *reinterpret_cast<const float4*>(&strip[c][y][x4 * 4]);
    float* o = out + c * hw + (int64_t)yi * width + xi;
    if (kVecImage) {
      *reinterpret_cast<float4*>(o) = w;
    } else {
      o[0] = w.x;
      if (xi + 1 < width) o[1] = w.y;
      if (xi + 2 < width) o[2] = w.z;
      if (xi + 3 < width) o[3] = w.w;
    }
  }
}

template <int TS>
void launch(bool vec_image, const float* tiles, int in_channels,
            int group_tiles, int ntx, int nty, int height, int width,
            float* out, cudaStream_t stream) {
  const int strips_x = (ntx + Strip<TS>::K - 1) / Strip<TS>::K;
  const int blocks = strips_x * nty;
  if (vec_image)
    untile_chw_kernel<TS, true><<<blocks, kThreads, 0, stream>>>(
        tiles, in_channels, group_tiles, ntx, strips_x, height, width, out);
  else
    untile_chw_kernel<TS, false><<<blocks, kThreads, 0, stream>>>(
        tiles, in_channels, group_tiles, ntx, strips_x, height, width, out);
}

}  // namespace

extern "C" {

// tiles (NG, in_channels, group_tiles, tile_size^2) f32, 16-byte aligned
// -> out (channels, height, width) f32, channels = 3, tile_size 16 or 32,
// height <= nty * tile_size, width <= ntx * tile_size; vec_image: width %
// 4 == 0 and out 16-byte aligned (the wrapper checks all of these).
int untile_chw(const float* tiles, int in_channels, int channels,
               int group_tiles, int ntx, int nty, int tile_size, int height,
               int width, int vec_image, float* out, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (channels != kChannels || in_channels < kChannels ||
      (tile_size != 16 && tile_size != 32))
    return (int)cudaErrorInvalidValue;
  if (ntx > 0 && nty > 0 && height > 0 && width > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (tile_size == 16)
      launch<16>(vec_image != 0, tiles, in_channels, group_tiles, ntx, nty,
                 height, width, out, st);
    else
      launch<32>(vec_image != 0, tiles, in_channels, group_tiles, ntx, nty,
                 height, width, out, st);
  }
  return (int)cudaGetLastError();
}

const char* untile_chw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
