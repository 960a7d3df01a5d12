// Channel-major image -> tile-group layout for Hopper (sm_90a): kernel
// B5-tile of the port, the gradient of B5-untile.
//
// Replaces the TPU kernel `_tile_kernel` (`_tile_impl`, the VJP of
// `untile_chw_fast`) of intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py.
// It computes the adjoint of `untile_chw` restricted to the first 3
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
// image read once, the C-channel tile layout written once: about 546 MB at
// 5068 x 3324 with C = 5). One block per (tile slot, channel), one thread
// per pixel of the tile: each block writes one contiguous run of ts*ts
// floats, and each warp reads two runs of ts contiguous floats of image
// rows, so every fetched sector is used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tile_chw_kernel(const float* __restrict__ img, int channels,
                                int group_tiles, int ntx, int num_tiles,
                                int tile_size, int height, int width,
                                float* __restrict__ out) {
  // grid: x = tile slot within the group, y = output channel, z = group
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const int g = blockIdx.z;
  const int p = threadIdx.x;
  const int t = g * group_tiles + j;
  const int pix = tile_size * tile_size;
  float v = 0.0f;
  if (c < channels && t < num_tiles) {
    const int y = (t / ntx) * tile_size + p / tile_size;
    const int x = (t % ntx) * tile_size + p % tile_size;
    if (y < height && x < width)
      v = img[((int64_t)c * height + y) * width + x];
  }
  out[(((int64_t)g * gridDim.y + c) * group_tiles + j) * pix + p] = v;
}

}  // namespace

extern "C" {

// img (channels, height, width) f32 -> out
// (num_groups, out_channels, group_tiles, tile_size^2) f32.
int tile_chw(const float* img, int channels, int out_channels, int num_groups,
             int group_tiles, int ntx, int nty, int tile_size, int height,
             int width, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_groups > 0 && out_channels > 0 && group_tiles > 0) {
    const dim3 grid(group_tiles, out_channels, num_groups);
    tile_chw_kernel<<<grid, tile_size * tile_size, 0,
                      (cudaStream_t)stream>>>(
        img, channels, group_tiles, ntx, ntx * nty, tile_size, height, width,
        out);
  }
  return (int)cudaGetLastError();
}

const char* tile_chw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
