// Tile-group layout -> channel-major image for Hopper (sm_90a): kernel
// B5-untile of the port.
//
// Replaces the TPU kernel `_untile_kernel` (`_untile_impl`, entry point
// `untile_chw_fast`) of intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py.
// It computes the same permutation as `untile_chw`:
//     out[c, y, x] = tiles[g, c, j, (y % ts) * ts + x % ts]
// with tile t = (y / ts) * ntx + x / ts = g * GT + j, cropped to H x W, for
// the first `channels` channels of a (NG, in_channels, GT, ts*ts) input.
// The TPU version's 4-channel padding was a DMA-alignment need and is gone:
// the kernel reads the rasterizer's 5-channel output in place.
//
// What bounds it on an H100: it is a copy, bound by bytes (3 channels read
// and written once, about 405 MB at 5068 x 3324). One thread per output
// element; a block covers a run of one image row, so writes coalesce along
// W, and each warp's reads are runs of ts contiguous floats of one tile
// row, so every fetched sector is used. No shared memory is needed for
// that. The grid spans (W / 256, H, C), so the per-element index
// arithmetic stays in 32 bits, with no 64-bit division; the image height is
// limited to the grid's 65,535 in y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void untile_chw_kernel(const float* __restrict__ tiles,
                                  int in_channels, int group_tiles, int ntx,
                                  int tile_size, int height, int width,
                                  float* __restrict__ out) {
  // grid: x over W in blocks of blockDim.x, y = image row, z = channel
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= width) return;
  const int y = blockIdx.y;
  const int c = blockIdx.z;
  const int t = (y / tile_size) * ntx + x / tile_size;
  const int g = t / group_tiles;
  const int j = t - g * group_tiles;
  const int p = (y % tile_size) * tile_size + x % tile_size;
  const int64_t pix = (int64_t)tile_size * tile_size;
  out[((int64_t)c * height + y) * width + x] =
      tiles[(((int64_t)g * in_channels + c) * group_tiles + j) * pix + p];
}

}  // namespace

extern "C" {

// tiles (NG, in_channels, group_tiles, tile_size^2) f32 -> out
// (channels, height, width) f32.
int untile_chw(const float* tiles, int in_channels, int channels,
               int group_tiles, int ntx, int tile_size, int height,
               int width, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  if (channels > 0 && height > 0 && width > 0) {
    const dim3 grid((width + threads - 1) / threads, height, channels);
    untile_chw_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        tiles, in_channels, group_tiles, ntx, tile_size, height, width, out);
  }
  return (int)cudaGetLastError();
}

const char* untile_chw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
