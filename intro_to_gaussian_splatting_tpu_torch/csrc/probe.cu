// The probe kernels P1 and P2 for Hopper (sm_90a).
//
// They replace the two Pallas probes of scripts/probe_kernel.py:
//   P1 `probe1` (pallas_call at :36, body :31-32): a grid of NT programs,
//      each writing one (8, 256) f32 block of zeros, the floor of the
//      per-program cost;
//   P2 `probe2` (pallas_call at :102, body :55-94): per program t, chunks
//      of a G = 32-row window of a (MP, 128) f32 record table starting at
//      astart = (starts[t] / 8) * 8, nchunks = 0 if counts[t] == 0 else
//      cdiv(starts[t] - astart + counts[t], G). For 256 pixel lanes, each
//      chunk computes the alpha a = clip(rec5 * exp(-0.5 q), 0, 0.99) with
//      q from rec0-4, s = max(log1p(-a), -30) scanned (inclusive) over the
//      32 rows, T = exp(s - s), w = T a, and adds sum_rows w rec6 +
//      sum_rows w rec7 + sum_rows w rec8 to the lane's sum; the (1, 256)
//      sum is broadcast over the program's (8, 256) output block.
//
// As the probe measures them, P2 keeps: every chunk reads and sums all 32
// rows of its window, including rows before starts[t] and past counts[t]
// (no mask); the scan feeds T = exp(s - s), which is 1 for every finite s
// but is computed (nvcc without fast-math does not fold s - s). The clip
// and the max propagate NaN, as jnp.clip / jnp.maximum and torch do. Rows
// past the table's end read as 0 (the TPU's DMA would fault on them; the
// probe's own inputs never reach them). starts and counts are >= 0.
//
// Design. One block per program (the TPU's sequential grid becomes NT
// independent blocks). P1: 256 threads, each storing two float4 of zeros,
// so each warp writes 512 contiguous bytes; bound by the 539.5 MB it writes
// at NT = 65,856. P2: 256 threads, one per pixel lane; the 32 x 128 window
// (16 KB) is staged in shared memory with coalesced float4 loads (the
// neighbouring programs' windows overlap, so most of these reads come from
// L2), then each thread walks the 32 rows in registers, the scan a running
// sum. 29 operations per (row, lane) element (P2_OPS_PER_ELEMENT in
// ops/probe.py): at the probe's inputs operations bind it (15.6 GFLOP
// against 0.6 GB moved). Built with -fmad=false so that its arithmetic
// rounds as the plain PyTorch version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 256;       // pixel lanes of one program
constexpr int kOutRows = 8;     // rows of one program's output block
constexpr int kG = 32;          // window rows of one chunk
constexpr int kRecCols = 128;   // columns of the record table

// clip and max that return NaN for a NaN input, as jnp / torch do
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kPix)
probe_zero_kernel(float* __restrict__ out) {
  float4* block = reinterpret_cast<float4*>(
      out + (int64_t)blockIdx.x * (kOutRows * kPix));
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kOutRows * kPix / 4 / kPix; ++k) {
    block[k * kPix + threadIdx.x] = zero;
  }
}

__global__ void __launch_bounds__(kPix)
probe_window_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ rec, int mp,
                    float* __restrict__ out) {
  __shared__ float4 win[kG * kRecCols / 4];
  const int t = blockIdx.x;
  const int start = starts[t];
  const int count = counts[t];
  const int astart = (start / 8) * 8;
  const int end = start - astart + count;
  const int nchunks = count == 0 ? 0 : (end + kG - 1) / kG;
  const float px = (float)threadIdx.x;
  float acc = 0.f;
  for (int i = 0; i < nchunks; ++i) {
    __syncthreads();   // the previous chunk's reads are done
    const int64_t row0 = (int64_t)astart + (int64_t)i * kG;
    const float4* src =
        reinterpret_cast<const float4*>(rec + row0 * kRecCols);
    for (int k = threadIdx.x; k < kG * kRecCols / 4; k += kPix) {
      const int64_t row = row0 + k / (kRecCols / 4);
      win[k] = row < mp ? src[k] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const float* w = reinterpret_cast<const float*>(win);
    float s = 0.f, sum6 = 0.f, sum7 = 0.f, sum8 = 0.f;
    for (int r = 0; r < kG; ++r) {
      const float* rw = w + r * kRecCols;
      const float dx = px - rw[0];
      const float dy = px - rw[1];
      const float q = rw[2] * dx * dx + 2.0f * rw[3] * dx * dy
                      + rw[4] * dy * dy;
      const float a = clip_nan(rw[5] * expf(-0.5f * q), 0.f, 0.99f);
      const float l = log1pf(-a);
      s += l < -30.f ? -30.f : l;   // inclusive scan over the rows
      const float wt = expf(s - s) * a;
      sum6 += wt * rw[6];
      sum7 += wt * rw[7];
      sum8 += wt * rw[8];
    }
    acc += sum6 + sum7 + sum8;
  }
  float* o = out + (int64_t)t * (kOutRows * kPix);
#pragma unroll
  for (int r = 0; r < kOutRows; ++r) o[r * kPix + threadIdx.x] = acc;
}

}  // namespace

extern "C" {

// out (nt, 8, 256) f32 <- 0.
int probe_zero(float* out, int nt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nt > 0) {
    probe_zero_kernel<<<nt, kPix, 0, (cudaStream_t)stream>>>(out);
  }
  return (int)cudaGetLastError();
}

// starts, counts (nt,) i32; rec (mp, 128) f32 -> out (nt, 8, 256) f32.
int probe_window(const int* starts, const int* counts, const float* rec,
                 int nt, int mp, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nt > 0) {
    probe_window_kernel<<<nt, kPix, 0, (cudaStream_t)stream>>>(
        starts, counts, rec, mp, out);
  }
  return (int)cudaGetLastError();
}

const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
