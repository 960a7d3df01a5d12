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
// at NT = 65,856. P2: 64 threads, each owning 4 adjacent pixel lanes. Per
// chunk, 32 threads stage one window row each: only the 9 columns the body
// reads, as two float4 loads and a scalar, into 32 x 12 floats of shared
// memory (the neighbouring programs' windows overlap, so most of these
// reads come from L2). Each thread then walks the 32 rows, two per loop
// step, reading a row's 9 values as two broadcast float4s and a scalar
// that its 4 lanes share (as they share the loop and 2 r3); the scan is a
// running sum per lane, the clip and the max PTX's NaN-propagating max and
// min; the program's (8, 256) block is written as float4s. The operations
// count gives 29 per (row, lane) element (P2_OPS_PER_ELEMENT in
// ops/probe.py); in the SASS an element takes about 72 instructions (the
// first design's took 83), most of them in the IEEE expf (twice) and
// log1pf, edge-case branch included. So the SMs' issue rate bounds it, not
// the 0.6 GB it moves: chip_smoke counts the loop's instructions in the
// built kernel and gives that floor. 8 lanes per thread, one or four
// rows per loop step, or more registers were no faster. Built with
// -fmad=false so that its arithmetic rounds as the plain PyTorch
// version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 256;       // pixel lanes of one program
constexpr int kOutRows = 8;     // rows of one program's output block
constexpr int kG = 32;          // window rows of one chunk
constexpr int kRecCols = 128;   // columns of the record table

// max and min that return NaN when either input is NaN, as jnp / torch do
// (PTX's max.NaN / min.NaN, one instruction each; nvcc turns only some
// of the compare-and-select forms of them into one)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

constexpr int kLanes = 4;               // pixel lanes of one P2 thread
static_assert(kLanes % 4 == 0, "float4 stores");
constexpr int kWindowThreads = kPix / kLanes;
constexpr int kStaged = 12;             // floats staged per row: columns 0-8
static_assert(kG <= kWindowThreads, "a staging thread per window row");

__global__ void __launch_bounds__(kWindowThreads)
probe_window_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ rec, int mp,
                    float* __restrict__ out) {
  __shared__ float4 win[kG][kStaged / 4];
  const int t = blockIdx.x;
  const int start = starts[t];
  const int count = counts[t];
  const int astart = (start / 8) * 8;
  const int end = start - astart + count;
  const int nchunks = count == 0 ? 0 : (end + kG - 1) / kG;
  float px[kLanes], acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    px[l] = (float)(threadIdx.x * kLanes + l);
    acc[l] = 0.f;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < nchunks; ++i) {
    __syncthreads();   // the previous chunk's reads are done
    if (threadIdx.x < kG) {
      const int64_t row = (int64_t)astart + (int64_t)i * kG + threadIdx.x;
      float4 c0_3 = zero, c4_7 = zero;
      float c8 = 0.f;
      if (row < mp) {
        const float4* src =
            reinterpret_cast<const float4*>(rec + row * kRecCols);
        c0_3 = src[0];
        c4_7 = src[1];
        c8 = rec[row * kRecCols + 8];
      }
      win[threadIdx.x][0] = c0_3;
      win[threadIdx.x][1] = c4_7;
      win[threadIdx.x][2].x = c8;
    }
    __syncthreads();
    float s[kLanes], sum6[kLanes], sum7[kLanes], sum8[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s[l] = sum6[l] = sum7[l] = sum8[l] = 0.f;
#pragma unroll 2
    for (int r = 0; r < kG; ++r) {
      const float4 a = win[r][0];      // rec0-3: mean x, y, conic a, b
      const float4 b = win[r][1];      // rec4-7: conic c, opacity, payload
      const float c8 = win[r][2].x;    // rec8: payload
      const float two_b = 2.0f * a.w;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const float dx = px[l] - a.x;
        const float dy = px[l] - a.y;
        const float q = a.z * dx * dx + two_b * dx * dy + b.x * dy * dy;
        const float al = min_nan(max_nan(b.y * expf(-0.5f * q), 0.f), 0.99f);
        s[l] += max_nan(log1pf(-al), -30.f);  // inclusive scan over the rows
        const float wt = expf(s[l] - s[l]) * al;
        sum6[l] += wt * b.z;
        sum7[l] += wt * b.w;
        sum8[l] += wt * c8;
      }
    }
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] += sum6[l] + sum7[l] + sum8[l];
  }
  float4* o = reinterpret_cast<float4*>(out + (int64_t)t * (kOutRows * kPix)
                                        + threadIdx.x * kLanes);
#pragma unroll
  for (int r = 0; r < kOutRows; ++r) {
#pragma unroll
    for (int v = 0; v < kLanes / 4; ++v)
      o[r * (kPix / 4) + v] = make_float4(acc[4 * v], acc[4 * v + 1],
                                          acc[4 * v + 2], acc[4 * v + 3]);
  }
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

// starts, counts (nt,) i32; rec (mp, 128) f32, 16-byte aligned -> out
// (nt, 8, 256) f32.
int probe_window(const int* starts, const int* counts, const float* rec,
                 int nt, int mp, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nt > 0) {
    probe_window_kernel<<<nt, kWindowThreads, 0, (cudaStream_t)stream>>>(
        starts, counts, rec, mp, out);
  }
  return (int)cudaGetLastError();
}

const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
