// Segmented sums of the pair gather's gradient for Hopper (sm_90a): kernel
// G1 of the port, the backward of `_GatherPairs` (ops/binning.py).
//
// It replaces no Pallas kernel. The JAX package's transpose of the same
// gather, `_gather_pairs_fm_bwd` (intro_to_gaussian_splatting_tpu/ops/
// binning.py), is XLA ops: stable sorts back to emission order and a
// two-level running sum over the whole pair pool. The port's plain version
// (`gather_pairs_backward_reference`) does the same with library calls: a
// 10-row gather, a scatter to emission order, a pad and two scans over all
// MP slots, then a scatter to the gaussians' order. G1 computes the same
// function over the emitted pairs alone, in the gaussians' own order:
//     d[r, order[i]] = sum over e in [lo[i], hi[i]) of g[r, s(e)]
// for the 10 record rows that carry a pair gradient (0-5, 11-14), and
// exact zeros in the other 6 rows and for gaussians with no pairs. g is
// the (16, MP) gradient of the records in sorted-pair order, as the
// rasterizer backward writes it; order is the depth argsort, a permutation
// of [0, n): depth rank i is gaussian order[i]; [lo[i], hi[i]) is depth
// rank i's block of emission slots; s(e) is the sorted slot of emission
// slot e, the inverse of the tile sort's permutation over the emitted
// prefix (perm[s] = e for s < total_emit: the sort is stable and sentinel
// keys sort last, so perm[:total_emit] is a permutation of [0,
// total_emit)).
//
// Why the gaussians' order: the records are gathered by order and then by
// the pairs' ranks inside one autograd node, so autograd never
// differentiates `records[:, order]` on its own. Its backward was
// PyTorch's accumulating index_put_ (a fill, a sort of the indices and
// `indexing_backward_kernel`), 14.9 ms a step at 3.1M gaussians, for a
// permutation whose gradient has one term per target. G1 writes each sum
// straight to its gaussian: the same values, taken in the same order.
//
// What bounds it on an H100: bytes. The function reads the 10 gradient
// rows of the emitted slots, 40 B a pair, and perm, 8 B a pair; per
// gaussian it reads order, lo and hi and writes 16 floats: about 1.4 GB at
// the training benchmark's 29M pairs, 0.42 ms at 3.35 TB/s (1.6 GB, 0.47
// ms, at 27.2M pairs of 3.1M gaussians). The order of
// the reads is the hard part: a gaussian's pairs lie one per tile, far
// apart in sorted order and in 10 rows, so summing them where they lie
// reads one 32-byte sector for each 4-byte value. A first design did just
// that (one warp per gaussian reading through the inverse permutation,
// gaussians in depth order for L2 reuse): 8.45 ms at 29M pairs, about
// 1.1 TB/s of sectors (PERF.md).
//
// The design: two passes, each of them coalesced on one side. The first
// (four threads per emitted sorted slot, one per float4) reads the 10 rows
// of its slots, each warp 32 contiguous bytes a row, and writes them as
// one 64-byte record, 16 floats, to emission slot perm[s] of a pair-major
// scratch: one whole pair of sectors per pair, written by one request,
// the only scattered access. In the scratch each gaussian's pairs are one
// contiguous run. The second pass gives each gaussian a warp, eight to a
// block, and reads the run as float4s, 512 contiguous bytes a warp per
// step: lane l takes float4 l % 4 (4 of the 16 columns) of the pairs
// lo + l / 4, lo + l / 4 + 8, ... in order, the lanes of one column group
// are added with xor shuffles at offsets 16, 8, 4, and lane r writes row
// r. Pass bytes: 48 B a pair read and 64 B written by the first, 64 B
// read by the second.
//
// The output order. The second pass's warps walk the gaussians, not the
// depth ranks: warp j writes column j, so a block's eight warps fill each
// of the 16 rows' 32-byte sectors whole, as a rank-ordered output did. A
// first kernel hands each gaussian its block, blocks[order[i]] = (lo[i],
// hi[i]) as two ints, N scattered 8-byte stores, and the second pass reads
// them in order. At 3.1M gaussians and 27.2M pairs (PERF.md) G1 takes
// about 2.67 ms against 2.59 when it wrote by rank; warps by rank writing
// column order[i] (16 scattered 4-byte stores a gaussian) took 5.40, and
// warps by gaussian reading lo and hi through the inverse order 2.85.
//
// One algorithm serves every pair count, from about one pair per gaussian
// to max_span^2. Every sum is taken in an order fixed by the gaussian's own
// pair count, with no float atomics, so the gradient is the same bit for
// bit from run to run and whatever the pool's size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;          // record rows (ops/projection.py REC_*)
constexpr int kGrads = 10;         // rows that carry a pair gradient
// bit mask of ops/projection.py GRAD_ROWS, which the wrapper passes
constexpr int kGradRowsMask = 0x783f;
constexpr int kPairFloats = 16;    // a pair's record in the scratch: 64 B
constexpr int kWarps = 8;          // gaussians per block of the sums
constexpr int kThreads = 32 * kWarps;
constexpr int kScatterThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// the record row of gradient term k: mean x, y, conic a, b, c, opacity
// (rows 0-5), then r, g, b, depth (rows 11-14)
__device__ __forceinline__ int grad_row(int k) { return k < 6 ? k : k + 5; }

// the gradient term of record row r, or -1
__device__ __forceinline__ int grad_term(int r) {
  if (r < 6) return r;
  if (r >= 11 && r <= 14) return r - 5;
  return -1;
}

// pass 1: sorted slot s's 10 gradient values -> emission slot perm[s] of
// the pair-major scratch, terms in columns 0-9, zeros in 10-15. Four
// threads a slot, one per float4 of its record: the four lanes write the
// record's 64 bytes in one store instruction, so every sector is written
// whole by one request (one thread writing all four float4s sends each
// sector in two halves, a store apart: 4.64 ms at 29M pairs against
// this design's figure in PERF.md).
__global__ void __launch_bounds__(kScatterThreads)
to_emission_kernel(const float* __restrict__ g, int64_t mp,
                   const int64_t* __restrict__ perm, int total_emit,
                   float4* __restrict__ scratch) {
  const int64_t t = (int64_t)blockIdx.x * kScatterThreads + threadIdx.x;
  const int64_t s = t >> 2;
  const int quad = (int)(t & 3);
  if (s >= total_emit) return;
  const int64_t e = perm[s];
  if (e < 0 || e >= total_emit) return;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = 4 * quad + c;
    v[c] = k < kGrads ? __ldg(g + grad_row(k) * mp + s) : 0.0f;
  }
  scratch[e * (kPairFloats / 4) + quad] = make_float4(v[0], v[1], v[2], v[3]);
}

// each depth rank's block to its gaussian: blocks[order[i]] = (lo, hi);
// order is a permutation, so every gaussian's block is written once
__global__ void __launch_bounds__(kScatterThreads)
blocks_by_gaussian_kernel(const int64_t* __restrict__ order,
                          const int64_t* __restrict__ lo,
                          const int64_t* __restrict__ hi, int n,
                          int2* __restrict__ blocks) {
  const int i = blockIdx.x * kScatterThreads + threadIdx.x;
  if (i >= n) return;
  blocks[order[i]] = make_int2((int)lo[i], (int)hi[i]);
}

// pass 2: one warp per gaussian sums its contiguous run of the scratch
__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const float4* __restrict__ scratch,
                    const int2* __restrict__ blocks, int n,
                    float* __restrict__ d) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= n) return;  // the whole warp: j is the warp's
  const int2 block = blocks[j];
  const int first = block.x, end = block.y;
  const int quad = lane & 3;  // columns 4 * quad .. 4 * quad + 3
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int e = first + (lane >> 2); e < end; e += 8) {
    const float4 v = __ldg(scratch + (int64_t)e * (kPairFloats / 4) + quad);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
#pragma unroll
  for (int offset = 16; offset >= 4; offset >>= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, offset);
    acc.y += __shfl_xor_sync(kFull, acc.y, offset);
    acc.z += __shfl_xor_sync(kFull, acc.z, offset);
    acc.w += __shfl_xor_sync(kFull, acc.w, offset);
  }
  // lane r < 16 writes row r: term k sits in lane k / 4, component k % 4
  const int k = grad_term(lane < kRows ? lane : kRows);
  const int from = k >= 0 ? k >> 2 : 0;
  const float x = __shfl_sync(kFull, acc.x, from);
  const float y = __shfl_sync(kFull, acc.y, from);
  const float z = __shfl_sync(kFull, acc.z, from);
  const float w = __shfl_sync(kFull, acc.w, from);
  if (lane < kRows) {
    const int c = k & 3;
    const float v = k < 0 ? 0.0f : c == 0 ? x : c == 1 ? y : c == 2 ? z : w;
    d[(int64_t)lane * n + j] = v;
  }
}

}  // namespace

extern "C" {

// g (16, mp) f32 in sorted-pair order; order (n,) int64, the depth
// argsort, a permutation of [0, n); perm (mp,) int64, the tile sort's
// permutation (sorted slot s came from emission slot perm[s]); lo, hi
// (n,) int64 emission blocks of the depth ranks within [0, total_emit];
// scratch (total_emit, 16) f32, 16-byte aligned; blocks (n, 2) int32
// scratch, 8-byte aligned -> d (16, n) f32 in the gaussians' order.
// total_emit <= mp <= 2^31 - 32; the wrapper checks shapes, types and
// devices.
int segment_sums(const float* g, long long mp, const int64_t* order,
                 const int64_t* perm, const int64_t* lo, const int64_t* hi,
                 int n, int total_emit, int grad_rows_mask, float* scratch,
                 int* blocks, float* d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (grad_rows_mask != kGradRowsMask || total_emit < 0 || n < 0 ||
      total_emit > mp)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float4* pairs = reinterpret_cast<float4*>(scratch);
  const int64_t quads = 4 * (int64_t)total_emit;
  if (total_emit > 0)
    to_emission_kernel<<<(unsigned)((quads + kScatterThreads - 1) /
                                    kScatterThreads),
                         kScatterThreads, 0, st>>>(g, (int64_t)mp, perm,
                                                   total_emit, pairs);
  if (n > 0) {
    int2* by_gaussian = reinterpret_cast<int2*>(blocks);
    blocks_by_gaussian_kernel<<<(n + kScatterThreads - 1) / kScatterThreads,
                                kScatterThreads, 0, st>>>(order, lo, hi, n,
                                                          by_gaussian);
    segment_sums_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        pairs, by_gaussian, n, d);
  }
  return (int)cudaGetLastError();
}

const char* segment_sums_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
