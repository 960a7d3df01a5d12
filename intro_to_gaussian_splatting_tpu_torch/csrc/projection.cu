// The projection of the gaussians for Hopper (sm_90a): kernels J1 (the
// forward) and J2 (its backward) of the port, the card's path of
// `project_gaussians` (ops/projection.py).
//
// They replace no Pallas kernel. The JAX package's `ops/projection.py` is
// XLA ops, which XLA fuses; the port's plain version,
// `project_gaussians_reference`, is the same chain of elementwise PyTorch
// operations, and on the card each of them is a kernel launch: about 368
// launches a view, and several hundred more for autograd's backward of
// them. J1 computes every output of the plain version for one gaussian in
// one thread: the view and clip affines, the covariance from the
// quaternion and the scales, the EWA Jacobian and the conic, the
// eigenvalue radius, the colour (raw RGB, or SH up to degree 3 along the
// normalized view direction), the opacity sigmoid and the valid mask. J2
// is the exact vector-Jacobian product of that function: one thread per
// gaussian recomputes the forward from the saved inputs and runs it in
// reverse, with PyTorch's masks (a clamp passes the gradient where
// min <= x <= max, a `torch.where` guard where it kept its input, the
// determinant's and the colour's clamps likewise), and writes the
// gradient of each parameter, exact zeros for the SH coefficients above
// the active degree. Each gaussian's gradient is written by one thread,
// with no atomics, so it is the same bit for bit from run to run. In one
// place J2 departs from the plain chain's VJP: for a round gaussian (all
// three scales equal) it writes exact zeros into the quaternion's
// gradient, the true derivative, where autograd through the chain leaves
// zeros and float32 rounding noise (see project_bwd below).
//
// J1 does each operation of the plain version in its order, in float32,
// with -fmad=false and IEEE division and square root (nvcc's defaults), so
// it rounds as the chain of library kernels does; the 3- and 4-term norms
// add their squares in the order of PyTorch's reduction kernel on the card
// (two lanes: x0 + x2, then + x1; four lanes: (x0 + x2) + (x1 + x3)).
//
// What bounds them on an H100: first the launch itself, then bytes. J1
// reads 237 B a gaussian at SH degree 3 (means 12, scales 12, quaternion
// 16, opacity 4, 48 SH coefficients 192, active 1) and writes 45 B: 14.8
// MB for a 52,363-gaussian view, 4.4 us at 3.35 TB/s, and its 363
// operations a gaussian take under a microsecond of the float32 rate. J2
// reads the inputs and 40 B of cotangents and writes 236 B of gradients,
// about 513 B a slot. The camera (39 floats, read from its device
// tensors, never through the host) is staged once per block in shared
// memory. The SH rows are the large, strided part: each thread reads its
// gaussian's 192-byte row, 6 whole 32-byte sectors, so no sector is
// fetched for a value no thread uses, though a warp's load instruction
// touches 32 rows; the L1 holds the rows between a thread's loads. A
// warp-cooperative load through shared memory is the next step if a trace
// shows the L1 under pressure.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCamFloats = 39;  // world2view 16, full_proj 16, fx, fy,
                                // tan_fovx, tan_fovy, cam_center 3
constexpr int kW2V = 0, kFP = 16, kFX = 32, kFY = 33, kTFX = 34, kTFY = 35,
              kCC = 36;

// the 3DGS basis constants of models/sh.py, rounded to float32 as PyTorch
// rounds a Python float that multiplies a float32 tensor
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

struct Params {
  const float* means;   // (n, 3)
  const float* scales;  // (n, 3) log scales
  const float* quats;   // (n, 4) wxyz
  const float* logits;  // (n,)
  const float* sh;      // (n, k, 3)
  int n, k;
  // the cameras' device tensors
  const float *w2v, *fp, *fx, *fy, *tfx, *tfy, *cc;
  float min_z, ewa_clamp, det_clamp, eig_floor, radius_sigmas, dilation;
  float width_m1, height_m1;  // (width - 1), (height - 1)
  int double_sigmoid;
};

__device__ __forceinline__ void load_camera(const Params& p, float* cam) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam[kW2V + t] = p.w2v[t];
    cam[kFP + t] = p.fp[t];
  } else if (t < 19) {
    cam[kCC + t - 16] = p.cc[t - 16];
  } else if (t == 19) {
    cam[kFX] = *p.fx;
  } else if (t == 20) {
    cam[kFY] = *p.fy;
  } else if (t == 21) {
    cam[kTFX] = *p.tfx;
  } else if (t == 22) {
    cam[kTFY] = *p.tfy;
  }
  __syncthreads();
}

// mx * m[0, col] + my * m[1, col] + mz * m[2, col] + m[3, col]
__device__ __forceinline__ float affine(const float* m, int col, float x,
                                       float y, float z) {
  return ((x * m[col] + y * m[4 + col]) + z * m[8 + col]) + m[12 + col];
}

// torch.where(torch.abs(v) < 1e-8, 1e-8, v)
__device__ __forceinline__ float safe(float v) {
  return fabsf(v) < 1e-8f ? 1e-8f : v;
}

// torch.clamp(v, lo, hi): NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp(v, min=lo)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// torch.sigmoid on the card
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Everything of one gaussian that the outputs and J2 need: the forward in
// the plain version's order.
struct Fwd {
  float mx, my, mz;
  float xv, yv, z;             // view space; z is the depth
  float cw, wsafe, u, v;       // clip w, its guard, the NDC x and y
  float q[4], qn, qw, qx, qy, qz;
  float r[9], e[3];
  float sxx, sxy, sxz, syy, syz, szz;
  float zsafe, limx, limy, tx, ty, cx, cy, x, y, inv_z, inv_z2;
  float t02, t12;              // -fx * x, -fy * y
  float m0[3], m1[3];
  float a, b, c, det, dc;
};

__device__ __forceinline__ void forward(const Params& p, const float* cam,
                                        int64_t i, Fwd& f) {
  const float* W = cam + kW2V;
  const float* F = cam + kFP;
  f.mx = p.means[3 * i];
  f.my = p.means[3 * i + 1];
  f.mz = p.means[3 * i + 2];
  f.xv = affine(W, 0, f.mx, f.my, f.mz);
  f.yv = affine(W, 1, f.mx, f.my, f.mz);
  f.z = affine(W, 2, f.mx, f.my, f.mz);
  f.cw = affine(F, 3, f.mx, f.my, f.mz);
  f.wsafe = safe(f.cw);
  f.u = affine(F, 0, f.mx, f.my, f.mz) / f.wsafe;
  f.v = affine(F, 1, f.mx, f.my, f.mz) / f.wsafe;

  // covariance_3d_channels
#pragma unroll
  for (int j = 0; j < 4; ++j) f.q[j] = p.quats[4 * i + j];
  f.qn = sqrtf((f.q[0] * f.q[0] + f.q[2] * f.q[2])
               + (f.q[1] * f.q[1] + f.q[3] * f.q[3]));
  f.qw = f.q[0] / f.qn;
  f.qx = f.q[1] / f.qn;
  f.qy = f.q[2] / f.qn;
  f.qz = f.q[3] / f.qn;
  const float w = f.qw, x = f.qx, y = f.qy, z = f.qz;
  f.r[0] = 1.0f - 2.0f * (y * y + z * z);
  f.r[1] = 2.0f * (x * y - w * z);
  f.r[2] = 2.0f * (x * z + w * y);
  f.r[3] = 2.0f * (x * y + w * z);
  f.r[4] = 1.0f - 2.0f * (x * x + z * z);
  f.r[5] = 2.0f * (y * z - w * x);
  f.r[6] = 2.0f * (x * z - w * y);
  f.r[7] = 2.0f * (y * z + w * x);
  f.r[8] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int j = 0; j < 3; ++j) f.e[j] = expf(2.0f * p.scales[3 * i + j]);
  const float* r = f.r;
  const float* e = f.e;
#define SIGMA(A, B)                                                      \
  ((r[3 * A] * r[3 * B] * e[0] + r[3 * A + 1] * r[3 * B + 1] * e[1])     \
   + r[3 * A + 2] * r[3 * B + 2] * e[2])
  f.sxx = SIGMA(0, 0);
  f.sxy = SIGMA(0, 1);
  f.sxz = SIGMA(0, 2);
  f.syy = SIGMA(1, 1);
  f.syz = SIGMA(1, 2);
  f.szz = SIGMA(2, 2);
#undef SIGMA

  // EWA: M = J W, the 2D covariance M Sigma M^T
  f.zsafe = safe(f.z);
  f.limx = p.ewa_clamp * cam[kTFX];
  f.limy = p.ewa_clamp * cam[kTFY];
  f.tx = f.xv / f.zsafe;
  f.ty = f.yv / f.zsafe;
  f.cx = clamp2(f.tx, -f.limx, f.limx);
  f.cy = clamp2(f.ty, -f.limy, f.limy);
  f.x = f.cx * f.z;
  f.y = f.cy * f.z;
  const float fx = cam[kFX], fy = cam[kFY];
  f.inv_z = 1.0f / f.zsafe;
  f.inv_z2 = f.inv_z * f.inv_z;
  const float j00 = fx * f.inv_z;
  f.t02 = -fx * f.x;
  const float j02 = f.t02 * f.inv_z2;
  const float j11 = fy * f.inv_z;
  f.t12 = -fy * f.y;
  const float j12 = f.t12 * f.inv_z2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.m0[k] = j00 * W[4 * k] + j02 * W[4 * k + 2];
    f.m1[k] = j11 * W[4 * k + 1] + j12 * W[4 * k + 2];
  }
#define QUAD(U, V)                                                       \
  ((((U[0] * V[0] * f.sxx + U[1] * V[1] * f.syy) + U[2] * V[2] * f.szz)  \
    + (U[0] * V[1] + U[1] * V[0]) * f.sxy)                               \
   + (U[0] * V[2] + U[2] * V[0]) * f.sxz)                                \
      + (U[1] * V[2] + U[2] * V[1]) * f.syz
  f.a = (QUAD(f.m0, f.m0)) + p.dilation;
  f.b = QUAD(f.m0, f.m1);
  f.c = (QUAD(f.m1, f.m1)) + p.dilation;
#undef QUAD
  f.det = f.a * f.c - f.b * f.b;
  f.dc = clamp_min(f.det, p.det_clamp);
}

// The gaussian's SH coefficients up to degree DEG, (DEG + 1)^2 rows of 3.
template <int DEG>
struct Coeffs {
  static constexpr int kCount = (DEG + 1) * (DEG + 1);
  float v[kCount][3];
};

template <int DEG>
__device__ __forceinline__ void load_coeffs(const Params& p, int64_t i,
                                            Coeffs<DEG>& s) {
  const float* row = p.sh + i * (int64_t)p.k * 3;
#pragma unroll
  for (int j = 0; j < Coeffs<DEG>::kCount; ++j) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s.v[j][ch] = __ldg(row + 3 * j + ch);
  }
}

// The view direction of models/sh.py's eval_sh: (means - cam_center)
// normalized, the norm clamped at 1e-8.
struct Dir {
  float d[3], norm, nc, x, y, z;
};

__device__ __forceinline__ void direction(const Fwd& f, const float* cam,
                                          Dir& o) {
  o.d[0] = f.mx - cam[kCC];
  o.d[1] = f.my - cam[kCC + 1];
  o.d[2] = f.mz - cam[kCC + 2];
  o.norm = sqrtf((o.d[0] * o.d[0] + o.d[2] * o.d[2]) + o.d[1] * o.d[1]);
  o.nc = clamp_min(o.norm, 1e-8f);
  o.x = o.d[0] / o.nc;
  o.y = o.d[1] / o.nc;
  o.z = o.d[2] / o.nc;
}

// eval_sh's basis factors: term j of the colour is factor[j] * sh[j],
// added (sign +1) or subtracted (-1) in eval_sh's order
struct Basis {
  float xx, yy, zz, xy, yz, xz;
  float p6, p9, p11, p12, p13, p14, p15;  // the polynomials in brackets
  float f[16];
};

template <int DEG>
__device__ __forceinline__ void basis(const Dir& o, Basis& b) {
  const float x = o.x, y = o.y, z = o.z;
  if (DEG >= 1) {
    b.f[1] = C1 * y;
    b.f[2] = C1 * z;
    b.f[3] = C1 * x;
  }
  if (DEG >= 2) {
    b.xx = x * x;
    b.yy = y * y;
    b.zz = z * z;
    b.xy = x * y;
    b.yz = y * z;
    b.xz = x * z;
    b.p6 = (2.0f * b.zz - b.xx) - b.yy;
    b.f[4] = C2_0 * b.xy;
    b.f[5] = C2_1 * b.yz;
    b.f[6] = C2_2 * b.p6;
    b.f[7] = C2_3 * b.xz;
    b.f[8] = C2_4 * (b.xx - b.yy);
  }
  if (DEG >= 3) {
    b.p9 = 3.0f * b.xx - b.yy;
    b.p11 = (4.0f * b.zz - b.xx) - b.yy;
    b.p12 = (2.0f * b.zz - 3.0f * b.xx) - 3.0f * b.yy;
    b.p13 = (4.0f * b.zz - b.xx) - b.yy;
    b.p14 = b.xx - b.yy;
    b.p15 = b.xx - 3.0f * b.yy;
    b.f[9] = (C3_0 * y) * b.p9;
    b.f[10] = (C3_1 * b.xy) * z;
    b.f[11] = (C3_2 * y) * b.p11;
    b.f[12] = (C3_3 * z) * b.p12;
    b.f[13] = (C3_4 * x) * b.p13;
    b.f[14] = (C3_5 * z) * b.p14;
    b.f[15] = (C3_6 * x) * b.p15;
  }
}

// eval_sh before its + 0.5 and clamp, for one channel
template <int DEG>
__device__ __forceinline__ float sh_sum(const Coeffs<DEG>& s, const Basis& b,
                                        int ch) {
  float res = C0 * s.v[0][ch];
  if (DEG >= 1) {
    res = res - b.f[1] * s.v[1][ch];
    res = res + b.f[2] * s.v[2][ch];
    res = res - b.f[3] * s.v[3][ch];
  }
#pragma unroll
  for (int j = 4; j < Coeffs<DEG>::kCount; ++j) res = res + b.f[j] * s.v[j][ch];
  return res;
}

__device__ __forceinline__ float term_sign(int j) {
  return (j == 1 || j == 3) ? -1.0f : 1.0f;
}

// the covariance channels (xx, xy, xz, yy, yz, zz) as index pairs (a, b)
__host__ __device__ constexpr int chan_a(int ch) {
  return ch < 3 ? 0 : ch < 5 ? 1 : 2;
}
__host__ __device__ constexpr int chan_b(int ch) {
  return ch < 3 ? ch : ch < 5 ? ch - 2 : 2;
}

// The gradient of quad(u, v) = sum over the channels of
// (u_a v_b [+ u_b v_a]) * S_ab, scaled by g, into S and into u and v
// (which may be the same accumulator), product by product.
__device__ __forceinline__ void quad_backward(float g, const float* u,
                                              const float* v, const float* S,
                                              float* gS, float* gu,
                                              float* gv) {
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    const int a = chan_a(ch), b = chan_b(ch);
    const float gi = g * S[ch];
    if (a == b) {
      gS[ch] += g * (u[a] * v[a]);
      gu[a] += gi * v[a];
      gv[a] += gi * u[a];
    } else {
      gS[ch] += g * (u[a] * v[b] + u[b] * v[a]);
      gu[a] += gi * v[b];
      gv[b] += gi * u[a];
      gu[b] += gi * v[a];
      gv[a] += gi * u[b];
    }
  }
}

struct Out {
  float* mean2d;     // (n, 2)
  float* depth;      // (n,)
  float* conic;      // (n, 3)
  float* radius;     // (n,)
  float* color;      // (n, 3)
  float* opacity;    // (n,)
  uint8_t* valid;    // (n,) bool
};

// J1. DEG < 0: raw RGB colour (sh[:, 0]); else SH to degree DEG.
template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(Params p, const uint8_t* __restrict__ active, Out o) {
  __shared__ float cam[kCamFloats];
  load_camera(p, cam);
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  Fwd f;
  forward(p, cam, i, f);
  o.mean2d[2 * i] = ((f.u + 1.0f) * p.width_m1) * 0.5f;
  o.mean2d[2 * i + 1] = ((f.v + 1.0f) * p.height_m1) * 0.5f;
  o.depth[i] = f.z;
  o.conic[3 * i] = f.c / f.dc;
  o.conic[3 * i + 1] = (-f.b) / f.dc;
  o.conic[3 * i + 2] = f.a / f.dc;
  const float mid = 0.5f * (f.a + f.c);
  const float disc = clamp_min(mid * mid - f.det, p.eig_floor);
  const float lam_max = mid + sqrtf(disc);
  const float rad =
      ceilf(p.radius_sigmas * sqrtf(clamp_min(lam_max, 0.0f)));

  if (DEG < 0) {
    const float* row = p.sh + i * (int64_t)p.k * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o.color[3 * i + ch] = __ldg(row + ch);
  } else {
    constexpr int D = DEG < 0 ? 0 : DEG;
    Coeffs<D> s;
    load_coeffs<D>(p, i, s);
    Dir dir;
    direction(f, cam, dir);
    Basis b;
    basis<D>(dir, b);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      o.color[3 * i + ch] = clamp_min(sh_sum<D>(s, b, ch) + 0.5f, 0.0f);
  }

  float op = sigmoid(p.logits[i]);
  if (p.double_sigmoid) op = sigmoid(op);
  o.opacity[i] = op;
  const bool valid = f.z >= p.min_z && active[i] != 0 && rad > 0.0f;
  o.valid[i] = valid;
  o.radius[i] = valid ? rad : 0.0f;
}

struct Cot {          // the outputs' cotangents; a null pointer reads as 0
  const float* mean2d;
  const float* depth;
  const float* conic;
  const float* color;
  const float* opacity;
};

struct Grad {
  float* means;
  float* scales;
  float* quats;
  float* logits;
  float* sh;          // (n, k, 3), every coefficient written
};

__device__ __forceinline__ float cot(const float* g, int64_t idx) {
  return g ? g[idx] : 0.0f;
}

// J2: the vector-Jacobian product of J1's function.
template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(Params p, Cot g, Grad d) {
  __shared__ float cam[kCamFloats];
  load_camera(p, cam);
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const float* W = cam + kW2V;
  const float* F = cam + kFP;
  Fwd f;
  forward(p, cam, i, f);
  float gm[3] = {0.0f, 0.0f, 0.0f};  // d means

  // colour
  float* gsh = d.sh + i * (int64_t)p.k * 3;
  const int k3 = 3 * p.k;
  if (DEG < 0) {
    for (int j = 0; j < k3; ++j) gsh[j] = j < 3 ? cot(g.color, 3 * i + j) : 0.0f;
  } else {
    constexpr int D = DEG < 0 ? 0 : DEG;
    constexpr int K = Coeffs<D>::kCount;
    Coeffs<D> s;
    load_coeffs<D>(p, i, s);
    Dir dir;
    direction(f, cam, dir);
    Basis b;
    basis<D>(dir, b);
    float gres[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // clamp(result + 0.5, min=0) passes where result + 0.5 >= 0
      const float r = sh_sum<D>(s, b, ch) + 0.5f;
      gres[ch] = r >= 0.0f ? cot(g.color, 3 * i + ch) : 0.0f;
      gsh[ch] = gres[ch] * C0;
    }
    float gf[16];
#pragma unroll
    for (int j = 1; j < K; ++j) {
      const float sg = term_sign(j);
      float acc = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float gt = sg * gres[ch];
        gsh[3 * j + ch] = gt * b.f[j];
        acc = acc + gt * s.v[j][ch];
      }
      gf[j] = acc;
    }
    for (int j = 3 * K; j < k3; ++j) gsh[j] = 0.0f;
    if (D >= 1) {
      float gx = gf[3] * C1, gy = gf[1] * C1, gz = gf[2] * C1;
      if (D >= 2) {
        float gxx = 0.0f, gyy = 0.0f, gzz = 0.0f;
        float gxy = gf[4] * C2_0, gyz = gf[5] * C2_1, gxz = gf[7] * C2_3;
        const float g6 = gf[6] * C2_2;
        gzz += 2.0f * g6;
        gxx -= g6;
        gyy -= g6;
        const float g8 = gf[8] * C2_4;
        gxx += g8;
        gyy -= g8;
        if (D >= 3) {
          const float x = dir.x, y = dir.y, z = dir.z;
          gy += (gf[9] * b.p9) * C3_0;
          const float g9 = gf[9] * (C3_0 * y);
          gxx += 3.0f * g9;
          gyy -= g9;
          gxy += (gf[10] * z) * C3_1;
          gz += gf[10] * (C3_1 * b.xy);
          gy += (gf[11] * b.p11) * C3_2;
          const float g11 = gf[11] * (C3_2 * y);
          gzz += 4.0f * g11;
          gxx -= g11;
          gyy -= g11;
          gz += (gf[12] * b.p12) * C3_3;
          const float g12 = gf[12] * (C3_3 * z);
          gzz += 2.0f * g12;
          gxx -= 3.0f * g12;
          gyy -= 3.0f * g12;
          gx += (gf[13] * b.p13) * C3_4;
          const float g13 = gf[13] * (C3_4 * x);
          gzz += 4.0f * g13;
          gxx -= g13;
          gyy -= g13;
          gz += (gf[14] * b.p14) * C3_5;
          const float g14 = gf[14] * (C3_5 * z);
          gxx += g14;
          gyy -= g14;
          gx += (gf[15] * b.p15) * C3_6;
          const float g15 = gf[15] * (C3_6 * x);
          gxx += g15;
          gyy -= 3.0f * g15;
        }
        gx += 2.0f * (gxx * dir.x) + gxy * dir.y + gxz * dir.z;
        gy += 2.0f * (gyy * dir.y) + gxy * dir.x + gyz * dir.z;
        gz += 2.0f * (gzz * dir.z) + gyz * dir.y + gxz * dir.x;
      }
      // dirs = d / clamp(norm, 1e-8), norm = sqrt(sum d^2)
      const float gdir[3] = {gx, gy, gz};
      const float dn[3] = {dir.x, dir.y, dir.z};
      float gnc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gm[j] = gdir[j] / dir.nc;
        gnc = gnc + (-gdir[j]) * (dn[j] / dir.nc);
      }
      const float gnorm = dir.norm >= 1e-8f ? gnc : 0.0f;
      const float gss = gnorm / (2.0f * dir.norm);
#pragma unroll
      for (int j = 0; j < 3; ++j) gm[j] += 2.0f * (gss * dir.d[j]);
    }
  }

  // opacity
  {
    float go = cot(g.opacity, i);
    const float o1 = sigmoid(p.logits[i]);
    if (p.double_sigmoid) {
      const float o2 = sigmoid(o1);
      go = go * (1.0f - o2) * o2;
    }
    d.logits[i] = go * (1.0f - o1) * o1;
  }

  // mean2d = ((clip / w + 1) * (dim - 1)) * 0.5
  const float gu = cot(g.mean2d, 2 * i) * 0.5f * p.width_m1;
  const float gv = cot(g.mean2d, 2 * i + 1) * 0.5f * p.height_m1;
  const float gpx = gu / f.wsafe, gpy = gv / f.wsafe;
  const float gw = (-gu) * (f.u / f.wsafe) + (-gv) * (f.v / f.wsafe);
  const float gcw = fabsf(f.cw) < 1e-8f ? 0.0f : gw;

  // conic = [c, -b, a] / clamp(det, min=det_clamp)
  const float gc0 = cot(g.conic, 3 * i), gc1 = cot(g.conic, 3 * i + 1),
              gc2 = cot(g.conic, 3 * i + 2);
  const float k0 = f.c / f.dc, k1 = (-f.b) / f.dc, k2 = f.a / f.dc;
  float ga = gc2 / f.dc;
  float gb = -(gc1 / f.dc);
  float gc = gc0 / f.dc;
  const float gdc = ((-gc0) * (k0 / f.dc) + (-gc1) * (k1 / f.dc))
                    + (-gc2) * (k2 / f.dc);
  const float gdet = f.det >= p.det_clamp ? gdc : 0.0f;
  ga += gdet * f.c;
  gc += gdet * f.a;
  gb -= 2.0f * (gdet * f.b);
  // (the radius has no gradient: the eigenvalue path ends in ceil)

  // a = m0 S m0 + dil, b = m0 S m1, c = m1 S m1 + dil: each term of quad
  // taken back as autograd takes it, product by product
  const float S[6] = {f.sxx, f.sxy, f.sxz, f.syy, f.syz, f.szz};
  float gS[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float gm0[3] = {0.0f, 0.0f, 0.0f}, gm1[3] = {0.0f, 0.0f, 0.0f};
  quad_backward(ga, f.m0, f.m0, S, gS, gm0, gm0);
  quad_backward(gb, f.m0, f.m1, S, gS, gm0, gm1);
  quad_backward(gc, f.m1, f.m1, S, gS, gm1, gm1);
  float gj00 = 0.0f, gj02 = 0.0f, gj11 = 0.0f, gj12 = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gj00 += gm0[k] * W[4 * k];
    gj02 += gm0[k] * W[4 * k + 2];
    gj11 += gm1[k] * W[4 * k + 1];
    gj12 += gm1[k] * W[4 * k + 2];
  }
  const float fx = cam[kFX], fy = cam[kFY];
  float ginv = gj00 * fx + gj11 * fy;
  const float ginv2 = gj02 * f.t02 + gj12 * f.t12;
  const float gx = (gj02 * f.inv_z2) * (-fx);
  const float gy = (gj12 * f.inv_z2) * (-fy);
  ginv += 2.0f * (ginv2 * f.inv_z);
  float gzs = -ginv * (f.inv_z * f.inv_z);
  float gz = gx * f.cx + gy * f.cy;
  const float gtx = (f.tx >= -f.limx && f.tx <= f.limx) ? gx * f.z : 0.0f;
  const float gty = (f.ty >= -f.limy && f.ty <= f.limy) ? gy * f.z : 0.0f;
  const float gxv = gtx / f.zsafe, gyv = gty / f.zsafe;
  gzs += (-gtx) * (f.tx / f.zsafe) + (-gty) * (f.ty / f.zsafe);
  gz += fabsf(f.z) < 1e-8f ? 0.0f : gzs;
  gz += cot(g.depth, i);

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gm[j] += ((gxv * W[4 * j] + gyv * W[4 * j + 1]) + gz * W[4 * j + 2])
             + ((gpx * F[4 * j] + gpy * F[4 * j + 1]) + gcw * F[4 * j + 3]);
    d.means[3 * i + j] = gm[j];
  }

  // s_ab = sum_k (r_ak * r_bk) * e_k, term by term as autograd takes it
  const float* r = f.r;
  float gr[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ge[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    const int a = chan_a(ch), b = chan_b(ch);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float gp = gS[ch] * f.e[k];
      ge[k] += gS[ch] * (r[3 * a + k] * r[3 * b + k]);
      gr[3 * a + k] += gp * r[3 * b + k];
      gr[3 * b + k] += gp * r[3 * a + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d.scales[3 * i + k] = (ge[k] * f.e[k]) * 2.0f;
  // a round gaussian's Sigma = e I does not depend on the rotation, so its
  // gradient is exactly 0. Here J2 departs from the plain chain's VJP on
  // purpose: autograd through the chain's float32 rotation matrix leaves
  // zeros and rounding noise of about 1e-7 of the scales' gradient, and
  // Adam, which normalizes each coordinate's gradient, would turn that
  // noise into full-sized rotation steps; a float64 autograd of the chain
  // reads about 1e-16 there
  if (f.e[0] == f.e[1] && f.e[1] == f.e[2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) d.quats[4 * i + j] = 0.0f;
    return;
  }
  // R from the unit quaternion (w, x, y, z)
  const float w = f.qw, x = f.qx, y = f.qy, z = f.qz;
  const float gqn[4] = {
      2.0f * (((-z * gr[1] + y * gr[2]) + (z * gr[3] - x * gr[5]))
              + (-y * gr[6] + x * gr[7])),
      2.0f * (((y * gr[1] + z * gr[2]) + (y * gr[3] - 2.0f * x * gr[4]))
              + ((-w * gr[5] + z * gr[6]) + (w * gr[7] - 2.0f * x * gr[8]))),
      2.0f * (((-2.0f * y * gr[0] + x * gr[1]) + (w * gr[2] + x * gr[3]))
              + ((z * gr[5] - w * gr[6]) + (z * gr[7] - 2.0f * y * gr[8]))),
      2.0f * (((-2.0f * z * gr[0] - w * gr[1]) + (x * gr[2] + w * gr[3]))
              + ((-2.0f * z * gr[4] + y * gr[5]) + (x * gr[6] + y * gr[7])))};
  // q / norm(q)
  float gn = 0.0f;
  const float qn[4] = {w, x, y, z};
#pragma unroll
  for (int j = 0; j < 4; ++j) gn = gn + (-gqn[j]) * (qn[j] / f.qn);
  const float gss = gn / (2.0f * f.qn);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    d.quats[4 * i + j] = gqn[j] / f.qn + 2.0f * (gss * f.q[j]);
}

template <int DEG>
cudaError_t launch_fwd(const Params& p, const uint8_t* active, const Out& o,
                       cudaStream_t st) {
  project_fwd_kernel<DEG><<<(p.n + kThreads - 1) / kThreads, kThreads, 0,
                            st>>>(p, active, o);
  return cudaGetLastError();
}

template <int DEG>
cudaError_t launch_bwd(const Params& p, const Cot& g, const Grad& d,
                       cudaStream_t st) {
  project_bwd_kernel<DEG><<<(p.n + kThreads - 1) / kThreads, kThreads, 0,
                            st>>>(p, g, d);
  return cudaGetLastError();
}

Params make_params(const float* means, const float* scales,
                   const float* quats, const float* logits, const float* sh,
                   int n, int k, const float* w2v, const float* fp,
                   const float* fx, const float* fy, const float* tfx,
                   const float* tfy, const float* cc, float min_z,
                   float ewa_clamp, float det_clamp, float eig_floor,
                   float radius_sigmas, float dilation, int width, int height,
                   int double_sigmoid) {
  Params p;
  p.means = means;
  p.scales = scales;
  p.quats = quats;
  p.logits = logits;
  p.sh = sh;
  p.n = n;
  p.k = k;
  p.w2v = w2v;
  p.fp = fp;
  p.fx = fx;
  p.fy = fy;
  p.tfx = tfx;
  p.tfy = tfy;
  p.cc = cc;
  p.min_z = min_z;
  p.ewa_clamp = ewa_clamp;
  p.det_clamp = det_clamp;
  p.eig_floor = eig_floor;
  p.radius_sigmas = radius_sigmas;
  p.dilation = dilation;
  p.width_m1 = (float)(width - 1);
  p.height_m1 = (float)(height - 1);
  p.double_sigmoid = double_sigmoid;
  return p;
}

// degree -1 (raw RGB) to 3, with (degree + 1)^2 <= k
bool degree_ok(int degree, int k) {
  return degree >= -1 && degree <= 3 && k >= 1 &&
         (degree + 1) * (degree + 1) <= k;
}

}  // namespace

extern "C" {

// J1. The gaussians' parameters (float32, contiguous, n rows; sh (n, k, 3)),
// active (n,) bool, the camera's seven float32 device tensors (world2view
// and full_proj 4x4 row-major, cam_center (3,), the rest 0-d), the
// rasterizer's scalars, the image size, the colour (degree -1: raw RGB,
// else SH to that degree) -> the (n,)-row outputs, each allocated by the
// caller. The wrapper checks types, shapes and devices.
int project_fwd(const float* means, const float* scales, const float* quats,
                const float* logits, const float* sh, const uint8_t* active,
                int n, int k, const float* w2v, const float* fp,
                const float* fx, const float* fy, const float* tfx,
                const float* tfy, const float* cc, float min_z,
                float ewa_clamp, float det_clamp, float eig_floor,
                float radius_sigmas, float dilation, int width, int height,
                int degree, int double_sigmoid, float* mean2d, float* depth,
                float* conic, float* radius, float* color, float* opacity,
                uint8_t* valid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || !degree_ok(degree, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Params p = make_params(means, scales, quats, logits, sh, n, k, w2v,
                               fp, fx, fy, tfx, tfy, cc, min_z, ewa_clamp,
                               det_clamp, eig_floor, radius_sigmas, dilation,
                               width, height, double_sigmoid);
  const Out o{mean2d, depth, conic, radius, color, opacity, valid};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (degree) {
    case -1: return (int)launch_fwd<-1>(p, active, o, st);
    case 0: return (int)launch_fwd<0>(p, active, o, st);
    case 1: return (int)launch_fwd<1>(p, active, o, st);
    case 2: return (int)launch_fwd<2>(p, active, o, st);
    default: return (int)launch_fwd<3>(p, active, o, st);
  }
}

// J2. J1's inputs (no active: the gradient does not depend on it) and the
// cotangents of mean2d, depth, conic, color and opacity (contiguous, or
// null for a zero cotangent) -> the gradients of the means, log scales,
// quaternions, opacity logits and SH coefficients, every element written.
int project_bwd(const float* means, const float* scales, const float* quats,
                const float* logits, const float* sh, int n, int k,
                const float* w2v, const float* fp, const float* fx,
                const float* fy, const float* tfx, const float* tfy,
                const float* cc, float min_z, float ewa_clamp,
                float det_clamp, float eig_floor, float radius_sigmas,
                float dilation, int width, int height, int degree,
                int double_sigmoid, const float* g_mean2d,
                const float* g_depth, const float* g_conic,
                const float* g_color, const float* g_opacity, float* d_means,
                float* d_scales, float* d_quats, float* d_logits,
                float* d_sh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || !degree_ok(degree, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Params p = make_params(means, scales, quats, logits, sh, n, k, w2v,
                               fp, fx, fy, tfx, tfy, cc, min_z, ewa_clamp,
                               det_clamp, eig_floor, radius_sigmas, dilation,
                               width, height, double_sigmoid);
  const Cot g{g_mean2d, g_depth, g_conic, g_color, g_opacity};
  const Grad d{d_means, d_scales, d_quats, d_logits, d_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (degree) {
    case -1: return (int)launch_bwd<-1>(p, g, d, st);
    case 0: return (int)launch_bwd<0>(p, g, d, st);
    case 1: return (int)launch_bwd<1>(p, g, d, st);
    case 2: return (int)launch_bwd<2>(p, g, d, st);
    default: return (int)launch_bwd<3>(p, g, d, st);
  }
}

const char* projection_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
