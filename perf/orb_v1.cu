// The first design of the IC angle + steered rBRIEF kernel (csrc/orb.cu as
// PRs 1-5 left it: one 256-thread block per keypoint, two block barriers, the
// angle and its sine and cosine on thread 0 alone), kept so that
// perf/kernel_split.py can time its parts beside the current csrc/orb.cu on
// the same inputs in one run. Not used by the package.
//
// orb_v1_launch(..., mode): 0 the whole kernel; 1 without the disc loop (the
// moments are 0); 2 without thread 0's tail (the reduction stays, the angle is
// fixed at 0: no division, polynomial, cosf or sinf); 3 without the pattern
// samples (the rotation stays, the bits compare the rotated coordinates).
//
// Intensity-centroid angle + steered rBRIEF descriptor per keypoint.
//
// Replaces the TPU kernel vo_slam_test_tpu/ops/orb_pallas.py:
// orb_angle_desc_pallas (_kernel). Plain versions: ops/orientation.py::
// ic_angle and ops/brief.py::compute_descriptors.
//
// What it computes, per keypoint (level, y, x) in level-image coordinates:
//   m10, m01 = sum of dx*I and dy*I over the radius-15 umax disc of the raw
//   canvas; angle = cvFastAtan2(m01, m10) in degrees; then the 256 pattern
//   pairs rotated by that angle, rounded half to even, sampled on the blurred
//   canvas, bit = I(p1) < I(p2); bit b of word w is pair 32w + b.
//
// Bound on this card: memory latency, not bandwidth or arithmetic. A keypoint
// touches ~1.2k scattered pixels (749 disc + 512 samples, ~5 KB) and does ~5k
// operations, so 1024 keypoints need ~5 MB and ~5 MFLOP: microseconds at peak.
// Design: one 256-thread block per keypoint, so the 1024 keypoints fill the
// SMs with independent gathers in flight:
//   - moments: each thread sums a strided share of the 31x31 disc; the terms
//     are integers and every partial sum stays below 2^24, so the warp-shuffle
//     and shared-memory reduction is exact in any order;
//   - the angle polynomial, theta = deg * f32(pi/180), and the pattern
//     rotation use __fmul_rn/__fadd_rn/__fsub_rn so no multiply-add is
//     contracted into an FMA: the rounding then matches the plain version's
//     separate multiply and add, and __float2int_rn rounds half to even like
//     torch.round / jnp.rint;
//   - one thread per pattern pair; __ballot_sync packs a warp's 32 bits into
//     one descriptor word (lane b = bit b), stored as an int32 bit pattern.
// Reads clamp the flat canvas index into range, like the plain version.

#include <cuda_runtime.h>

#define HALO 19
#define HP 15
#define NTHREADS 256

__device__ __forceinline__ float fast_atan2_deg(float y, float x) {
  // cvFastAtan2's f32 constants: f32(c * 180/pi) for the four coefficients,
  // and f32(DBL_EPSILON) (ops/orientation.py)
  const float P1 = __int_as_float(0x4265226e);
  const float P3 = __int_as_float(0xc19556ee);
  const float P5 = __int_as_float(0x410e9fbf);
  const float P7 = __int_as_float(0xc0228ad9);
  const float EPS = __int_as_float(0x25800000);
  const float ax = fabsf(x), ay = fabsf(y);
  const float lo = fminf(ax, ay), hi = fmaxf(ax, ay);
  const float c = __fdiv_rn(lo, __fadd_rn(hi, EPS));
  const float c2 = __fmul_rn(c, c);
  float p = __fadd_rn(__fmul_rn(P7, c2), P5);
  p = __fadd_rn(__fmul_rn(p, c2), P3);
  p = __fadd_rn(__fmul_rn(p, c2), P1);
  p = __fmul_rn(p, c);
  float a = (ax >= ay) ? p : __fsub_rn(90.0f, p);
  if (x < 0.0f) a = __fsub_rn(180.0f, a);
  if (y < 0.0f) a = __fsub_rn(360.0f, a);
  return a;
}

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(NTHREADS)
orb_kernel(const float* __restrict__ raw, const float* __restrict__ blur,
           const int* __restrict__ level, const int* __restrict__ ys, const int* __restrict__ xs,
           const int* __restrict__ pattern, const int* __restrict__ umax,
           int CH, int CW, long long total, float* __restrict__ angle, int* __restrict__ desc,
           int mode) {
  __shared__ float red[2][NTHREADS / 32];
  __shared__ float rot[2];
  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long base = (long long)level[n] * CH;
  const int y = ys[n] + HALO, x = xs[n] + HALO;

  float m10 = 0.0f, m01 = 0.0f;
  for (int i = t; i < (mode == 1 ? 0 : (2 * HP + 1) * (2 * HP + 1)); i += NTHREADS) {
    const int dy = i / (2 * HP + 1) - HP;
    const int dx = i % (2 * HP + 1) - HP;
    if (abs(dx) <= umax[abs(dy)]) {
      const float v = raw[clamp_index((base + y + dy) * CW + x + dx, total)];
      m10 += (float)dx * v;
      m01 += (float)dy * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  if (lane == 0) {
    red[0][warp] = m10;
    red[1][warp] = m01;
  }
  __syncthreads();
  if (t == 0) {
    float s10 = 0.0f, s01 = 0.0f;
    for (int w = 0; w < NTHREADS / 32; ++w) {
      s10 += red[0][w];
      s01 += red[1][w];
    }
    if (mode == 2) {
      angle[n] = 0.0f * (s10 + s01);
      rot[0] = 1.0f;
      rot[1] = 0.0f;
    } else {
      const float deg = fast_atan2_deg(s01, s10);
      angle[n] = deg;
      const float theta = __fmul_rn(deg, __int_as_float(0x3c8efa35));  // f32(pi/180)
      rot[0] = cosf(theta);
      rot[1] = sinf(theta);
    }
  }
  __syncthreads();
  const float ca = rot[0], sa = rot[1];

  const int4 p = reinterpret_cast<const int4*>(pattern)[t];  // x1 y1 x2 y2
  const float x1 = (float)p.x, y1 = (float)p.y, x2 = (float)p.z, y2 = (float)p.w;
  const int rx1 = __float2int_rn(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sa)));
  const int ry1 = __float2int_rn(__fadd_rn(__fmul_rn(x1, sa), __fmul_rn(y1, ca)));
  const int rx2 = __float2int_rn(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sa)));
  const int ry2 = __float2int_rn(__fadd_rn(__fmul_rn(x2, sa), __fmul_rn(y2, ca)));
  float s1, s2;
  if (mode == 3) {
    s1 = (float)(ry1 * 64 + rx1);
    s2 = (float)(ry2 * 64 + rx2);
  } else {
    s1 = blur[clamp_index((base + y + ry1) * CW + x + rx1, total)];
    s2 = blur[clamp_index((base + y + ry2) * CW + x + rx2, total)];
  }
  const unsigned bits = __ballot_sync(0xffffffffu, s1 < s2);
  if (lane == 0) desc[n * 8 + warp] = (int)bits;
}

extern "C" int orb_v1_launch(const float* raw, const float* blur, const int* level,
                                     const int* ys, const int* xs, const int* pattern,
                                     const int* umax, int N, int L, int CH, int CW,
                                     float* angle, int* desc, int mode, void* stream) {
  if (N > 0) {
    orb_kernel<<<N, NTHREADS, 0, (cudaStream_t)stream>>>(
        raw, blur, level, ys, xs, pattern, umax, CH, CW, (long long)L * CH * CW, angle, desc,
        mode);
  }
  return (int)cudaGetLastError();
}
