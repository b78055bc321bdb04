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
// What a keypoint costs is its chain of dependent steps: the disc loads, the
// moment sums, the angle with its sine and cosine, the sample loads. The first
// design (perf/orb_v1.cu: one 256-thread block per keypoint, two block
// barriers, the angle on thread 0 alone) spent most of its time in the disc
// walk, a division, a modulo and a 64-bit clamped index per pixel
// (perf/kernel_split.py). Design:
//   - one warp per keypoint, KPB keypoints per block, no block barrier;
//   - the pattern pairs 32w + lane (w < 8) are loaded first, so their loads
//     overlap the disc's;
//   - lane dx + 15 walks the disc rows: a row is one coalesced load of 31
//     floats, every row's load is issued before the first is used, and a
//     pixel outside the umax disc weighs 0. The terms are integers and
//     |m10|, |m01| <= 749 * 15 * 255 < 2^24, so the per-lane sums and the
//     shuffle butterfly are exact in any order, and every lane ends with the
//     same moments;
//   - every lane computes the angle, cosf and sinf itself, so no lane waits
//     on another. The angle polynomial, theta = deg * f32(pi/180), and the
//     pattern rotation use __fmul_rn/__fadd_rn/__fsub_rn so no multiply-add
//     is contracted into an FMA: the rounding then matches the plain
//     version's separate multiply and add, and __float2int_rn rounds half to
//     even like torch.round / jnp.rint;
//   - each lane takes 8 pairs (their 16 samples all in flight at once); 8
//     ballots give the descriptor words (lane b = bit b), which lanes 0-7
//     store as one 32-byte row of int32 bit patterns.
// Reads clamp the flat canvas index into range, like the plain version. A
// keypoint whose every read (within REACH rows and columns of its centre) is
// inside the canvas, which is every keypoint the extractor selects, indexes
// with 32-bit offsets from its centre; the others take the 64-bit clamped
// index. The choice is made once per keypoint (a template argument), so the
// loads carry no branch.

#include <cuda_runtime.h>

#define HALO 19
#define HP 15
#define KPB 4  // keypoints (warps) per block
// rows and columns from the centre that a read can reach: 15 on the disc; a
// point of the pattern table (ops/data/orb_pattern.npy) has |x|, |y| <= 13, so
// a rotated one rounds to at most 13 * sqrt(2) < 19
#define REACH 19
#define FULL 0xffffffffu

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

// the pixel at offset `off` from the flat index `ctr`: a 32-bit offset from
// the centre when every read of the keypoint is inside the canvas (INSIDE),
// else the flat index clamped into [0, total)
template <bool INSIDE>
__device__ __forceinline__ float pixel(const float* __restrict__ src, long long ctr, int off,
                                       long long total) {
  if (INSIDE) return __ldg(src + ctr + off);
  const long long i = ctr + off;
  return __ldg(src + (i < 0 ? 0 : (i >= total ? total - 1 : i)));
}

// this lane's share of the moments: column dx = lane - 15 of the 31 disc
// rows (lane 31 is outside the disc); every pixel of the rows is loaded, so
// the loads need no branch, and a pixel outside the disc weighs 0
template <bool INSIDE>
__device__ __forceinline__ void disc(const float* __restrict__ raw, long long ctr, int CW,
                                     long long total, const int* __restrict__ umax, int lane,
                                     float& m10, float& m01) {
  const int dx = lane - HP, adx = abs(dx);
  float v[2 * HP + 1];
#pragma unroll
  for (int k = 0; k < 2 * HP + 1; ++k)
    v[k] = pixel<INSIDE>(raw, ctr, (k - HP) * CW + (adx <= HP ? dx : 0), total);
#pragma unroll
  for (int k = 0; k < 2 * HP + 1; ++k) {
    const int dy = k - HP;
    const float w = adx <= __ldg(umax + abs(dy)) ? v[k] : 0.0f;
    m10 += (float)dx * w;
    m01 += (float)dy * w;
  }
}

// the samples of this lane's pairs, rotated by (ca, sa): s1 < s2 is the bit
template <bool INSIDE>
__device__ __forceinline__ void samples(const float* __restrict__ blur, long long ctr, int CW,
                                        long long total, const int4 (&pat)[8], float ca,
                                        float sa, float (&s1)[8], float (&s2)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x1 = (float)pat[i].x, y1 = (float)pat[i].y;
    const float x2 = (float)pat[i].z, y2 = (float)pat[i].w;
    const int rx1 = __float2int_rn(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sa)));
    const int ry1 = __float2int_rn(__fadd_rn(__fmul_rn(x1, sa), __fmul_rn(y1, ca)));
    const int rx2 = __float2int_rn(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sa)));
    const int ry2 = __float2int_rn(__fadd_rn(__fmul_rn(x2, sa), __fmul_rn(y2, ca)));
    s1[i] = pixel<INSIDE>(blur, ctr, ry1 * CW + rx1, total);
    s2[i] = pixel<INSIDE>(blur, ctr, ry2 * CW + rx2, total);
  }
}

__global__ void __launch_bounds__(KPB * 32)
orb_kernel(const float* __restrict__ raw, const float* __restrict__ blur,
           const int* __restrict__ level, const int* __restrict__ ys, const int* __restrict__ xs,
           const int4* __restrict__ pattern, const int* __restrict__ umax, int N, int CH, int CW,
           long long total, float* __restrict__ angle, int* __restrict__ desc) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * KPB + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together

  int4 pat[8];  // x1 y1 x2 y2 of pairs 32 w + lane
#pragma unroll
  for (int w = 0; w < 8; ++w) pat[w] = __ldg(pattern + 32 * w + lane);
  const long long ctr =
      ((long long)__ldg(level + n) * CH + __ldg(ys + n) + HALO) * CW + __ldg(xs + n) + HALO;
  const long long reach = (long long)REACH * CW + REACH;
  const bool inside = ctr >= reach && ctr < total - reach;
  float m10 = 0.0f, m01 = 0.0f;
  if (inside) {
    disc<true>(raw, ctr, CW, total, umax, lane, m10, m01);
  } else {
    disc<false>(raw, ctr, CW, total, umax, lane, m10, m01);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(FULL, m10, off);
    m01 += __shfl_xor_sync(FULL, m01, off);
  }
  const float deg = fast_atan2_deg(m01, m10);
  const float theta = __fmul_rn(deg, __int_as_float(0x3c8efa35));  // f32(pi/180)
  const float ca = cosf(theta), sa = sinf(theta);
  if (lane == 0) angle[n] = deg;

  float s1[8], s2[8];
  if (inside) {
    samples<true>(blur, ctr, CW, total, pat, ca, sa, s1, s2);
  } else {
    samples<false>(blur, ctr, CW, total, pat, ca, sa, s1, s2);
  }
  unsigned word = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const unsigned bits = __ballot_sync(FULL, s1[w] < s2[w]);
    if (lane == w) word = bits;
  }
  if (lane < 8) desc[n * 8 + lane] = (int)word;
}

// raw/blur [L, CH, CW] f32, level/ys/xs [N] i32, pattern [256, 4] i32
// (16-byte aligned), umax [16] i32 -> angle [N] f32, desc [N, 8] i32. The
// wrapper checks that REACH * CW + REACH fits an int.
extern "C" int orb_angle_desc_launch(const float* raw, const float* blur, const int* level,
                                     const int* ys, const int* xs, const int* pattern,
                                     const int* umax, int N, int L, int CH, int CW,
                                     float* angle, int* desc, void* stream) {
  if (N > 0) {
    orb_kernel<<<(N + KPB - 1) / KPB, KPB * 32, 0, (cudaStream_t)stream>>>(
        raw, blur, level, ys, xs, reinterpret_cast<const int4*>(pattern), umax, N, CH, CW,
        (long long)L * CH * CW, angle, desc);
  }
  return (int)cudaGetLastError();
}
