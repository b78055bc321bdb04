// The first design of the FAST kernel's 3x3-NMS mode (csrc/fast.cu's
// fast_score_nms_launch before its redesign, entry renamed): plain ints and DPX
// min3 per pixel, a 32x16 tile staged through a flat index with a halo of 4,
// the 34x18 score ring scored one pixel at a time. Kept so that chip_smoke.py
// and perf/kernel_split.py can check the current kernel against it bit for
// bit and time the two on the same input in one run. Not used by the package.

#include <cuda_runtime.h>

#define R 3

// 3x3-NMS mode: a score is kept where it is strictly greater than all 8
// neighbours' scores, else 0 (ops/fast.py::nms3x3 on fast_score). Scores are
// integers, so the comparison is exact and a tie suppresses both pixels.
// Indices wrap in both axes, as the plain version's rolls do, so the mode
// equals its plain version on every pixel.
//
// Bound on this card: bytes, the same as the raw mode's (one f32 read and one
// f32 write per pixel); the scores of the one-pixel ring around a tile are
// computed twice. Design, simple first: a block of 32x8 threads writes a 32x16
// tile. It stages the tile's pixels with a halo of 4 (3 for the ring, 1 for the
// neighbours' scores) as ints in shared memory, scores the tile and its ring
// (34x18) into shared memory, one pixel at a time with Hopper's three-input
// integer minima and maxima (a 9-arc minimum is min3 of three 3-runs), and
// compares from there. The raw mode's all-zero early exit is kept: every score
// of an all-zero stage is 0, and 0 > 0 is false.

#define NW 32              // tile width: threads along x
#define NTY 8              // threads along y
#define NH (2 * NTY)       // tile height: thread y writes rows y and y + NTY
#define NR (R + 1)         // staged halo
#define NSW (NW + 2)       // score stage: the tile and a one-pixel ring
#define NSH (NH + 2)
#define NPW (NW + 2 * NR)  // pixel stage
#define NPH (NH + 2 * NR)

// g wrapped into [0, n) for g in [-NR, n + NR - 1] and n >= NR; indices
// further out (stage rows and columns that no written pixel reads) are
// clamped first
__device__ __forceinline__ int wrap_nms(int g, int n) {
  g = min(g, n + NR - 1);
  g += g < 0 ? n : 0;
  g -= g >= n ? n : 0;
  return g;
}

// the raw score V of the staged pixel (cy, cx): max(0, best dark arc, best
// bright arc), in plain ints
__device__ __forceinline__ int score_at(const int (*px)[NPW], int cy, int cx) {
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int c = px[cy][cx];
  int d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = c - px[cy + DY[k]][cx + DX[k]];
  int lo3[16], hi3[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo3[k] = __vimin3_s32(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
    hi3[k] = __vimax3_s32(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
  }
  // dark: the largest 9-arc minimum of d; bright: the smallest 9-arc maximum
  // of d (the minimum of -d over an arc is minus its maximum of d)
  int dark = -256, bright = 256;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    dark = max(dark, __vimin3_s32(lo3[k], lo3[(k + 3) & 15], lo3[(k + 6) & 15]));
    bright = min(bright, __vimax3_s32(hi3[k], hi3[(k + 3) & 15], hi3[(k + 6) & 15]));
  }
  return max(max(dark, -bright), 0);
}

__global__ void __launch_bounds__(NW * NTY)
fast_score_nms_kernel(const float* __restrict__ in, long long s_l, long long s_h,
                      float* __restrict__ out, int H, int W) {
  __shared__ int px[NPH][NPW];
  __shared__ int sc[NSH][NSW];
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * NW + tx;
  const int x0 = blockIdx.x * NW, y0 = blockIdx.y * NH;
  const float* src = in + (long long)blockIdx.z * s_l;

  // stage pixel (r, c) is image pixel (y0 - NR + r, x0 - NR + c), wrapped
  int any = 0;
  for (int i = t; i < NPH * NPW; i += NW * NTY) {
    const int r = i / NPW, c = i - r * NPW;
    const int v = (int)src[(long long)wrap_nms(y0 - NR + r, H) * s_h + wrap_nms(x0 - NR + c, W)];
    px[r][c] = v;
    any |= v;
  }
  const int live = __syncthreads_or(any != 0);
  if (live) {
    // score (r, c) is image pixel (y0 - 1 + r, x0 - 1 + c): stage pixel (r + R, c + R)
    for (int i = t; i < NSH * NSW; i += NW * NTY) {
      const int r = i / NSW, c = i - r * NSW;
      sc[r][c] = score_at(px, r + R, c + R);
    }
    __syncthreads();
  }

  const int x = x0 + tx;
  if (x >= W) return;
#pragma unroll
  for (int h = 0; h < NH / NTY; ++h) {
    const int ly = ty + h * NTY, y = y0 + ly;
    if (y >= H) return;
    float v = 0.0f;
    if (live) {
      const int s = sc[ly + 1][tx + 1];
      bool keep = true;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (dy != 1 || dx != 1) keep = keep && s > sc[ly + dy][tx + dx];
      v = keep ? (float)s : 0.0f;
    }
    out[((long long)blockIdx.z * H + y) * W + x] = v;
  }
}

extern "C" int fast_score_nms_v1_launch(const float* in, long long s_l, long long s_h, float* out,
                                     int L, int H, int W, void* stream) {
  if (H < NR || W < NR || L < 1 || L > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(NW, NTY);
  dim3 grid((W + NW - 1) / NW, (H + NH - 1) / NH, L);
  fast_score_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, s_l, s_h, out, H, W);
  return (int)cudaGetLastError();
}
