// The first design of the FAST score kernel (f32 minima and maxima, one pixel
// per thread, a flat-index staging loop with run-time modulo), kept so that
// perf/kernel_split.py can time it beside the current csrc/fast.cu on the
// same input in one run. Not used by the package.

#include <cuda_runtime.h>

#define TW 32
#define TH 16
#define R 3
#define SW (TW + 2 * R)
#define SH (TH + 2 * R)

__global__ void fast_score_kernel(const float* __restrict__ in, long long s_l, long long s_h,
                                  float* __restrict__ out, int H, int W) {
  __shared__ float tile[SH][SW];
  const int l = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const float* src = in + (long long)l * s_l;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int ty = i / SW, tx = i % SW;
    int gy = y0 + ty - R, gx = x0 + tx - R;
    gy = ((gy % H) + H) % H;
    gx = ((gx % W) + W) % W;
    tile[ty][tx] = src[(long long)gy * s_h + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  // ring offsets (dx, dy), index 0 at 12 o'clock, clockwise (ops/fast.py CIRCLE16)
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int cy = threadIdx.y + R, cx = threadIdx.x + R;
  const float c = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = c - tile[cy + DY[k]][cx + DX[k]];

  // dark arcs: min of d over 9 consecutive ring positions; bright arcs: min of
  // -d, i.e. -(max of d)
  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(d[k], d[(k + 1) & 15]);
    hi2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo2[k], lo2[(k + 2) & 15]);
    hi4[k] = fmaxf(hi2[k], hi2[(k + 2) & 15]);
  }
  float score = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float lo9 = fminf(fminf(lo4[k], lo4[(k + 4) & 15]), d[(k + 8) & 15]);
    const float hi9 = fmaxf(fmaxf(hi4[k], hi4[(k + 4) & 15]), d[(k + 8) & 15]);
    score = fmaxf(score, fmaxf(lo9, -hi9));
  }
  out[((long long)l * H + y) * W + x] = score;
}

extern "C" int fast_v1_launch(const float* in, long long s_l, long long s_h, float* out,
                                 int L, int H, int W, void* stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, L);
  fast_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, s_l, s_h, out, H, W);
  return (int)cudaGetLastError();
}
