// The earlier designs of the local-BA robust cost (ba_cost_point_kernel, one
// thread per point over all L slots walking its observers in a row, then
// ba_cost_sum_kernel: two launches) and of the point back-substitution
// (ba_backsub_kernel, one thread per point walking all wk window slots), kept
// so that perf/kernel_split.py can time them beside the current
// csrc/ba.cu on the same inputs in one run and check that the outputs are
// bit-equal. The kernels' code is copied unchanged. Not used by the package.
//
// ba_tail_v1_cost_launch / ba_tail_v1_backsub_launch take the arguments of
// the earlier ba_cost_launch / ba_backsub_launch.

#include <cuda_runtime.h>

#define PT_THREADS 128
#define RED_THREADS 128
#define MAX_WK 32

// sqrt(5.991) and sqrt(7.815) rounded to f32, as the plain version rounds them
#define DELTA_MONO 2.4476518630981445f
#define DELTA_STEREO 2.7955322265625f

struct Obs {
  float R[9], pcx, pcy, pcz, invz, isig, ew[3];
  bool stereo;
};

// ((r0*x + r1*y) + r2*z) + t, each op rounded on its own
__device__ __forceinline__ float dot3t(float r0, float r1, float r2, float x, float y, float z,
                                       float t) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r0, x), __fmul_rn(r1, y)), __fmul_rn(r2, z)), t);
}

// residual of observation (o, l) seen from slot s; returns s2 = |e * isig|^2
__device__ __forceinline__ float observe(const float* __restrict__ posesT, int WF, int s, float x,
                                         float y, float z, float uo, float vo, float uro,
                                         float isig2, const float* __restrict__ cam, Obs& ob) {
  float T[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) T[r] = posesT[r * WF + s];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) ob.R[i * 3 + j] = T[i * 4 + j];
  ob.pcx = dot3t(T[0], T[1], T[2], x, y, z, T[3]);
  ob.pcy = dot3t(T[4], T[5], T[6], x, y, z, T[7]);
  ob.pcz = dot3t(T[8], T[9], T[10], x, y, z, T[11]);
  const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3], bf = cam[4];
  ob.invz = __fdiv_rn(1.0f, fabsf(ob.pcz) < 1e-9f ? 1e-9f : ob.pcz);
  const float uu = __fadd_rn(__fmul_rn(__fmul_rn(fx, ob.pcx), ob.invz), cx);
  const float vv = __fadd_rn(__fmul_rn(__fmul_rn(fy, ob.pcy), ob.invz), cy);
  ob.stereo = uro >= 0.0f;
  const float e2 = ob.stereo ? __fsub_rn(__fsub_rn(uu, __fmul_rn(bf, ob.invz)), uro) : 0.0f;
  ob.isig = __fsqrt_rn(isig2);
  ob.ew[0] = __fmul_rn(__fsub_rn(uu, uo), ob.isig);
  ob.ew[1] = __fmul_rn(__fsub_rn(vv, vo), ob.isig);
  ob.ew[2] = __fmul_rn(e2, ob.isig);
  return __fadd_rn(__fadd_rn(__fmul_rn(ob.ew[0], ob.ew[0]), __fmul_rn(ob.ew[1], ob.ew[1])),
                   __fmul_rn(ob.ew[2], ob.ew[2]));
}

// Huber (or plain) cost of s2 and its weight
__device__ __forceinline__ float robust(float s2, bool stereo, int huber, float& wrob) {
  if (!huber) {
    wrob = 1.0f;
    return s2;
  }
  const float delta = stereo ? DELTA_STEREO : DELTA_MONO;
  const float s = __fsqrt_rn(__fadd_rn(s2, 1e-12f));
  wrob = fminf(1.0f, __fdiv_rn(delta, s));
  return s <= delta ? s2 : __fsub_rn(__fmul_rn(__fmul_rn(2.0f, delta), s), __fmul_rn(delta, delta));
}

// the point's cost over its observers in slot order (shared by launch 1 and
// ba_cost_launch, so both give the same bits)
__device__ __forceinline__ float add_cost(float cost, float a, float rho) {
  return a > 0.0f ? __fadd_rn(cost, rho) : cost;
}

// fixed-order sum of one partial per thread of the block's first RED_THREADS
// threads (the others only keep the barriers): sh[0] holds the sum
__device__ __forceinline__ void block_reduce(float acc, float* sh) {
  const int t = threadIdx.x;
  if (t < RED_THREADS) sh[t] = acc;
  __syncthreads();
  for (int stride = RED_THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride) sh[t] = __fadd_rn(sh[t], sh[t + stride]);
    __syncthreads();
  }
}

// the per-point costs summed in a fixed order by the first RED_THREADS threads
__device__ __forceinline__ float cost_sum(const float* __restrict__ cost_pt, int n, float* sh) {
  float acc = 0.0f;
  if (threadIdx.x < RED_THREADS)
    for (int l = threadIdx.x; l < n; l += RED_THREADS) acc = __fadd_rn(acc, cost_pt[l]);
  block_reduce(acc, sh);
  return sh[0];
}

__global__ void __launch_bounds__(PT_THREADS)
ba_cost_point_kernel(const float* __restrict__ cam, const float* __restrict__ posesT,
                     const float* __restrict__ X, const int* __restrict__ slot,
                     const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ ur, const float* __restrict__ isig2,
                     const float* __restrict__ act, int WF, int O, int L, int huber,
                     float* __restrict__ cost_pt) {
  const int l = blockIdx.x * PT_THREADS + threadIdx.x;
  if (l >= L) return;
  const float x = X[l], y = X[L + l], z = X[2 * L + l];
  float cost = 0.0f;
  for (int o = 0; o < O; ++o) {
    const int s = slot[o * L + l];
    if (s < 0) continue;
    const int i0 = o * L + l;
    Obs ob;
    const float s2 = observe(posesT, WF, s, x, y, z, u[i0], v[i0], ur[i0], isig2[i0], cam, ob);
    float wrob;
    cost = add_cost(cost, act[i0], robust(s2, ob.stereo, huber, wrob));
  }
  cost_pt[l] = cost;
}

__global__ void __launch_bounds__(RED_THREADS)
ba_cost_sum_kernel(const float* __restrict__ cost_pt, const int* __restrict__ n_pts, int L,
                   float* __restrict__ cost) {
  __shared__ float sh[RED_THREADS];
  const float c = cost_sum(cost_pt, min(*n_pts, L), sh);
  if (threadIdx.x == 0) cost[0] = c;
}

__global__ void __launch_bounds__(PT_THREADS)
ba_backsub_kernel(const float* __restrict__ Wc, const float* __restrict__ Hinv,
                  const float* __restrict__ bl, const float* __restrict__ dxp,
                  const int* __restrict__ n_pts, int wk, int L, float* __restrict__ dx) {
  __shared__ float sdx[MAX_WK * 6];
  for (int i = threadIdx.x; i < wk * 6; i += PT_THREADS) sdx[i] = dxp[i];
  __syncthreads();
  const int l = blockIdx.x * PT_THREADS + threadIdx.x;
  if (l >= L) return;
  float tv[3] = {bl[l], bl[L + l], bl[2 * L + l]};
  if (l < *n_pts) {  // past the live points every Wc row is zero
    for (int a = 0; a < wk; ++a) {
      const float* wc = Wc + (size_t)a * 18 * L + l;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float d = sdx[a * 6 + i];
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k] += wc[(i * 3 + k) * L] * d;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dx[i * L + l] = -(Hinv[(i * 3) * L + l] * tv[0] + Hinv[(i * 3 + 1) * L + l] * tv[1] +
                      Hinv[(i * 3 + 2) * L + l] * tv[2]);
}

// The robust cost alone: per-point costs, then the fixed-order sum.
extern "C" int ba_tail_v1_cost_launch(const float* cam, const float* posesT, const float* X,
                                      const int* slot, const float* u, const float* v,
                                      const float* ur, const float* isig2, const float* act,
                                      const int* n_pts, int WF, int O, int L, int huber,
                                      float* cost, float* cost_pt, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ba_cost_point_kernel<<<(L + PT_THREADS - 1) / PT_THREADS, PT_THREADS, 0, st>>>(
      cam, posesT, X, slot, u, v, ur, isig2, act, WF, O, L, huber, cost_pt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ba_cost_sum_kernel<<<1, RED_THREADS, 0, st>>>(cost_pt, n_pts, L, cost);
  return (int)cudaGetLastError();
}

// dx_pt [3,L] = -Hinv (bl + Wc^T dx_pose), one thread per point.
extern "C" int ba_tail_v1_backsub_launch(const float* Wc, const float* Hinv, const float* bl,
                                         const float* dxp, const int* n_pts, int wk, int L,
                                         float* dx, void* stream) {
  if (wk < 1 || wk > MAX_WK || L < 1) return (int)cudaErrorInvalidValue;
  ba_backsub_kernel<<<(L + PT_THREADS - 1) / PT_THREADS, PT_THREADS, 0, (cudaStream_t)stream>>>(
      Wc, Hinv, bl, dxp, n_pts, wk, L, dx);
  return (int)cudaGetLastError();
}
