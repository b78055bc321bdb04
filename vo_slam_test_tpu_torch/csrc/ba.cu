// Local-BA Levenberg-Marquardt iteration: normal equations + Schur reduction,
// the robust cost alone, and the point back-substitution.
//
// Replaces the TPU kernels in vo_slam_test_tpu/ops/ba_pallas.py:
//   - ba_accumulate (_make_acc_kernel): ba_accumulate_launch;
//   - ba_cost (_make_cost_kernel): ba_cost_launch;
//   - ba_backsub (_make_backsub_kernel): ba_backsub_launch.
// Plain versions: ops/ba_pallas.py::ba_accumulate_plain / ba_cost_plain /
// ba_backsub_plain. Layout (f32 unless noted, point axis L last): posesT
// [16,WF], X [3,L], slot [O,L] i32 (-1 none), u, v, ur, isig2, act, povar
// [O,L]; outputs Hpp [wk,36], bp [wk,6], S_red [wk*6,wk*6], rhs_red [wk*6],
// cost [1], Hinv [9,L], bl [3,L], Wc [wk,18,L].
//
// Bound on this card: operations at the path's sizes. A keyframe event's
// problem holds ~1.5k live points of L = 8192 slots with up to 12 observers
// each: a few MB of inputs and Wc rows (~1 us of bandwidth) against ~300
// f32 instructions per observation (residual, Jacobians, the 6x6 pose block)
// and ~160 per pair of window observers of a point (its Schur block). Design:
//   - the TPU kernel sums Hpp, bp, S_red, rhs_red and the cost across its
//     sequential grid. Here blocks run in no order, so no float is summed
//     with atomics: every cross-point sum is owned by one block, which walks
//     the points in a fixed order (thread t takes points t, t+128, ...) and
//     then adds its 128 partials in a fixed tree in shared memory. Two
//     launches on the same inputs give the same bits;
//   - launch 1 (ba_point_kernel), one thread per point: the residuals,
//     Jacobians, Hll, the damped closed-form inverse Hinv, bl, the point's
//     cost and its Wc rows, and a bit mask of the window slots that observe
//     it (wk <= 32). Only the Wc rows of those slots are written: Wc stays
//     allocated and zero elsewhere across the iterations of one BA call;
//   - launch 2 (ba_reduce_kernel), grid (wk, wk+1): block (a, b < wk) sums
//     S_red's 6x6 block (a, b) = sum_l Wc_a Hinv Wc_b^T over the points whose
//     mask holds both slots; block (a, wk) sums Hpp, bp and rhs_red of slot a,
//     recomputing the Jacobians of the observations by slot a; block (0, wk)
//     also sums the per-point costs. Each block reads one mask word per point
//     and skips the rest, so the work follows the observer pairs, not a dense
//     [wk*6, L] x [L, wk*6] product;
//   - every loop over points stops at n_pts (the count of live points,
//     compacted first by the problem builder; a device int, no host read);
//   - the cost (launch 1 and ba_cost_launch) is rounded op by op
//     (__fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn) and summed by the same
//     device functions in the same order, so the LM accept test compares two
//     sums of one fixed order: equal inputs give equal costs.

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

// analytic Jacobians scaled by isig: pose Jp [3][6] (twist rho, phi), point Jl [3][3]
__device__ __forceinline__ void jacobians(const Obs& ob, const float* __restrict__ cam,
                                          float Jp[3][6], float Jl[3][3]) {
  const float fx = cam[0], fy = cam[1], bf = cam[4];
  const float x = ob.pcx, y = ob.pcy, z = ob.pcz, iz = ob.invz, iz2 = iz * iz;
  const float st = ob.stereo ? 1.0f : 0.0f;
  const float dp[3][3] = {{fx * iz, 0.0f, -fx * x * iz2},
                          {0.0f, fy * iz, -fy * y * iz2},
                          {fx * iz * st, 0.0f, (-fx * x * iz2 + bf * iz2) * st}};
  const float dpc[3][6] = {{1.0f, 0.0f, 0.0f, 0.0f, z, -y},
                           {0.0f, 1.0f, 0.0f, -z, 0.0f, x},
                           {0.0f, 0.0f, 1.0f, y, -x, 0.0f}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      Jp[r][c] = ob.isig * (dp[r][0] * dpc[0][c] + dp[r][1] * dpc[1][c] + dp[r][2] * dpc[2][c]);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Jl[r][j] = ob.isig * (dp[r][0] * ob.R[j] + dp[r][1] * ob.R[3 + j] + dp[r][2] * ob.R[6 + j]);
  }
}

// the point's cost over its observers in slot order (shared by launch 1 and
// ba_cost_launch, so both give the same bits)
__device__ __forceinline__ float add_cost(float cost, float a, float rho) {
  return a > 0.0f ? __fadd_rn(cost, rho) : cost;
}

// fixed-order sum of NV per-thread partials: sh[v][0] holds the block's sum
template <int NV>
__device__ __forceinline__ void block_reduce(const float (&acc)[NV],
                                             float (*sh)[RED_THREADS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int v = 0; v < NV; ++v) sh[v][t] = acc[v];
  __syncthreads();
  for (int stride = RED_THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
#pragma unroll
      for (int v = 0; v < NV; ++v) sh[v][t] = __fadd_rn(sh[v][t], sh[v][t + stride]);
    }
    __syncthreads();
  }
}

// the per-point costs summed in a fixed order (one block of RED_THREADS)
__device__ __forceinline__ float cost_sum(const float* __restrict__ cost_pt, int n,
                                          float (*sh)[RED_THREADS]) {
  float acc[1] = {0.0f};
  for (int l = threadIdx.x; l < n; l += RED_THREADS) acc[0] = __fadd_rn(acc[0], cost_pt[l]);
  block_reduce<1>(acc, sh);
  return sh[0][0];
}

__global__ void __launch_bounds__(PT_THREADS)
ba_point_kernel(const float* __restrict__ lam_p, const float* __restrict__ cam,
                const float* __restrict__ posesT, const float* __restrict__ X,
                const int* __restrict__ slot, const float* __restrict__ u,
                const float* __restrict__ v, const float* __restrict__ ur,
                const float* __restrict__ isig2, const float* __restrict__ act,
                const float* __restrict__ povar, int WF, int wk, int O, int L, int huber,
                float* __restrict__ Hinv, float* __restrict__ bl, float* __restrict__ Wc,
                float* __restrict__ cost_pt, unsigned* __restrict__ mask) {
  const int l = blockIdx.x * PT_THREADS + threadIdx.x;
  if (l >= L) return;
  const float x = X[l], y = X[L + l], z = X[2 * L + l];

  // the window slots that observe this point: zero their Wc rows first
  unsigned msk = 0u;
  for (int o = 0; o < O; ++o) {
    const int s = slot[o * L + l];
    if (s >= 0 && s < wk && povar[o * L + l] != 0.0f && !((msk >> s) & 1u)) {
      msk |= 1u << s;
      for (int r = 0; r < 18; ++r) Wc[((size_t)s * 18 + r) * L + l] = 0.0f;
    }
  }

  float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, b[3] = {0.f, 0.f, 0.f}, cost = 0.0f;
  for (int o = 0; o < O; ++o) {
    const int s = slot[o * L + l];
    if (s < 0) continue;
    const int i0 = o * L + l;
    Obs ob;
    const float s2 = observe(posesT, WF, s, x, y, z, u[i0], v[i0], ur[i0], isig2[i0], cam, ob);
    float wrob;
    const float rho = robust(s2, ob.stereo, huber, wrob);
    const float a = act[i0];
    cost = add_cost(cost, a, rho);
    const float w = a * wrob;
    if (w == 0.0f) continue;
    float Jp[3][6], Jl[3][3];
    jacobians(ob, cam, Jp, Jl);
    int k = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b[i] += w * (Jl[0][i] * ob.ew[0] + Jl[1][i] * ob.ew[1] + Jl[2][i] * ob.ew[2]);
#pragma unroll
      for (int j = i; j < 3; ++j, ++k)
        h[k] += w * (Jl[0][i] * Jl[0][j] + Jl[1][i] * Jl[1][j] + Jl[2][i] * Jl[2][j]);
    }
    const float pv = povar[i0];
    if (s < wk && pv != 0.0f) {
      float* wc = Wc + (size_t)s * 18 * L + l;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wc[(i * 3 + j) * L] +=
              pv * (w * (Jp[0][i] * Jl[0][j] + Jp[1][i] * Jl[1][j] + Jp[2][i] * Jl[2][j]));
    }
  }

  // damped closed-form inverse of the symmetric block (the TPU kernel's form)
  const float lam = *lam_p;
  const float a_ = h[0] + lam + 1e-8f, b_ = h[1], c_ = h[2];
  const float e_ = h[3] + lam + 1e-8f, f_ = h[4], i_ = h[5] + lam + 1e-8f;
  const float A = e_ * i_ - f_ * f_;
  const float B = -(b_ * i_ - f_ * c_);
  const float C3 = b_ * f_ - e_ * c_;
  const float det = a_ * A + b_ * B + c_ * C3;
  const float idet = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  const float hv[9] = {A * idet, B * idet, C3 * idet,
                       B * idet, (a_ * i_ - c_ * c_) * idet, -(a_ * f_ - c_ * b_) * idet,
                       C3 * idet, -(a_ * f_ - b_ * c_) * idet, (a_ * e_ - b_ * b_) * idet};
#pragma unroll
  for (int r = 0; r < 9; ++r) Hinv[r * L + l] = hv[r];
#pragma unroll
  for (int r = 0; r < 3; ++r) bl[r * L + l] = b[r];
  cost_pt[l] = cost;
  mask[l] = msk;
}

__global__ void __launch_bounds__(RED_THREADS)
ba_reduce_kernel(const float* __restrict__ cam, const float* __restrict__ posesT,
                 const float* __restrict__ X, const int* __restrict__ slot,
                 const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ ur, const float* __restrict__ isig2,
                 const float* __restrict__ act, const float* __restrict__ povar,
                 const int* __restrict__ n_pts, int WF, int wk, int O, int L, int huber,
                 const float* __restrict__ Hinv, const float* __restrict__ bl,
                 const float* __restrict__ Wc, const float* __restrict__ cost_pt,
                 const unsigned* __restrict__ mask, float* __restrict__ Hpp,
                 float* __restrict__ bp, float* __restrict__ S_red, float* __restrict__ rhs,
                 float* __restrict__ cost) {
  __shared__ float sh[48][RED_THREADS];
  const int a = blockIdx.x, col = blockIdx.y, t = threadIdx.x;
  const int n = min(*n_pts, L);
  const size_t slab = (size_t)18 * L;

  if (col < wk) {
    // S_red block (a, col) = sum_l (Wc_a Hinv) Wc_col^T
    const unsigned both = (1u << a) | (1u << col);
    float acc[36];
#pragma unroll
    for (int k = 0; k < 36; ++k) acc[k] = 0.0f;
    for (int l = t; l < n; l += RED_THREADS) {
      if ((mask[l] & both) != both) continue;
      float wa[18], wb[18], hi[9];
#pragma unroll
      for (int r = 0; r < 18; ++r) {
        wa[r] = Wc[a * slab + (size_t)r * L + l];
        wb[r] = Wc[col * slab + (size_t)r * L + l];
      }
#pragma unroll
      for (int r = 0; r < 9; ++r) hi[r] = Hinv[r * L + l];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float wh0 = wa[i * 3] * hi[0] + wa[i * 3 + 1] * hi[3] + wa[i * 3 + 2] * hi[6];
        const float wh1 = wa[i * 3] * hi[1] + wa[i * 3 + 1] * hi[4] + wa[i * 3 + 2] * hi[7];
        const float wh2 = wa[i * 3] * hi[2] + wa[i * 3 + 1] * hi[5] + wa[i * 3 + 2] * hi[8];
#pragma unroll
        for (int m = 0; m < 6; ++m)
          acc[i * 6 + m] += wh0 * wb[m * 3] + wh1 * wb[m * 3 + 1] + wh2 * wb[m * 3 + 2];
      }
    }
    block_reduce<36>(acc, sh);
    if (t < 36) S_red[(size_t)(a * 6 + t / 6) * (wk * 6) + col * 6 + t % 6] = sh[t][0];
    return;
  }

  // slot a's pose block Hpp (36), gradient bp (6) and Schur right side (6)
  float acc[48];
#pragma unroll
  for (int k = 0; k < 48; ++k) acc[k] = 0.0f;
  for (int l = t; l < n; l += RED_THREADS) {
    if (!((mask[l] >> a) & 1u)) continue;
    float hi[9], bv[3];
#pragma unroll
    for (int r = 0; r < 9; ++r) hi[r] = Hinv[r * L + l];
#pragma unroll
    for (int r = 0; r < 3; ++r) bv[r] = bl[r * L + l];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float whb = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float wh = Wc[a * slab + (size_t)(i * 3) * L + l] * hi[k] +
                         Wc[a * slab + (size_t)(i * 3 + 1) * L + l] * hi[3 + k] +
                         Wc[a * slab + (size_t)(i * 3 + 2) * L + l] * hi[6 + k];
        whb += wh * bv[k];
      }
      acc[42 + i] += whb;
    }
    const float x = X[l], y = X[L + l], z = X[2 * L + l];
    for (int o = 0; o < O; ++o) {
      const int i0 = o * L + l;
      const float pv = povar[i0];
      if (slot[i0] != a || pv == 0.0f) continue;
      Obs ob;
      const float s2 = observe(posesT, WF, a, x, y, z, u[i0], v[i0], ur[i0], isig2[i0], cam, ob);
      float wrob;
      robust(s2, ob.stereo, huber, wrob);
      const float w = act[i0] * wrob;
      if (w == 0.0f) continue;
      float Jp[3][6], Jl[3][3];
      jacobians(ob, cam, Jp, Jl);
      const float pw = pv * w;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          acc[i * 6 + j] += pw * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] + Jp[2][i] * Jp[2][j]);
        acc[36 + i] += pw * (Jp[0][i] * ob.ew[0] + Jp[1][i] * ob.ew[1] + Jp[2][i] * ob.ew[2]);
      }
    }
  }
  block_reduce<48>(acc, sh);
  if (t < 36) Hpp[a * 36 + t] = sh[t][0];
  if (t < 6) {
    bp[a * 6 + t] = sh[36 + t][0];
    rhs[a * 6 + t] = sh[42 + t][0];
  }
  if (a == 0) {
    __syncthreads();
    const float c = cost_sum(cost_pt, n, sh);
    if (t == 0) cost[0] = c;
  }
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
  __shared__ float sh[1][RED_THREADS];
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

// One LM iteration's normal equations + Schur reduction: two launches.
// Scratch: cost_pt [L] f32, mask [L] u32. Wc is read-modify-written in the
// rows of the observing window slots only (zero it once per problem).
extern "C" int ba_accumulate_launch(
    const float* lam, const float* cam, const float* posesT, const float* X, const int* slot,
    const float* u, const float* v, const float* ur, const float* isig2, const float* act,
    const float* povar, const int* n_pts, int WF, int wk, int O, int L, int huber, float* Hpp,
    float* bp, float* S_red, float* rhs, float* cost, float* Hinv, float* bl, float* Wc,
    float* cost_pt, unsigned* mask, void* stream) {
  if (wk < 1 || wk > MAX_WK || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ba_point_kernel<<<(L + PT_THREADS - 1) / PT_THREADS, PT_THREADS, 0, st>>>(
      lam, cam, posesT, X, slot, u, v, ur, isig2, act, povar, WF, wk, O, L, huber, Hinv, bl, Wc,
      cost_pt, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ba_reduce_kernel<<<dim3(wk, wk + 1), RED_THREADS, 0, st>>>(
      cam, posesT, X, slot, u, v, ur, isig2, act, povar, n_pts, WF, wk, O, L, huber, Hinv, bl,
      Wc, cost_pt, mask, Hpp, bp, S_red, rhs, cost);
  return (int)cudaGetLastError();
}

// The robust cost alone: per-point costs, then the fixed-order sum.
extern "C" int ba_cost_launch(const float* cam, const float* posesT, const float* X,
                              const int* slot, const float* u, const float* v, const float* ur,
                              const float* isig2, const float* act, const int* n_pts, int WF,
                              int O, int L, int huber, float* cost, float* cost_pt,
                              void* stream) {
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
extern "C" int ba_backsub_launch(const float* Wc, const float* Hinv, const float* bl,
                                 const float* dxp, const int* n_pts, int wk, int L, float* dx,
                                 void* stream) {
  if (wk < 1 || wk > MAX_WK || L < 1) return (int)cudaErrorInvalidValue;
  ba_backsub_kernel<<<(L + PT_THREADS - 1) / PT_THREADS, PT_THREADS, 0, (cudaStream_t)stream>>>(
      Wc, Hinv, bl, dxp, n_pts, wk, L, dx);
  return (int)cudaGetLastError();
}
