// Variants of the point back-substitution of csrc/ba.cu (ba_backsub_kernel),
// timed by perf/kernel_split.py beside it on the same inputs. Not used by the
// package. Both walk the set bits of a live point's window mask word as the
// kernel does, with the same FMAs in the same order (so both give its bits),
// at a block size given at launch:
//   - rec_rows 0: the 18 Wc values of a set slot, strided by L (the kernel's
//     read; neighbouring points that share a slot read neighbouring words);
//   - rec_rows 1: the same values from the slot's record in ba_accumulate's
//     scratch (rec [wk, L, 132], Wc's rows padded to float4 at float 108: 96
//     contiguous bytes per point, written by the same ba_accumulate call).
// A pose step with NaN or inf walks every slot of Wc, as the kernel does.

#include <cuda_runtime.h>

#define MAX_WK 32
#define REC 132
#define REC_WC 108
#define FULL 0xffffffffu

template <bool REC_ROWS>
__global__ void __launch_bounds__(256)
backsub_variant_kernel(const float* __restrict__ Wc, const float* __restrict__ rec,
                       const float* __restrict__ Hinv, const float* __restrict__ bl,
                       const float* __restrict__ dxp, const unsigned* __restrict__ mask,
                       const int* __restrict__ n_pts, int wk, int L, float* __restrict__ dx) {
  __shared__ float sdx[MAX_WK * 6];
  const int t = threadIdx.x, lane = t & 31;
  const int l = blockIdx.x * blockDim.x + t;
  const unsigned slots = wk == 32 ? FULL : (1u << wk) - 1u;
  unsigned m = 0u;
  bool live = false;
  float tv[3] = {0.f, 0.f, 0.f}, h[9];
  if (l < L) {
    m = mask[l] & slots;
    live = l < *n_pts;
#pragma unroll
    for (int k = 0; k < 3; ++k) tv[k] = bl[k * L + l];
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = Hinv[k * L + l];
  }
  for (int i = t; i < wk * 6; i += blockDim.x) sdx[i] = dxp[i];
  __syncthreads();
  bool fin = true, pos = false;
  if (lane < wk) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float d = sdx[lane * 6 + i];
      fin = fin && isfinite(d);
      pos = pos || !signbit(d);
    }
  }
  const bool finite = __all_sync(FULL, fin);
  const unsigned pos_slots = __ballot_sync(FULL, pos);
  if (l >= L) return;
  if (live) {
    for (unsigned b = finite ? m : slots; b; b &= b - 1) {
      const int a = __ffs(b) - 1;
      if (REC_ROWS && finite) {
        const float4* r = reinterpret_cast<const float4*>(rec + ((size_t)a * L + l) * REC + REC_WC);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float4 w = r[i];
          const float d = sdx[a * 6 + i];
          tv[0] += w.x * d;
          tv[1] += w.y * d;
          tv[2] += w.z * d;
        }
      } else {
        const float* wc = Wc + (size_t)a * 18 * L + l;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float d = sdx[a * 6 + i];
#pragma unroll
          for (int k = 0; k < 3; ++k) tv[k] += wc[(i * 3 + k) * L] * d;
        }
      }
    }
    if (finite && (pos_slots & ~m & slots)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tv[k] = __fadd_rn(tv[k], 0.0f);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dx[i * L + l] = -(h[i * 3] * tv[0] + h[i * 3 + 1] * tv[1] + h[i * 3 + 2] * tv[2]);
}

extern "C" int ba_backsub_variant_launch(const float* Wc, const float* rec, const float* Hinv,
                                         const float* bl, const float* dxp, const unsigned* mask,
                                         const int* n_pts, int wk, int L, int threads,
                                         int rec_rows, float* dx, void* stream) {
  if (wk < 1 || wk > MAX_WK || L < 1 || threads < 32 || threads > 256 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int blocks = (L + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (rec_rows)
    backsub_variant_kernel<true><<<blocks, threads, 0, st>>>(Wc, rec, Hinv, bl, dxp, mask, n_pts,
                                                             wk, L, dx);
  else
    backsub_variant_kernel<false><<<blocks, threads, 0, st>>>(Wc, rec, Hinv, bl, dxp, mask, n_pts,
                                                              wk, L, dx);
  return (int)cudaGetLastError();
}
