// The first design of the epipolar top-1 (csrc/epi.cu as it was first
// written: one warp per row, 8 rows per block, every block staging all columns
// in 256-column chunks behind two barriers each), kept so that
// perf/kernel_split.py and chip_smoke.py can time it beside the current
// csrc/epi.cu on the same inputs in one run. Not used by the package.
//
// masked_top1_epi_v1_launch(..., mode): 0 the whole kernel; 1 the staging
// alone (every row leaves the lane loop at once; the merge and the stores
// stay).
//
// Epipolar-gated masked 256-bit Hamming top-1 search (triangulation).
//
// Replaces the TPU kernel vo_slam_test_tpu/ops/match_pallas.py:
// masked_top1_epi_pallas (_make_epi_kernel). Plain version:
// ops/match_pallas.py::masked_top1_epi_plain (the masked_top1_epi_xla oracle).
//
// What it computes: for each kp1 row i of the new keyframe, over the kp2
// columns j of one neighbour keyframe with
//   num = (lx[i]*u[j] + ly[i]*v[j]) + lz[i]
//   allowed[i,j] = row_ok[i] & col_ok[j] & num*num < den[i]*thr[j]
//                & (g1[i] == g2[j] | g1[i] < 0 | g2[j] < 0)
//                & !(row_mono[i] & col_flag[j])
// the lowest Hamming distance popc(a[i] ^ b[j]), ties to the lowest column;
// (0, BIG) for a row with no allowed pair, as the oracle's argmin over a
// BIG-filled matrix gives.
//
// Bound on this card: operations (the inputs are ~90 KB at 1024 x 1024; every
// live pair needs ~11 gate instructions, the allowed ones 8 XOR + 8 popc, popc
// at an eighth of the f32 add rate). Design:
// the skeleton of csrc/match.cu (one warp per kp1 row, 8 rows per block, kp2
// descriptors and column parameters staged in shared memory in chunks of 256,
// gate before popcount, packed (dist << 22 | column) keys merged by a shuffle
// butterfly) with a top-1 reduction. The line gate is rounded op by op in the
// oracle's order (__fmul_rn/__fadd_rn): a contracted FMA would move pairs
// that sit on the num^2 = den*thr boundary.

#include <cuda_runtime.h>

#define BIG (1 << 20)
#define CHUNK 256
#define ROWS 8
#define NONE 0xffffffffu
#define COL_BITS 22

__global__ void __launch_bounds__(ROWS * 32)
masked_top1_epi_v1_kernel(const int* __restrict__ a, const int* __restrict__ b,
                       const float* __restrict__ row_l, const float* __restrict__ row_den,
                       const int* __restrict__ row_g, const unsigned char* __restrict__ row_ok,
                       const unsigned char* __restrict__ row_mono,
                       const float* __restrict__ col_u, const float* __restrict__ col_v,
                       const float* __restrict__ col_thr, const int* __restrict__ col_g,
                       const unsigned char* __restrict__ col_ok,
                       const unsigned char* __restrict__ col_flag, int M, int N,
                       int* __restrict__ best_i, int* __restrict__ best_d, int mode) {
  __shared__ uint4 sb[CHUNK][2];
  __shared__ float su[CHUNK], sv[CHUNK], sthr[CHUNK];
  __shared__ int sg[CHUNK];
  __shared__ unsigned char sok[CHUNK], sflag[CHUNK];

  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const bool has_row = r < M;
  const bool rok = has_row && row_ok[r];
  uint4 ra0 = make_uint4(0, 0, 0, 0), ra1 = ra0;
  float lx = 0.f, ly = 0.f, lz = 0.f, den = 0.f;
  int g = -1;
  bool mono = false;
  if (rok) {
    ra0 = reinterpret_cast<const uint4*>(a)[2 * r];
    ra1 = reinterpret_cast<const uint4*>(a)[2 * r + 1];
    lx = row_l[3 * r]; ly = row_l[3 * r + 1]; lz = row_l[3 * r + 2];
    den = row_den[r]; g = row_g[r]; mono = row_mono[r] != 0;
  }

  unsigned k1 = NONE;
  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    __syncthreads();
    for (int j = threadIdx.x; j < CHUNK; j += ROWS * 32) {
      const int c = c0 + j;
      if (c < N) {
        sb[j][0] = reinterpret_cast<const uint4*>(b)[2 * c];
        sb[j][1] = reinterpret_cast<const uint4*>(b)[2 * c + 1];
        su[j] = col_u[c]; sv[j] = col_v[c]; sthr[j] = col_thr[c];
        sg[j] = col_g[c]; sok[j] = col_ok[c]; sflag[j] = col_flag[c];
      } else {
        sok[j] = 0;
      }
    }
    __syncthreads();
    if (!rok || mode == 1) continue;
    for (int j = lane; j < CHUNK; j += 32) {
      if (!sok[j]) continue;
      const float num = __fadd_rn(__fadd_rn(__fmul_rn(lx, su[j]), __fmul_rn(ly, sv[j])), lz);
      const int cg = sg[j];
      const bool allowed = (__fmul_rn(num, num) < __fmul_rn(den, sthr[j])) &
                           ((g == cg) | (g < 0) | (cg < 0)) & !(mono & (sflag[j] != 0));
      if (!allowed) continue;
      const uint4 b0 = sb[j][0], b1 = sb[j][1];
      const unsigned d = __popc(ra0.x ^ b0.x) + __popc(ra0.y ^ b0.y) + __popc(ra0.z ^ b0.z) +
                         __popc(ra0.w ^ b0.w) + __popc(ra1.x ^ b1.x) + __popc(ra1.y ^ b1.y) +
                         __popc(ra1.z ^ b1.z) + __popc(ra1.w ^ b1.w);
      k1 = min(k1, (d << COL_BITS) | (unsigned)(c0 + j));
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    k1 = min(k1, __shfl_xor_sync(0xffffffffu, k1, off));
  }
  if (lane == 0 && has_row) {
    best_i[r] = k1 == NONE ? 0 : (int)(k1 & ((1u << COL_BITS) - 1u));
    best_d[r] = k1 == NONE ? BIG : (int)(k1 >> COL_BITS);
  }
}

extern "C" int masked_top1_epi_v1_launch(
    const int* a, const int* b, const float* row_l, const float* row_den, const int* row_g,
    const unsigned char* row_ok, const unsigned char* row_mono, const float* col_u,
    const float* col_v, const float* col_thr, const int* col_g, const unsigned char* col_ok,
    const unsigned char* col_flag, int M, int N, int* best_i, int* best_d, int mode, void* stream) {
  if (M > 0) {
    masked_top1_epi_v1_kernel<<<(M + ROWS - 1) / ROWS, ROWS * 32, 0, (cudaStream_t)stream>>>(
        a, b, row_l, row_den, row_g, row_ok, row_mono, col_u, col_v, col_thr, col_g, col_ok,
        col_flag, M, N, best_i, best_d, mode);
  }
  return (int)cudaGetLastError();
}
