// The first design of the masked Hamming top-2 (csrc/match.cu as PRs 1-5 left
// it: one warp per row, 8 rows per block, every block staging all columns in
// 256-column chunks behind two barriers each), kept so that
// perf/kernel_split.py can time its parts beside the current csrc/match.cu on
// the same inputs in one run. Not used by the package.
//
// masked_top2_v1_launch(..., mode): 0 the whole kernel; 1 the staging alone
// (every row leaves the lane loop at once; the merge and the stores stay).
//
// Masked 256-bit Hamming top-2 search (projection matching and fuse).
//
// Replaces the TPU kernels in vo_slam_test_tpu/ops/match_pallas.py:
//   - masked_top2_pallas with chi2_gate=False (projection search, local map);
//   - masked_top2_pallas with chi2_gate=True (fuse_into_keyframe);
//   - masked_top2_nb_pallas (fuse_curr_into_neighbors: B independent searches
//     in one launch).
// Plain versions: ops/match_pallas.py::masked_top2_plain / masked_top2_nb_plain
// (the masked_top2_xla oracle).
//
// What it computes: for each source row i, over the target columns j with
//   allowed[i,j] = row_ok[i] & col_ok[j]
//                & |col_u[j]-row_u[i]| < row_rw[i] & |col_v[j]-row_v[i]| < row_rw[i]
//                & row_lo[i] <= col_oct[j] <= row_hi[i]
//                & GATE
//   GATE (chi2 off) = col_ur[j] <= 0 | |row_ur[i]-col_ur[j]| <= row_rur[i]
//   GATE (chi2 on)  = err * col_isig2[j] <= (stereo ? 7.815f : 5.991f),
//                     stereo = col_ur[j] >= 0, err = du*du + dv*dv
//                     (+ dur*dur, dur = row_ur[i]-col_ur[j], when stereo)
// the best and second-best Hamming distance popc(a[i] ^ b[j]), ties to the
// lowest column. The oracle's argmin over a BIG-filled matrix gives a row with
// no allowed pair (0, BIG, 0, BIG) and a row with one allowed pair a second of
// (0, BIG); the kernel returns the same.
//
// Bound on this card: operations. The inputs are ~130-300 KB (tens of
// nanoseconds of bandwidth) while each live pair (row_ok and col_ok) needs
// ~10 gate instructions, most of them compares at the ALU rate (half the f32
// add rate), and each allowed pair 8 XOR + 8 popc (popc at an eighth of the
// f32 add rate) + a top-2 update. Design:
//   - one warp per source row, 8 rows per block; the row's descriptor and gate
//     parameters live in registers;
//   - target descriptors (32 B each) and column parameters are staged in
//     shared memory in chunks of 256 columns, read once per block;
//   - the gate is evaluated before the popcounts, so disallowed pairs cost no
//     popc. The chi2 error is rounded op by op (__fmul_rn/__fadd_rn) as the
//     plain version rounds it: nvcc would contract du*du + dv*dv into an FMA
//     and move pairs that sit on the bound. The bounds are float literals, so
//     the compare stays in f32 like the oracle's;
//   - each lane keeps a running top-2 of unique keys (dist << 22 | column),
//     whose unsigned order is (distance, lowest column); a butterfly of
//     shuffles merges the 32 lanes' disjoint top-2 lists;
//   - the neighbour axis of the batched form is blockIdx.y: it offsets every
//     pointer by that neighbour's stride, so no concatenated copies are made.
//     The source descriptors take their own stride, 0 when all neighbours
//     share one source set (fuse_curr_into_neighbors).

#include <cuda_runtime.h>

#define BIG (1 << 20)
#define CHUNK 256
#define ROWS 8
#define NONE 0xffffffffu
#define COL_BITS 22

template <bool CHI2>
__global__ void __launch_bounds__(ROWS * 32)
masked_top2_kernel(const int* __restrict__ a, long long a_bstride, const int* __restrict__ b,
                   const float* __restrict__ row_u, const float* __restrict__ row_v,
                   const float* __restrict__ row_rw, const float* __restrict__ row_ur,
                   const float* __restrict__ row_rur, const int* __restrict__ row_lo,
                   const int* __restrict__ row_hi, const unsigned char* __restrict__ row_ok,
                   const float* __restrict__ col_u, const float* __restrict__ col_v,
                   const float* __restrict__ col_ur, const int* __restrict__ col_oct,
                   const unsigned char* __restrict__ col_ok, const float* __restrict__ col_isig2,
                   int M, int N, int* __restrict__ best_i, int* __restrict__ best_d,
                   int* __restrict__ second_i, int* __restrict__ second_d, int mode) {
  __shared__ uint4 sb[CHUNK][2];
  __shared__ float su[CHUNK], sv[CHUNK], sur[CHUNK], sisig[CHUNK];
  __shared__ int soct[CHUNK];
  __shared__ unsigned char sok[CHUNK];

  // neighbour offsets (blockIdx.y = 0 for a single search)
  const long long nb = blockIdx.y;
  a += nb * a_bstride * 8;
  b += nb * (long long)N * 8;
  const long long ro = nb * (long long)M, co = nb * (long long)N;
  row_u += ro; row_v += ro; row_rw += ro; row_ur += ro; row_rur += ro;
  row_lo += ro; row_hi += ro; row_ok += ro;
  col_u += co; col_v += co; col_ur += co; col_oct += co; col_ok += co;
  if (CHI2) col_isig2 += co;
  best_i += ro; best_d += ro; second_i += ro; second_d += ro;

  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const bool has_row = r < M;
  const bool rok = has_row && row_ok[r];
  uint4 ra0 = make_uint4(0, 0, 0, 0), ra1 = ra0;
  float ru = 0.f, rv = 0.f, rw = 0.f, rur = 0.f, rrur = 0.f;
  int lo = 0, hi = -1;
  if (rok) {
    ra0 = reinterpret_cast<const uint4*>(a)[2 * r];
    ra1 = reinterpret_cast<const uint4*>(a)[2 * r + 1];
    ru = row_u[r]; rv = row_v[r]; rw = row_rw[r]; rur = row_ur[r]; rrur = row_rur[r];
    lo = row_lo[r]; hi = row_hi[r];
  }

  unsigned k1 = NONE, k2 = NONE;
  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    __syncthreads();
    for (int j = threadIdx.x; j < CHUNK; j += ROWS * 32) {
      const int c = c0 + j;
      if (c < N) {
        sb[j][0] = reinterpret_cast<const uint4*>(b)[2 * c];
        sb[j][1] = reinterpret_cast<const uint4*>(b)[2 * c + 1];
        su[j] = col_u[c]; sv[j] = col_v[c]; sur[j] = col_ur[c];
        if (CHI2) sisig[j] = col_isig2[c];
        soct[j] = col_oct[c]; sok[j] = col_ok[c];
      } else {
        sok[j] = 0;
      }
    }
    __syncthreads();
    if (!rok || mode == 1) continue;
    for (int j = lane; j < CHUNK; j += 32) {
      if (!sok[j]) continue;
      const float du = su[j] - ru;
      const float dv = sv[j] - rv;
      const float cur = sur[j];
      bool allowed = (fabsf(du) < rw) & (fabsf(dv) < rw) & (soct[j] >= lo) & (soct[j] <= hi);
      if (CHI2) {
        const float e2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        const float dur = rur - cur;
        const float e2s = __fadd_rn(e2, __fmul_rn(dur, dur));
        allowed &= (cur >= 0.0f) ? (__fmul_rn(e2s, sisig[j]) <= 7.815f)
                                 : (__fmul_rn(e2, sisig[j]) <= 5.991f);
      } else {
        allowed &= (cur <= 0.0f) | (fabsf(rur - cur) <= rrur);
      }
      if (!allowed) continue;
      const uint4 b0 = sb[j][0], b1 = sb[j][1];
      const unsigned d = __popc(ra0.x ^ b0.x) + __popc(ra0.y ^ b0.y) + __popc(ra0.z ^ b0.z) +
                         __popc(ra0.w ^ b0.w) + __popc(ra1.x ^ b1.x) + __popc(ra1.y ^ b1.y) +
                         __popc(ra1.z ^ b1.z) + __popc(ra1.w ^ b1.w);
      const unsigned key = (d << COL_BITS) | (unsigned)(c0 + j);
      if (key < k1) {
        k2 = k1;
        k1 = key;
      } else if (key < k2) {
        k2 = key;
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    const unsigned n2 = min(max(k1, o1), min(k2, o2));
    k1 = min(k1, o1);
    k2 = n2;
  }
  if (lane == 0 && has_row) {
    const unsigned mask = (1u << COL_BITS) - 1u;
    best_i[r] = k1 == NONE ? 0 : (int)(k1 & mask);
    best_d[r] = k1 == NONE ? BIG : (int)(k1 >> COL_BITS);
    second_i[r] = k2 == NONE ? 0 : (int)(k2 & mask);
    second_d[r] = k2 == NONE ? BIG : (int)(k2 >> COL_BITS);
  }
}

// B independent searches in one launch (neighbour axis = blockIdx.y; B = 1 for
// one search). a_bstride is the source rows between neighbours (0: one shared
// source set); chi2 selects the gate; col_isig2 is read only in chi2 mode.
extern "C" int masked_top2_v1_launch(
    const int* a, long long a_bstride, const int* b, const float* row_u, const float* row_v,
    const float* row_rw, const float* row_ur, const float* row_rur, const int* row_lo,
    const int* row_hi, const unsigned char* row_ok, const float* col_u, const float* col_v,
    const float* col_ur, const int* col_oct, const unsigned char* col_ok,
    const float* col_isig2, int chi2, int B, int M, int N, int* best_i, int* best_d,
    int* second_i, int* second_d, int mode, void* stream) {
  if (M > 0 && B > 0) {
    const dim3 grid((M + ROWS - 1) / ROWS, B);
    if (chi2) {
      masked_top2_kernel<true><<<grid, ROWS * 32, 0, (cudaStream_t)stream>>>(
          a, a_bstride, b, row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
          col_u, col_v, col_ur, col_oct, col_ok, col_isig2, M, N, best_i, best_d, second_i,
          second_d, mode);
    } else {
      masked_top2_kernel<false><<<grid, ROWS * 32, 0, (cudaStream_t)stream>>>(
          a, a_bstride, b, row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
          col_u, col_v, col_ur, col_oct, col_ok, col_isig2, M, N, best_i, best_d, second_i,
          second_d, mode);
    }
  }
  return (int)cudaGetLastError();
}
