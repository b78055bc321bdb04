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
// Bound on this card: operations on the live pairs (~10 gate instructions
// each), and 8 XOR + 8 popc on the allowed ones. On the main path few pairs
// pass the window (0.1-0.6%), few rows are live, and a block's time is a
// chain of dependent steps. The first design (perf/match_v1.cu) gated every
// column for every row, and every block, dead or live, staged all columns in
// 256-column chunks behind two barriers each (perf/kernel_split.py takes both
// apart). Design:
//   - one row per warp, WARPS rows per block. Each warp loads its row's flag,
//     gate parameters and descriptor at once; a block with no live row writes
//     the empty answer (0, BIG, 0, BIG) and leaves before it stages anything;
//   - a live block sorts the columns by band of col_v (NB bands of BAND_PX px;
//     below 0 into band 0, past the last into the last) in shared memory, CAP
//     columns at a time: every load first, then a counting sort (shared
//     atomics for the slots, one warp's scan, a scatter). Only live columns
//     with finite u and v are kept: the others pass no window;
//   - a row visits one contiguous range of the sorted columns: the bands that
//     [row_v - row_rw, row_v + row_rw] meets, widened by (|row_v| + row_rw) *
//     2^-20 (more than the rounding of the f32 window test can move a column)
//     and one more band on each side, and it re-evaluates the exact gate on
//     each column it visits. band_of is monotone and clamps with compares in
//     f32 before any conversion to int, so coordinates outside the bands and
//     +-inf meet in the edge bands; a row whose row_rw is +inf visits every
//     band; a row whose u or v is not finite, or whose row_rw is not > 0,
//     passes no window and visits none;
//   - the row's warp gates STEPS * 32 columns at a time (their shared loads in
//     flight together), before any popcount. The chi2 error is rounded op by
//     op (__fmul_rn/__fadd_rn) as the plain version rounds it: nvcc would
//     contract du*du + dv*dv into an FMA and move pairs that sit on the bound.
//     The bounds are float literals, so the compare stays in f32 like the
//     oracle's. Allowed columns go into the warp's queue (ballot offsets); a
//     drain loads the queued descriptors from L2 together, one column per lane
//     per step, and takes their distances;
//   - each lane keeps a running top-2 of unique keys (dist << 22 | column),
//     whose unsigned order is (distance, lowest column): the top-2 does not
//     depend on the order in which columns are visited, so the sort, the
//     ranges and the queue give the first design's bits. A butterfly of
//     shuffles merges the 32 lanes' disjoint top-2 lists;
//   - the neighbour axis of the batched form is blockIdx.y: it offsets every
//     pointer by that neighbour's stride, so no concatenated copies are made.
//     The source descriptors take their own stride, 0 when all neighbours
//     share one source set (fuse_curr_into_neighbors).
// Any N up to 2^22 - 1: past CAP columns the block sorts and walks the next
// CAP, and each row's top-2 carries over.

#include <cuda_runtime.h>

#define BIG (1 << 20)
#define NONE 0xffffffffu
#define COL_BITS 22
#define FULL 0xffffffffu
#define WARPS 16  // rows (one per warp) per block
#define CAP 1024  // columns sorted per chunk
#define NB 64     // bands of col_v, BAND_PX high (a power of two)
#define BAND_PX 8
#define MIN_BLOCKS 1  // blocks per SM that __launch_bounds__ asks room for
#define STEPS 2   // 32-column steps of a row's walk gated together
#define QCAP 64   // allowed columns a warp queues before it loads their descriptors

#define THREADS (WARPS * 32)
#define PER_THREAD (CAP / THREADS)
static_assert(CAP % THREADS == 0, "CAP must be a multiple of the block's threads");
static_assert(NB % 32 == 0, "the scan takes NB / 32 bands per lane");
static_assert(QCAP % 32 == 0, "a drain takes QCAP / 32 columns per lane");
static_assert(QCAP >= 32 * STEPS, "the queue takes one gated batch");

// band of a column or window edge: floor(v / BAND_PX) clamped to [0, NB - 1]
// by compares in f32 (v * (1 / BAND_PX) is exact); never called with a NaN
__device__ __forceinline__ int band_of(float v) {
  return v < (float)BAND_PX ? 0
                            : (v >= (float)(BAND_PX * NB) ? NB - 1 : (int)(v * (1.0f / BAND_PX)));
}

// the queued columns' descriptors, loaded together (one column per lane per
// step), their distances to the row's descriptor a0|a1 and the lane's top-2
__device__ __forceinline__ void drain(const int* __restrict__ queue, int qn,
                                      const uint4* __restrict__ b, uint4 a0, uint4 a1,
                                      int lane, unsigned& k1, unsigned& k2) {
  int col[QCAP / 32];
  uint4 d0[QCAP / 32], d1[QCAP / 32];
#pragma unroll
  for (int g = 0; g < QCAP / 32; ++g) {
    col[g] = lane + 32 * g < qn ? queue[lane + 32 * g] : -1;
    if (col[g] >= 0) {
      d0[g] = __ldg(b + 2 * col[g]);
      d1[g] = __ldg(b + 2 * col[g] + 1);
    }
  }
#pragma unroll
  for (int g = 0; g < QCAP / 32; ++g) {
    if (col[g] < 0) continue;
    const unsigned d = __popc(a0.x ^ d0[g].x) + __popc(a0.y ^ d0[g].y) +
                       __popc(a0.z ^ d0[g].z) + __popc(a0.w ^ d0[g].w) +
                       __popc(a1.x ^ d1[g].x) + __popc(a1.y ^ d1[g].y) +
                       __popc(a1.z ^ d1[g].z) + __popc(a1.w ^ d1[g].w);
    const unsigned key = (d << COL_BITS) | (unsigned)col[g];
    if (key < k1) {
      k2 = k1;
      k1 = key;
    } else if (key < k2) {
      k2 = key;
    }
  }
}

template <bool CHI2>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
masked_top2_kernel(const int* __restrict__ a, long long a_bstride, const int* __restrict__ b,
                   const float* __restrict__ row_u, const float* __restrict__ row_v,
                   const float* __restrict__ row_rw, const float* __restrict__ row_ur,
                   const float* __restrict__ row_rur, const int* __restrict__ row_lo,
                   const int* __restrict__ row_hi, const unsigned char* __restrict__ row_ok,
                   const float* __restrict__ col_u, const float* __restrict__ col_v,
                   const float* __restrict__ col_ur, const int* __restrict__ col_oct,
                   const unsigned char* __restrict__ col_ok, const float* __restrict__ col_isig2,
                   int M, int N, int* __restrict__ best_i, int* __restrict__ best_d,
                   int* __restrict__ second_i, int* __restrict__ second_d) {
  // the chunk's kept columns, sorted by band
  __shared__ float su[CAP], sv[CAP], sur[CAP], sisig[CHI2 ? CAP : 1];
  __shared__ int soct[CAP], scol[CAP];
  __shared__ int cnt[NB], start[NB + 1];
  __shared__ int queue[WARPS][QCAP];

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

  // this warp's row: its flag, gate parameters and descriptor are loaded
  // together, before the block knows whether any of its rows is live
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * WARPS + warp;
  bool walk = false;
  uint4 ra0 = make_uint4(0, 0, 0, 0), ra1 = ra0;
  float ru = 0.f, rv = 0.f, rw = 0.f, rur = 0.f, rrur = 0.f;
  int lo = 0, hi = -1;
  if (r < M) {
    walk = row_ok[r];
    ra0 = reinterpret_cast<const uint4*>(a)[2 * r];
    ra1 = reinterpret_cast<const uint4*>(a)[2 * r + 1];
    ru = row_u[r]; rv = row_v[r]; rw = row_rw[r]; rur = row_ur[r]; rrur = row_rur[r];
    lo = row_lo[r]; hi = row_hi[r];
  }
  for (int i = threadIdx.x; i < NB; i += THREADS) cnt[i] = 0;
  if (!__syncthreads_or(lane == 0 && walk)) {
    // no live row: the oracle's answer for an empty row, nothing staged
    if (lane == 0 && r < M) {
      best_i[r] = 0; best_d[r] = BIG; second_i[r] = 0; second_d[r] = BIG;
    }
    return;
  }
  // no finite column passes a window around a non-finite u or v, or of a
  // row_rw that is not > 0 (NaN included)
  walk = walk && isfinite(ru) && isfinite(rv) && rw > 0.0f;
  int blo = 0, bhi = -1;
  if (walk) {
    const float e = __fmul_rn(__fadd_rn(fabsf(rv), rw), 9.5367431640625e-07f);  // 2^-20
    blo = max(band_of(__fsub_rn(__fsub_rn(rv, rw), e)) - 1, 0);
    bhi = min(band_of(__fadd_rn(__fadd_rn(rv, rw), e)) + 1, NB - 1);
  }

  unsigned k1 = NONE, k2 = NONE;
  int* const q = queue[warp];
  for (int c0 = 0; c0 < N; c0 += CAP) {
    // counting sort of columns c0 .. c0 + CAP - 1 by band: every load first,
    // then the slots (shared atomics), the scan and the scatter
    float cu[PER_THREAD], cv[PER_THREAD], cur[PER_THREAD], cis[PER_THREAD];
    int coct[PER_THREAD], band[PER_THREAD], pos[PER_THREAD];
    bool keep[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = c0 + threadIdx.x + j * THREADS;
      const bool in = c < N;
      keep[j] = in && col_ok[c];
      cu[j] = in ? col_u[c] : 0.0f;
      cv[j] = in ? col_v[c] : 0.0f;
      cur[j] = in ? col_ur[c] : 0.0f;
      coct[j] = in ? col_oct[c] : 0;
      if constexpr (CHI2) cis[j] = in ? col_isig2[c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      // a column whose u or v is not finite passes no window
      keep[j] = keep[j] && isfinite(cu[j]) && isfinite(cv[j]);
      band[j] = keep[j] ? band_of(cv[j]) : 0;
      pos[j] = keep[j] ? atomicAdd(&cnt[band[j]], 1) : 0;
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the NB counts; the counts go back to 0
      int x[NB / 32], s = 0;
#pragma unroll
      for (int i = 0; i < NB / 32; ++i) {
        x[i] = cnt[NB / 32 * lane + i];
        s += x[i];
      }
      const int own = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += t;
      }
      if (lane == 31) start[NB] = s;
      s -= own;
#pragma unroll
      for (int i = 0; i < NB / 32; ++i) {
        start[NB / 32 * lane + i] = s;
        s += x[i];
        cnt[NB / 32 * lane + i] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (keep[j]) {
        const int p = start[band[j]] + pos[j];
        su[p] = cu[j]; sv[p] = cv[j]; sur[p] = cur[j]; soct[p] = coct[j];
        if constexpr (CHI2) sisig[p] = cis[j];
        scol[p] = c0 + threadIdx.x + j * THREADS;
      }
    }
    __syncthreads();

    if (walk) {
      // the gate on every column of the row's bands, 32 * STEPS at a time
      // (their shared loads in flight together); the allowed ones are
      // queued, and a queue that would overflow is drained first
      const int end = start[bhi + 1];
      int qn = 0;
      for (int base = start[blo]; base < end; base += 32 * STEPS) {
        bool ok[STEPS];
        int col[STEPS];
#pragma unroll
        for (int t = 0; t < STEPS; ++t) {
          const int p = base + 32 * t + lane;
          ok[t] = false;
          col[t] = 0;
          if (p < end) {
            const float du = su[p] - ru;
            const float dv = sv[p] - rv;
            const float cr = sur[p];
            bool g = (fabsf(du) < rw) & (fabsf(dv) < rw) & (soct[p] >= lo) & (soct[p] <= hi);
            if constexpr (CHI2) {
              const float e2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
              const float dur = rur - cr;
              const float e2s = __fadd_rn(e2, __fmul_rn(dur, dur));
              g &= (cr >= 0.0f) ? (__fmul_rn(e2s, sisig[p]) <= 7.815f)
                                : (__fmul_rn(e2, sisig[p]) <= 5.991f);
            } else {
              g &= (cr <= 0.0f) | (fabsf(rur - cr) <= rrur);
            }
            ok[t] = g;
            col[t] = scol[p];
          }
        }
        unsigned m[STEPS];
        int n_ok = 0;
#pragma unroll
        for (int t = 0; t < STEPS; ++t) {
          m[t] = __ballot_sync(FULL, ok[t]);
          n_ok += __popc(m[t]);
        }
        if (qn + n_ok > QCAP) {
          __syncwarp();
          drain(q, qn, reinterpret_cast<const uint4*>(b), ra0, ra1, lane, k1, k2);
          __syncwarp();
          qn = 0;
        }
#pragma unroll
        for (int t = 0; t < STEPS; ++t) {
          if (ok[t]) q[qn + __popc(m[t] & ((1u << lane) - 1u))] = col[t];
          qn += __popc(m[t]);
        }
      }
      __syncwarp();
      drain(q, qn, reinterpret_cast<const uint4*>(b), ra0, ra1, lane, k1, k2);
      __syncwarp();
    }
    if (c0 + CAP < N) __syncthreads();  // the next chunk overwrites the sorted columns
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(FULL, k1, off);
    const unsigned o2 = __shfl_xor_sync(FULL, k2, off);
    const unsigned n2 = min(max(k1, o1), min(k2, o2));
    k1 = min(k1, o1);
    k2 = n2;
  }
  if (lane == 0 && r < M) {
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
extern "C" int masked_top2_launch(
    const int* a, long long a_bstride, const int* b, const float* row_u, const float* row_v,
    const float* row_rw, const float* row_ur, const float* row_rur, const int* row_lo,
    const int* row_hi, const unsigned char* row_ok, const float* col_u, const float* col_v,
    const float* col_ur, const int* col_oct, const unsigned char* col_ok,
    const float* col_isig2, int chi2, int B, int M, int N, int* best_i, int* best_d,
    int* second_i, int* second_d, void* stream) {
  if (M > 0 && B > 0) {
    const dim3 grid((M + WARPS - 1) / WARPS, B);
    if (chi2) {
      masked_top2_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          a, a_bstride, b, row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
          col_u, col_v, col_ur, col_oct, col_ok, col_isig2, M, N, best_i, best_d, second_i,
          second_d);
    } else {
      masked_top2_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          a, a_bstride, b, row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
          col_u, col_v, col_ur, col_oct, col_ok, col_isig2, M, N, best_i, best_d, second_i,
          second_d);
    }
  }
  return (int)cudaGetLastError();
}
