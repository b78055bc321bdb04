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
// Bound on this card: operations on the live pairs (~11 gate instructions
// each) and 8 XOR + 8 popc on the allowed ones. On the main path few rows are
// live (the new keyframe's unmatched keypoints: 15 of 1,024 at the largest
// search of the smoke run), so most blocks have nothing to do, and a live
// block's time is a chain of dependent L2 rounds, not arithmetic. The first
// design (perf/epi_v1.cu: one warp per row, 8 rows per block) made every
// block, dead or live, stage all columns with their descriptors in
// 256-column chunks behind two barriers each, and made a live warp gate
// every column alone, 32 per lane (perf/kernel_split.py epi takes it apart:
// on an H100, staging alone was 0.0037 of its 0.0076 ms at that search, and
// a launch with every row dead cost the same 0.0037 ms).
// Design:
//   - ROWS rows per block, loaded by the first ROWS threads (line, den,
//     group, mono flag and descriptor, every load issued before the first
//     use) into shared memory; a ballot gives the block's mask of live rows.
//     A block with no live row writes (0, BIG) for its rows and leaves
//     before it touches a column;
//   - a live block spreads the pairs (live row, column) over all its
//     threads: each thread takes PER_THREAD columns of a chunk (all their
//     loads first, straight into registers: nothing of the columns is
//     staged), gates them against every live row of the block (the row's
//     parameters are shared-memory broadcasts), and keeps one bit per
//     allowed row in a mask per column. The gate is rounded op by op in the
//     oracle's order (__fmul_rn/__fadd_rn): a contracted FMA would move
//     pairs that sit on the num^2 = den*thr boundary;
//   - then the descriptors of the thread's columns that some row allows are
//     loaded together, and each allowed pair's distance goes into its row's
//     key by a shared atomicMin of the unique key (dist << 22 | column),
//     whose unsigned order is (distance, lowest column): the result does not
//     depend on the order of the atomics, so it is the first design's bits;
//   - after one barrier the first ROWS threads write their rows' results.
// The gate visits every live pair, so no pruning has to be shown a superset
// of the allowed pairs (NaN lines, den = 0, thr = inf and pairs on the
// boundary take the oracle's comparisons as they are). Any M, and any N up to
// 2^22 - 1: past CHUNK columns a thread takes the next chunk, and the keys
// carry over. Shape: 16 rows of 512 threads. With 8 rows of 256 threads the
// gate of a block whose rows are nearly all live (a seeded instance) spreads
// over twice the SMs, but the main path's searches hold 0-15 live rows of
// 1,024 and gain nothing; 32 rows a block doubles that gate's time; loading
// the columns before the liveness barrier saves nothing.

#include <cuda_runtime.h>

#define BIG (1 << 20)
#define NONE 0xffffffffu
#define COL_BITS 22
#define FULL 0xffffffffu
#define ROWS 16        // rows per block (at most 32: one bit each in a mask)
#define THREADS 512    // threads per block
#define PER_THREAD 2   // columns per thread per chunk

#define CHUNK (THREADS * PER_THREAD)
static_assert(ROWS <= 32 && ROWS <= THREADS, "the rows' loads and live mask sit in warp 0");

__global__ void __launch_bounds__(THREADS)
masked_top1_epi_kernel(const int* __restrict__ a, const int* __restrict__ b,
                       const float* __restrict__ row_l, const float* __restrict__ row_den,
                       const int* __restrict__ row_g, const unsigned char* __restrict__ row_ok,
                       const unsigned char* __restrict__ row_mono,
                       const float* __restrict__ col_u, const float* __restrict__ col_v,
                       const float* __restrict__ col_thr, const int* __restrict__ col_g,
                       const unsigned char* __restrict__ col_ok,
                       const unsigned char* __restrict__ col_flag, int M, int N,
                       int* __restrict__ best_i, int* __restrict__ best_d) {
  __shared__ float4 srow[ROWS];  // lx, ly, lz, den
  __shared__ int2 sgm[ROWS];     // group, mono flag
  __shared__ uint4 sdesc[ROWS][2];
  __shared__ unsigned skey[ROWS];
  __shared__ unsigned slive;

  const int t = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  bool live = false;
  if (t < ROWS) {
    const int r = r0 + t;
    skey[t] = NONE;
    if (r < M) {
      live = row_ok[r];
      const float4 l = make_float4(row_l[3 * r], row_l[3 * r + 1], row_l[3 * r + 2], row_den[r]);
      const int2 gm = make_int2(row_g[r], row_mono[r]);
      const uint4 d0 = reinterpret_cast<const uint4*>(a)[2 * r];
      const uint4 d1 = reinterpret_cast<const uint4*>(a)[2 * r + 1];
      srow[t] = l;
      sgm[t] = gm;
      sdesc[t][0] = d0;
      sdesc[t][1] = d1;
    }
    const unsigned m = __ballot_sync(ROWS == 32 ? FULL : (1u << ROWS) - 1u, live);
    if (t == 0) slive = m;
  }
  if (!__syncthreads_or(live)) {
    // no live row: the oracle's answer for an empty row, no column touched
    if (t < ROWS && r0 + t < M) {
      best_i[r0 + t] = 0;
      best_d[r0 + t] = BIG;
    }
    return;
  }
  const unsigned live_mask = slive;

  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    // this thread's columns c0 + t + i * THREADS: every load issued before any use
    float cu[PER_THREAD], cv[PER_THREAD], cthr[PER_THREAD];
    int cg[PER_THREAD];
    bool cok[PER_THREAD], cflag[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int j = c0 + t + i * THREADS;
      const bool in = j < N;
      cok[i] = in && __ldg(col_ok + j);
      cu[i] = in ? __ldg(col_u + j) : 0.0f;
      cv[i] = in ? __ldg(col_v + j) : 0.0f;
      cthr[i] = in ? __ldg(col_thr + j) : 0.0f;
      cg[i] = in ? __ldg(col_g + j) : 0;
      cflag[i] = in && __ldg(col_flag + j);
    }
    // the gate of each column against every live row: one bit per allowed row
    unsigned am[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) am[i] = 0u;
    for (unsigned m = live_mask; m; m &= m - 1u) {
      const int k = __ffs(m) - 1;
      const float4 l = srow[k];
      const int2 gm = sgm[k];
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const float num = __fadd_rn(__fadd_rn(__fmul_rn(l.x, cu[i]), __fmul_rn(l.y, cv[i])), l.z);
        const bool allowed = cok[i] & (__fmul_rn(num, num) < __fmul_rn(l.w, cthr[i])) &
                             ((gm.x == cg[i]) | (gm.x < 0) | (cg[i] < 0)) &
                             !((gm.y != 0) & cflag[i]);
        am[i] |= (unsigned)allowed << k;
      }
    }
    // the descriptors of the columns some row allows, loaded together; each
    // allowed pair's key goes to its row
    uint4 d0[PER_THREAD], d1[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      d0[i] = d1[i] = make_uint4(0u, 0u, 0u, 0u);
      if (am[i]) {
        const int j = c0 + t + i * THREADS;
        d0[i] = __ldg(reinterpret_cast<const uint4*>(b) + 2 * j);
        d1[i] = __ldg(reinterpret_cast<const uint4*>(b) + 2 * j + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const unsigned j = (unsigned)(c0 + t + i * THREADS);
      for (unsigned m = am[i]; m; m &= m - 1u) {
        const int k = __ffs(m) - 1;
        const uint4 a0 = sdesc[k][0], a1 = sdesc[k][1];
        const unsigned d = __popc(a0.x ^ d0[i].x) + __popc(a0.y ^ d0[i].y) +
                           __popc(a0.z ^ d0[i].z) + __popc(a0.w ^ d0[i].w) +
                           __popc(a1.x ^ d1[i].x) + __popc(a1.y ^ d1[i].y) +
                           __popc(a1.z ^ d1[i].z) + __popc(a1.w ^ d1[i].w);
        atomicMin(&skey[k], (d << COL_BITS) | j);
      }
    }
  }

  __syncthreads();
  if (t < ROWS && r0 + t < M) {
    const unsigned k1 = skey[t];
    best_i[r0 + t] = k1 == NONE ? 0 : (int)(k1 & ((1u << COL_BITS) - 1u));
    best_d[r0 + t] = k1 == NONE ? BIG : (int)(k1 >> COL_BITS);
  }
}

extern "C" int masked_top1_epi_launch(
    const int* a, const int* b, const float* row_l, const float* row_den, const int* row_g,
    const unsigned char* row_ok, const unsigned char* row_mono, const float* col_u,
    const float* col_v, const float* col_thr, const int* col_g, const unsigned char* col_ok,
    const unsigned char* col_flag, int M, int N, int* best_i, int* best_d, void* stream) {
  if (M > 0) {
    masked_top1_epi_kernel<<<(M + ROWS - 1) / ROWS, THREADS, 0, (cudaStream_t)stream>>>(
        a, b, row_l, row_den, row_g, row_ok, row_mono, col_u, col_v, col_thr, col_g, col_ok,
        col_flag, M, N, best_i, best_d);
  }
  return (int)cudaGetLastError();
}
