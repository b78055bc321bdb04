// The device quad-tree keypoint distribution of a whole pyramid in one launch.
//
// Replaces no TPU kernel: the JAX package computes this in XLA
// (vo_slam_test_tpu/ops/distribute_device.py::distribute_level, one call a
// level); the plain version is ops/distribute_device.py::distribute_level,
// which builds [M, M] pairwise matrices and makes about six passes over them
// at each of 8 depths. This kernel returns the same keep mask [L, M] without
// any [M, M] matrix in memory.
//
// What it computes, per level: with cx, cy a candidate's depth-7 cell
// (one f32 subtract, one multiply by the folded constant, truncated toward
// zero, clamped: as the plain version rounds), candidates i and j share a cell
// at depth d exactly when d <= 7 - bitlen((cx_i ^ cx_j) | (cy_i ^ cy_j)). So
// each valid candidate needs two numbers: max_other, its largest share depth
// with another valid candidate, and max_better, the same over the valid
// candidates that dominate it (higher response, ties to the lower index).
// From them, per depth d: has_other = max_other >= d, dominated = max_better
// >= d, first_single = max_other + 1, live[d] and singles_cum[d] are counts
// over the level, stop_d the first depth where live + singles reach the
// target (or live is 0), and keep as in the plain version. The cap to the
// target by response is each kept candidate's rank among the kept: the count
// of kept candidates that dominate it (the plain version's stable argsort).
// Precondition: the responses of valid candidates are finite.
//
// Bound on this card: operations. The work is the pair tests, V^2 a level for
// V valid candidates (51M a frame at 640x480 when every candidate is valid);
// the bytes are M x 14 a level. The design:
//   - the two share depths come from one number: with m the Morton code of
//     (cx, cy) (x bits even, y bits odd), bitlen(cx ^ cx' | cy ^ cy') is
//     (bitlen(m ^ m') + 1) / 2, which grows with m ^ m'; so each candidate
//     keeps the least m ^ m' over the others and over its dominators, and a
//     pair test is an xor, a minimum, a compare and a predicated minimum;
//   - candidates are compacted to the valid ones (higher levels are mostly
//     padding) and staged through shared memory as (m, response) pairs, in
//     index order, a tile of TILE candidates at a time (a level with more is
//     walked tile by tile): every lane of a warp reads the same j (a
//     broadcast), and a warp's 32 i are consecutive, so only the j beside
//     them need the index tie-break and the test against itself; before them
//     a dominator is r_j >= r_i, after them r_j > r_i;
//   - one cluster of CLUSTER blocks a level, all levels in one launch: each
//     block takes a slice of the level's valid candidates as i against all j
//     (a warp a 32-i chunk and a part of the j), the blocks' counts of live
//     and single candidates are summed through distributed shared memory, and
//     the rank cap reads the other blocks' kept responses there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define MAX_DEPTH 7
#define CLUSTER 8            // blocks a level
#define THREADS 1024
#define WARPS (THREADS / 32)
#define TILE 4096            // staged candidates
#define MAX_LEVELS 32
#define MAX_TILES 12         // the one limit on M: M <= MAX_TILES * TILE = 49,152
#define NO_PAIR 0xFFFFFFFFu  // no other candidate: share depth below 0

// the dynamic shared memory of a level of M candidates: the staged tile and
// eight words for each candidate of a block's slice
#define SMEM_BYTES(M) (TILE * 8 + (((M) + CLUSTER - 1) / CLUSTER) * 32)
// at the largest M, with the static arrays, within the 227 KB a block may have
static_assert(SMEM_BYTES(MAX_TILES * TILE) + 1024 <= 227 * 1024, "MAX_TILES too large");

struct LevelParams {
  float min_x, min_y, sx, sy;  // bounds' lower corner; the folded cell scales
  int ncx, ncy, target, pad;   // depth-7 cells along x and y; the target
};

struct Params {
  LevelParams lv[MAX_LEVELS];
};

__device__ __forceinline__ unsigned spread_bits(unsigned x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// depth-7 cell of one coordinate, rounded as the plain version: f32 subtract,
// f32 multiply (never contracted), truncation toward zero, clamp
__device__ __forceinline__ int cell_of(int v, float lo, float scale, int n) {
  int c = __float2int_rz(__fmul_rn(__fsub_rn(__int2float_rn(v), lo), scale));
  return min(max(c, 0), n - 1);
}

// the largest depth at which two candidates whose Morton codes differ by the
// xor m share a cell; -1 when they share none (and for NO_PAIR)
__device__ __forceinline__ int share_depth(unsigned m) {
  const int bits = (32 - __clz((int)m) + 1) >> 1;
  return max(MAX_DEPTH - bits, -1);
}

// exclusive prefix of flag over the block; *total gets the block's count
__device__ __forceinline__ int block_scan(bool flag, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 0) s_warp[w] = __popc(b);
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int q = 0; q < WARPS; ++q) {
    const int c = s_warp[q];
    off += q < w ? c : 0;
    tot += c;
  }
  __syncthreads();
  *total = tot;
  return off + __popc(b & ((1u << lane) - 1u));
}

// Compacts the valid candidates of [lo, hi) of the level into jd (Morton
// code, response bits), in index order; those whose rank among the level's
// valid candidates (base + position) lies in [v0, v1) also go to the i slice.
__device__ void stage(const int* xs, const int* ys, const float* resp, const unsigned char* valid,
                      const LevelParams& lp, int lo, int hi, int base, int v0, int v1, uint2* jd,
                      unsigned* imort, float* ir, int* iidx, int* s_warp) {
  int n = 0;
  for (int c = lo; c < hi; c += THREADS) {
    const int m = c + threadIdx.x;
    const bool v = m < hi && valid[m];
    int tot;
    const int pos = n + block_scan(v, s_warp, &tot);
    if (v) {
      const unsigned mort = spread_bits(cell_of(xs[m], lp.min_x, lp.sx, lp.ncx)) |
                            (spread_bits(cell_of(ys[m], lp.min_y, lp.sy, lp.ncy)) << 1);
      const float r = resp[m];
      jd[pos] = make_uint2(mort, __float_as_uint(r));
      const int g = base + pos;
      if (g >= v0 && g < v1) {
        imort[g - v0] = mort;
        ir[g - v0] = r;
        iidx[g - v0] = m;
      }
    }
    n += tot;
  }
}

// The pair tests of i-chunk lanes against staged j in [j0, j1): MODE 0 for j
// ranked before every i of the warp, 2 after every one.
template <int MODE>
__device__ __forceinline__ void pairs(const uint2* jd, int j0, int j1, unsigned mi, float ri,
                                      unsigned& lo, unsigned& lb) {
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const uint2 q = jd[j];
    const unsigned x = q.x ^ mi;
    lo = min(lo, x);
    const float rj = __uint_as_float(q.y);
    if (MODE == 0 ? rj >= ri : rj > ri) lb = min(lb, x);
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
distribute_kernel(const int* __restrict__ xs_all, const int* __restrict__ ys_all,
                  const float* __restrict__ resp_all, const unsigned char* __restrict__ valid_all,
                  unsigned char* __restrict__ keep_all, int M, int s_cap, Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int level = blockIdx.y;
  const LevelParams lp = p.lv[level];
  const size_t off = (size_t)level * M;
  const int* xs = xs_all + off;
  const int* ys = ys_all + off;
  const float* resp = resp_all + off;
  const unsigned char* valid = valid_all + off;
  unsigned char* keep = keep_all + off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  uint2* jd = (uint2*)smem;                          // [TILE] staged j
  unsigned* imort = (unsigned*)(jd + TILE);          // [s_cap] the i slice
  float* ir = (float*)(imort + s_cap);
  int* iidx = (int*)(ir + s_cap);                    // level index of each i
  unsigned* min_o = (unsigned*)(iidx + s_cap);       // least xor over the others
  unsigned* min_b = min_o + s_cap;                   // ... over the dominators
  float* kr = (float*)(min_b + s_cap);               // this block's kept: responses
  int* kidx = (int*)(kr + s_cap);                    // ... their level indices
  int* kcnt = kidx + s_cap;                          // ... their kept dominators
  __shared__ int s_warp[WARPS];
  __shared__ int s_base[MAX_TILES + 1];              // per tile: valid before it
  __shared__ int s_stats[2 * (MAX_DEPTH + 2)];       // live-count steps, singles
  __shared__ int s_kept;                             // this block's kept count
  __shared__ int s_stop, s_total_kept;

  const int n_tiles = (M + TILE - 1) / TILE;
  const int chunk = (M + CLUSTER - 1) / CLUSTER;     // indices whose zeros this block writes
  if (tid < 2 * (MAX_DEPTH + 2)) s_stats[tid] = 0;

  // 1. valid candidates a tile; invalid ones are not kept
  for (int t = 0; t < n_tiles; ++t) {
    const int lo = t * TILE, hi = min(M, lo + TILE);
    int cnt = 0;
    for (int c = lo; c < hi; c += THREADS) {
      const int m = c + tid;
      const bool v = m < hi && valid[m];
      if (m < hi && !v && m / chunk == rank) keep[m] = 0;
      cnt += __syncthreads_count(v);
    }
    if (tid == 0) s_base[t + 1] = cnt;
  }
  if (tid == 0) {
    s_base[0] = 0;
    for (int t = 0; t < n_tiles; ++t) s_base[t + 1] += s_base[t];
  }
  __syncthreads();
  const int V = s_base[n_tiles];
  const int v0 = (int)((long long)rank * V / CLUSTER);
  const int v1 = (int)((long long)(rank + 1) * V / CLUSTER);
  const int S = v1 - v0;

  // 2. the i slice: ranks [v0, v1) of the level's valid candidates
  for (int t = 0; t < n_tiles; ++t) {
    if (s_base[t + 1] <= v0 || s_base[t] >= v1) continue;
    stage(xs, ys, resp, valid, lp, t * TILE, min(M, (t + 1) * TILE), s_base[t], v0, v1, jd,
          imort, ir, iidx, s_warp);
  }
  for (int k = tid; k < S; k += THREADS) min_o[k] = min_b[k] = NO_PAIR;
  __syncthreads();

  // 3. pair tests: every i of the slice against every valid j of the level
  const int n_ic = (S + 31) / 32;
  for (int t = 0; t < n_tiles && n_ic > 0; ++t) {
    const int base = s_base[t], n_t = s_base[t + 1] - base;
    if (n_t == 0) continue;
    if (n_tiles > 1) {  // one tile is staged already by step 2
      stage(xs, ys, resp, valid, lp, t * TILE, min(M, (t + 1) * TILE), base, 0, 0, jd, imort, ir,
            iidx, s_warp);
      __syncthreads();
    }
    const int parts = max(1, min((8 * WARPS + n_ic - 1) / n_ic, n_t / 32));
    for (int item = warp; item < n_ic * parts; item += WARPS) {
      const int ic = item % n_ic, part = item / n_ic;
      const int k = ic * 32 + lane;
      const bool active = k < S;
      const unsigned mi = active ? imort[k] : 0u;
      const float ri = active ? ir[k] : 0.f;
      const int gi = v0 + k;                            // the i's rank
      const int g_first = v0 + ic * 32;                 // the warp's i ranks
      const int g_last = v0 + min(ic * 32 + 31, S - 1);
      const int j0 = (int)((long long)n_t * part / parts);
      const int j1 = (int)((long long)n_t * (part + 1) / parts);
      const int ja = min(max(g_first - base, j0), j1);  // [j0, ja) before every i
      const int jb = min(max(g_last + 1 - base, ja), j1);  // [jb, j1) after every i
      unsigned lo = NO_PAIR, lb = NO_PAIR;
      pairs<0>(jd, j0, ja, mi, ri, lo, lb);
      for (int j = ja; j < jb; ++j) {
        const uint2 q = jd[j];
        const int gj = base + j;
        if (gj == gi) continue;
        const unsigned x = q.x ^ mi;
        lo = min(lo, x);
        const float rj = __uint_as_float(q.y);
        if (rj > ri || (rj == ri && gj < gi)) lb = min(lb, x);
      }
      pairs<2>(jd, jb, j1, mi, ri, lo, lb);
      if (active) {
        atomicMin(&min_o[k], lo);
        atomicMin(&min_b[k], lb);
      }
    }
    __syncthreads();
  }

  // 4. the slice's counts: live[d] over max_better < d <= max_other (as steps),
  // singles by first depth alone (max_other + 1)
  for (int k = tid; k < S; k += THREADS) {
    const int so = share_depth(min_o[k]), sb = share_depth(min_b[k]);
    min_o[k] = (unsigned)so;
    min_b[k] = (unsigned)sb;
    if (so > sb) {
      atomicAdd(&s_stats[sb + 1], 1);
      atomicAdd(&s_stats[so + 1], -1);
    }
    atomicAdd(&s_stats[MAX_DEPTH + 2 + so + 1], 1);
  }
  cluster.sync();

  // 5. the level's counts from every block of the cluster; the stop depth
  if (tid == 0) {
    int step[MAX_DEPTH + 2], single[MAX_DEPTH + 2];
    for (int d = 0; d < MAX_DEPTH + 2; ++d) step[d] = single[d] = 0;
    for (int q = 0; q < CLUSTER; ++q) {
      const int* rs = cluster.map_shared_rank(s_stats, q);
      for (int d = 0; d < MAX_DEPTH + 2; ++d) {
        step[d] += rs[d];
        single[d] += rs[MAX_DEPTH + 2 + d];
      }
    }
    int live = 0, singles = 0, stop = MAX_DEPTH;
    for (int d = 0; d <= MAX_DEPTH; ++d) {
      live += step[d];
      singles += single[d];
      if (live + singles >= lp.target || live == 0) {
        stop = d;
        break;
      }
    }
    s_stop = stop;
  }
  __syncthreads();
  const int stop = s_stop;

  // 6. keep at the stop depth; the kept compacted in rank order
  int n_kept = 0;
  for (int c = 0; c < S; c += THREADS) {
    const int k = c + tid;
    bool kp = false;
    if (k < S) {
      const int so = (int)min_o[k], sb = (int)min_b[k];
      kp = so + 1 <= stop || (sb < stop && so >= stop);
      if (!kp) keep[iidx[k]] = 0;
    }
    int tot;
    const int pos = n_kept + block_scan(kp, s_warp, &tot);
    if (kp) {
      kr[pos] = ir[k];
      kidx[pos] = iidx[k];
      kcnt[pos] = 0;
    }
    n_kept += tot;
  }
  if (tid == 0) s_kept = n_kept;
  cluster.sync();

  // 7. the cap by response: a kept candidate stays when fewer than target
  // kept candidates of the level dominate it
  if (tid == 0) {
    int total = 0;
    for (int q = 0; q < CLUSTER; ++q) total += *cluster.map_shared_rank(&s_kept, q);
    s_total_kept = total;
  }
  __syncthreads();
  if (s_total_kept > lp.target) {
    float* buf = (float*)jd;  // 2 * TILE responses at a time
    for (int q = 0; q < CLUSTER; ++q) {
      const float* rk = cluster.map_shared_rank(kr, q);
      const int n = *cluster.map_shared_rank(&s_kept, q);
      for (int c = 0; c < n; c += 2 * TILE) {
        const int nc = min(n - c, 2 * TILE);
        for (int j = tid; j < nc; j += THREADS) buf[j] = rk[c + j];
        __syncthreads();
        for (int k = tid; k < n_kept; k += THREADS) {
          const float ri = kr[k];
          int cnt = 0;
          if (q < rank) {
            for (int j = 0; j < nc; ++j) cnt += buf[j] >= ri;
          } else if (q > rank) {
            for (int j = 0; j < nc; ++j) cnt += buf[j] > ri;
          } else {
            for (int j = 0; j < nc; ++j) {
              const int pj = c + j;
              cnt += pj < k ? buf[j] >= ri : (pj > k && buf[j] > ri);
            }
          }
          kcnt[k] += cnt;
        }
        __syncthreads();
      }
    }
  }
  for (int k = tid; k < n_kept; k += THREADS) keep[kidx[k]] = kcnt[k] < lp.target;
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// xs, ys int32 [L, M]; resp f32 [L, M]; valid, keep uint8 [L, M]; lvl_f
// (host) [L, 4] = min_x, min_y, sx, sy; lvl_i (host) [L, 3] = ncx, ncy, target
extern "C" int distribute_launch(const void* xs, const void* ys, const void* resp,
                                 const void* valid, void* keep, int L, int M,
                                 const float* lvl_f, const int* lvl_i, void* stream) {
  if (L < 1 || L > MAX_LEVELS || M < 1 || (M + TILE - 1) / TILE > MAX_TILES)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  for (int l = 0; l < L; ++l) {
    p.lv[l].min_x = lvl_f[4 * l];
    p.lv[l].min_y = lvl_f[4 * l + 1];
    p.lv[l].sx = lvl_f[4 * l + 2];
    p.lv[l].sy = lvl_f[4 * l + 3];
    p.lv[l].ncx = lvl_i[3 * l];
    p.lv[l].ncy = lvl_i[3 * l + 1];
    p.lv[l].target = lvl_i[3 * l + 2];
  }
  const int smem = SMEM_BYTES(M);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(distribute_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  distribute_kernel<<<dim3(CLUSTER, L), THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)xs, (const int*)ys, (const float*)resp, (const unsigned char*)valid,
      (unsigned char*)keep, M, (M + CLUSTER - 1) / CLUSTER, p);
  return (int)cudaGetLastError();
}
