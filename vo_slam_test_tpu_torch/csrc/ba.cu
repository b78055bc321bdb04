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
// cost [1], Hinv [9,L], bl [3,L], Wc [wk,18,L], the window mask words [L] u32.
//
// Bound on this card: bytes, and far below a launch's fixed cost. A keyframe
// event's problem holds ~1.5k live points of L = 8192 slots with ~1.6 valid
// observers each (at most O = 12): a few hundred KB of inputs and outputs
// (~0.1 us at the memory rate) and ~1 M f32 instructions (less than that).
// What the card charges for is the length of the dependent chain inside each
// launch, how many waves of blocks a launch takes, and how many threads share
// the one sum that most points feed (the newest keyframe observes most live
// points, so its pose block and its S_red block sum over almost every point).
// Design of ba_accumulate, two launches:
//   - launch 1 (ba_point_kernel): one lane per observation. A group of 16
//     lanes owns a live point (O <= 16) and lane o takes observation o, so the
//     12 observers of a point are not walked in a row; blocks past the live
//     points write the dead points' Hinv and bl (the closed form on zero sums)
//     and leave. The poses are staged in shared memory once per block. A lane
//     keeps its residual, robust weight and Jacobians in registers and forms
//     from them everything its observation feeds: its terms of Hll and bl
//     (summed over the group by a fixed xor-shuffle tree, so every lane holds
//     the same sums and the same closed-form inverse Hinv), its Wc row, and
//     its window slot's terms of Hpp, bp and, with Hinv and bl, of rhs_red and
//     of the slot's own block of S_red. Nothing is computed twice and Wc is
//     not read back: two observations of one point by one slot are merged
//     through shuffles in observer order (a rare path, found with
//     __match_any_sync). The lane writes its Wc row and one record of the
//     scratch rec [wk, L, 132]: Hpp 36, bp 6, rhs_red 6, the slot's diagonal
//     S_red terms 36, the rows of Wc Hinv and of Wc padded to 4 floats (6 x 4
//     each), as 33 16-byte stores. A mask word per point names its window
//     slots (wk <= 32); rows of Wc and records exist only where the mask has
//     the slot, and the mask follows povar alone, so the rows written are the
//     same in every iteration of a BA call (Wc is zeroed once per call, rec
//     never);
//   - launch 2 (ba_sum_kernel) only sums. Grid (wk, wk + 2) of 256 threads,
//     five blocks to an SM, so that the 624 blocks of wk = 24 are one wave
//     (with 512 threads they were 1.2 waves and took twice as long): block
//     (a, 0) adds slot a's Hpp, bp and rhs_red records, block (a, 2 + a) its
//     diagonal S_red records, block (a, 2 + b) multiplies the rows of Wc_a
//     Hinv and Wc_b into block (a, b) of S_red = sum_l (Wc_a Hinv) Wc_b^T
//     ((a, b) and (b, a) each on their own), block (0, 1) adds the per-point
//     costs. A block first compacts, in point order, the points whose mask
//     holds its slot (or both slots) into shared memory: each warp scans a span
//     of consecutive mask words, all loaded before the first barrier, and a
//     block that finds none (most do) writes zeros and leaves after one
//     barrier. Then its loads are independent 16-byte reads of records with no
//     slot walk; thread (q, g) adds component q of the points g, g + G, ... of
//     the list, and the G partials are added in a fixed tree in shared memory.
//     It reads neither slot, u, v, ur, isig2, act nor povar;
//   - no float is summed with atomics and no sum depends on the order blocks
//     run in: two launches on the same inputs give the same bits;
//   - the sums are exact to their last rounding, so their order and their
//     implementation no longer show: a point's Hll and bl are added over its
//     lanes in f64, and the closed-form inverse, Wc Hinv, its right side and
//     the slot's diagonal products are formed in f64 and rounded once;
//     launch 2's threads add into f32 pairs (TwoSum, and TwoProduct through an
//     FMA for the blocks of two slots), their partials go through the tree in
//     f64 and are rounded once at the end. The reduced camera system S = Hpp
//     - S_red is a difference of nearly equal matrices, and a point that two
//     close views constrain has a block of condition 1e8 and more: with plain
//     f32 sums the order of the additions decided whether a Cholesky succeeded
//     and an LM step was accepted (three orders gave three sets of LM
//     iteration counts, and two of them left the chunked path's trajectory at
//     1.7-2.2 cm where the others gave 0.7 cm). With f64 accumulators and with
//     the f32 pairs the LM decisions are the same; the pairs are kept because
//     f32-to-f64 conversions run at an eighth of the f32 rate and made launch
//     2 a third slower;
//   - every loop over points stops at n_pts (the count of live points,
//     compacted first by the problem builder; a device int, no host read);
//   - the cost (launch 1 and ba_cost_launch) is rounded op by op
//     (__fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn), a point's cost is folded in
//     observer order by one device function (group_cost) and the points'
//     costs are added by another (cost_sum) in one fixed order, so the LM
//     accept test compares two sums of one order: equal inputs give equal
//     costs.
// One block per sum walks ~35-45 records per thread for a slot that ~1,000
// points observe: past a few thousand points per slot the sums should be
// split over blocks with a fixed-order combine.
// Design of ba_cost (ba_cost_kernel, one launch): its work is ~2.6k
// observations of ~40 f32 instructions each, far below the launch's fixed
// cost; what it pays for is a chain of round trips to L2 (the fields, the
// per-point costs, the count, the sum's loads) and a launch. A fixed grid of
// two 128-thread blocks per SM (it does not follow L; one block per SM or four
// were slower, 256-thread blocks no faster) walks the live points only, 16
// lanes to a point and one lane to an observation as in launch 1, the poses
// staged in shared memory once per block; the first points' fields and the
// poses are loaded before n_pts arrives. The sum of the points' costs is in
// the same launch: after a barrier one thread per block fences the block's
// costs and counts the block on an integer (no float atomics); the block that
// counts last runs cost_sum, whose loads go to L2 (__ldcg: other blocks wrote
// the costs in this launch, past any L1), and puts the count back to 0 for
// the next launch. Two launches must therefore not run at once. The sum loads
// one cost at a time: 4 or 16 loads in flight per thread did not make ba_cost
// faster, and 16 made ba_sum_kernel, which shares cost_sum, slower
// (perf/kernel_split.py).
// Design of ba_backsub (ba_backsub_kernel): dx_pt [3,L] = -Hinv (bl + Wc^T
// dx_pose) on every point, a live point reading the Wc rows of its window
// slots only. Those are the set bits of its mask word (written by launch 1 of
// the ba_accumulate call that wrote Wc); every other row of Wc is zero, and
// fma(0, d, t) is t for a finite d, so walking the bits in ascending order
// with the same FMAs gives the bits of the walk over all wk slots (a zero sum
// of sign - becomes + as there, by one add). A pose step with NaN or inf (a
// failed Cholesky) takes the walk over all wk slots, so that every live
// point's step is NaN as the LM test needs. What bounds it is latency: the
// mask, then the Wc rows, then the store, with bl, Hinv and the step loaded
// meanwhile; 64-thread blocks spread the ~1.6k live points over ~26 SMs. A
// slot's 18 values are read strided by L: neighbouring points mostly share the
// newest keyframe's slot, so a warp's loads coalesce (the records' padded
// rows, 96 contiguous bytes per point, read slower).

#include <cuda_runtime.h>

#define PT_THREADS 128
#define RED_THREADS 128
#define MAX_WK 32
#define GROUP 16                          // lanes per point in launch 1
#define PTS_PER_BLOCK (PT_THREADS / GROUP)
#define REC 132                           // floats per (slot, point) record
#define REC_D 48                          // (Wc Hinv) Wc^T of the slot with itself, 36
#define REC_WH 84                         // rows of Wc Hinv, 6 x 4
#define REC_WC 108                        // rows of Wc, 6 x 4
#define SUM_THREADS 256
#define SUM_WARPS (SUM_THREADS / 32)
#define SUM_BATCHES 8                     // mask words per lane and pass
#define WARP_SPAN (32 * SUM_BATCHES)      // consecutive points a warp scans
#define LIST_MAX (SUM_THREADS * SUM_BATCHES)  // points compacted per pass
#define SUM_BLOCKS_PER_SM 5               // (24 + 2) 24 = 624 blocks in one wave
#define P_LANES 12                        // the 48 pose-block floats of a record as float4
#define D_LANES 9                         // the 36 floats of a diagonal S_red block
#define S_LANES 6                         // off the diagonal: one row of Wc Hinv per thread
#define LIN_PAD 32                        // 21 and 28 groups, padded to a power of two
#define S_PAD 64                          // 42 groups
#define FULL 0xffffffffu
#define COST_BLOCKS_PER_SM 2              // ba_cost_kernel's fixed grid: blocks per SM
#define COST_THREADS 128                  // and threads per block (>= RED_THREADS)
#define COST_PTS (COST_THREADS / GROUP)
#define BS_THREADS 64                     // ba_backsub_kernel's block
#define MAX_DEVICES 64

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

// one observation's term of a point's cost (folded by group_cost)
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

// the per-point costs summed in a fixed order by the first RED_THREADS threads,
// read from L2 (__ldcg): in ba_cost_kernel the other blocks wrote them in the
// same launch
__device__ __forceinline__ float cost_sum(const float* __restrict__ cost_pt, int n, float* sh) {
  float acc = 0.0f;
  if (threadIdx.x < RED_THREADS)
    for (int l = threadIdx.x; l < n; l += RED_THREADS) acc = __fadd_rn(acc, __ldcg(cost_pt + l));
  block_reduce(acc, sh);
  return sh[0];
}

// a point's cost: its group's rho added in observer order (a = 0 where the
// lane has no observation); every lane of the group gets it. ba_point_kernel
// and ba_cost_kernel both call it, so both give the same bits
__device__ __forceinline__ float group_cost(float a, float rho, int O) {
  float cost = 0.0f;
  for (int oo = 0; oo < O; ++oo)
    cost = add_cost(cost, __shfl_sync(FULL, a, oo, GROUP), __shfl_sync(FULL, rho, oo, GROUP));
  return cost;
}

// damped closed-form inverse of the symmetric block (the TPU kernel's form),
// in f64: a point that two close views constrain has a block of condition
// 1e8 and more, whose inverse in f32 is rounding noise; h = (00, 01, 02, 11,
// 12, 22)
__device__ __forceinline__ void inv3x3_sym(const double h[6], float lam, double hv[9]) {
  const double damp = (double)lam + 1e-8;
  const double a_ = h[0] + damp, b_ = h[1], c_ = h[2];
  const double e_ = h[3] + damp, f_ = h[4], i_ = h[5] + damp;
  const double A = e_ * i_ - f_ * f_;
  const double B = -(b_ * i_ - f_ * c_);
  const double C3 = b_ * f_ - e_ * c_;
  const double det = a_ * A + b_ * B + c_ * C3;
  const double idet = 1.0 / (fabs(det) < 1e-20 ? 1e-20 : det);
  hv[0] = A * idet, hv[1] = B * idet, hv[2] = C3 * idet;
  hv[3] = B * idet, hv[4] = (a_ * i_ - c_ * c_) * idet, hv[5] = -(a_ * f_ - c_ * b_) * idet;
  hv[6] = C3 * idet, hv[7] = -(a_ * f_ - b_ * c_) * idet, hv[8] = (a_ * e_ - b_ * b_) * idet;
}

// lane o of a point's group writes one of the point's outputs: Hinv rows
// (o < 9), bl (9..11), the cost (12) and the mask word (13)
__device__ __forceinline__ void write_point(int o, int l, int L, const double hv[9],
                                            const double b[3], float cost, unsigned msk,
                                            float* __restrict__ Hinv, float* __restrict__ bl,
                                            float* __restrict__ cost_pt,
                                            unsigned* __restrict__ mask) {
  float val = 0.0f;
#pragma unroll
  for (int r = 0; r < 9; ++r)
    if (o == r) val = (float)hv[r];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    if (o == 9 + r) val = (float)b[r];
  if (o < 9) Hinv[o * L + l] = val;
  else if (o < 12) bl[(o - 9) * L + l] = val;
  else if (o == 12) cost_pt[l] = cost;
  else if (o == 13) mask[l] = msk;
}

__global__ void __launch_bounds__(PT_THREADS)
ba_point_kernel(const float* __restrict__ lam_p, const float* __restrict__ cam,
                const float* __restrict__ posesT, const float* __restrict__ X,
                const int* __restrict__ slot, const float* __restrict__ u,
                const float* __restrict__ v, const float* __restrict__ ur,
                const float* __restrict__ isig2, const float* __restrict__ act,
                const float* __restrict__ povar, const int* __restrict__ n_pts, int WF, int wk,
                int O, int L, int huber, float* __restrict__ Hinv, float* __restrict__ bl,
                float* __restrict__ Wc, float* __restrict__ rec, float* __restrict__ cost_pt,
                unsigned* __restrict__ mask) {
  extern __shared__ float sp[];  // rows 0..11 of posesT: [12][WF]
  const int t = threadIdx.x, o = t & (GROUP - 1);
  const int l = blockIdx.x * PTS_PER_BLOCK + t / GROUP;
  const int n = min(*n_pts, L);
  const float lam = *lam_p;
  if (blockIdx.x * PTS_PER_BLOCK >= n) {
    // dead points only: no observation, the inverse of the damping alone
    const double zero6[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, zero3[3] = {0.0, 0.0, 0.0};
    double hv[9];
    inv3x3_sym(zero6, lam, hv);
    if (l < L) write_point(o, l, L, hv, zero3, 0.0f, 0u, Hinv, bl, cost_pt, mask);
    return;
  }

  // this lane's observation, loaded while the poses are staged
  const bool live = l < n && o < O;
  const int i0 = o * L + l;
  const int s = live ? slot[i0] : -1;
  const bool seen = s >= 0;
  float uo = 0.f, vo = 0.f, uro = -1.f, is2 = 0.f, a = 0.f, pv = 0.f, x = 0.f, y = 0.f, z = 0.f;
  if (seen) {
    uo = u[i0], vo = v[i0], uro = ur[i0], is2 = isig2[i0], a = act[i0], pv = povar[i0];
    x = X[l], y = X[L + l], z = X[2 * L + l];
  }
  for (int i = t; i < 12 * WF; i += PT_THREADS) sp[i] = posesT[i];
  __syncthreads();

  double h[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, b[3] = {0.0, 0.0, 0.0};
  float wc[18], hp[36], g[6], rho = 0.0f;
#pragma unroll
  for (int k = 0; k < 18; ++k) wc[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 36; ++k) hp[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = 0.0f;
  // a window slot whose pose varies: this lane owns a Wc row and a record
  bool win = seen && s < wk && pv != 0.0f;
  if (seen) {
    Obs ob;
    const float s2 = observe(sp, WF, s, x, y, z, uo, vo, uro, is2, cam, ob);
    float wrob;
    rho = robust(s2, ob.stereo, huber, wrob);
    const float w = a * wrob;
    if (w != 0.0f) {
      float Jp[3][6], Jl[3][3];
      jacobians(ob, cam, Jp, Jl);
      int k = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        b[i] = w * (Jl[0][i] * ob.ew[0] + Jl[1][i] * ob.ew[1] + Jl[2][i] * ob.ew[2]);
#pragma unroll
        for (int j = i; j < 3; ++j, ++k)
          h[k] = w * (Jl[0][i] * Jl[0][j] + Jl[1][i] * Jl[1][j] + Jl[2][i] * Jl[2][j]);
      }
      if (win) {
        const float pw = pv * w;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            wc[i * 3 + j] =
                pv * (w * (Jp[0][i] * Jl[0][j] + Jp[1][i] * Jl[1][j] + Jp[2][i] * Jl[2][j]));
#pragma unroll
          for (int j = i; j < 6; ++j)  // symmetric term by term: the products commute
            hp[i * 6 + j] = hp[j * 6 + i] =
                pw * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] + Jp[2][i] * Jp[2][j]);
          g[i] = pw * (Jp[0][i] * ob.ew[0] + Jp[1][i] * ob.ew[1] + Jp[2][i] * ob.ew[2]);
        }
      }
    }
  }

  // Hll and bl over the group, in f64: an xor tree, the same sums in every lane
#pragma unroll
  for (int m = GROUP / 2; m > 0; m >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) h[k] += __shfl_xor_sync(FULL, h[k], m, GROUP);
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] += __shfl_xor_sync(FULL, b[k], m, GROUP);
  }
  double hv[9];
  inv3x3_sym(h, lam, hv);

  // the point's cost, added in observer order
  const float cost = group_cost(seen ? a : 0.0f, rho, O);

  // the point's window slots
  unsigned msk = win ? 1u << s : 0u;
#pragma unroll
  for (int m = GROUP / 2; m > 0; m >>= 1) msk |= __shfl_xor_sync(FULL, msk, m, GROUP);

  // two observations of one point by one slot: the later lane's terms are
  // added to the earlier lane's, in observer order, and the later lane writes
  // nothing
  const int lane = t & 31;
  const unsigned peers =
      __match_any_sync(FULL, win ? (unsigned)s | ((unsigned)(lane / GROUP) << 8) : 0x1000u + lane);
  const int first = __ffs(peers) - 1;
  unsigned later = __ballot_sync(FULL, win && lane != first);
  while (later) {
    const int src = __ffs(later) - 1;
    later &= later - 1;
    const bool mine = lane == __shfl_sync(FULL, first, src);
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      const float val = __shfl_sync(FULL, wc[k], src);
      if (mine) wc[k] += val;
    }
#pragma unroll
    for (int k = 0; k < 36; ++k) {
      const float val = __shfl_sync(FULL, hp[k], src);
      if (mine) hp[k] += val;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float val = __shfl_sync(FULL, g[k], src);
      if (mine) g[k] += val;
    }
    if (lane == src) win = false;
  }

  if (l < L) write_point(o, l, L, hv, b, cost, msk, Hinv, bl, cost_pt, mask);
  if (!win) return;

  // this slot's Wc row, Wc Hinv and its right side (Wc Hinv) bl, formed in
  // f64 and rounded once
  double whd[18];
  float wh[18], r6[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double whb = 0.0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      whd[i * 3 + k] = wc[i * 3] * hv[k] + wc[i * 3 + 1] * hv[3 + k] + wc[i * 3 + 2] * hv[6 + k];
      wh[i * 3 + k] = (float)whd[i * 3 + k];
      whb += whd[i * 3 + k] * b[k];
    }
    r6[i] = (float)whb;
  }
#pragma unroll
  for (int r = 0; r < 18; ++r) Wc[((size_t)s * 18 + r) * L + l] = wc[r];
  float4* out = reinterpret_cast<float4*>(rec + ((size_t)s * L + l) * REC);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    out[k] = make_float4(hp[4 * k], hp[4 * k + 1], hp[4 * k + 2], hp[4 * k + 3]);
  out[9] = make_float4(g[0], g[1], g[2], g[3]);
  out[10] = make_float4(g[4], g[5], r6[0], r6[1]);
  out[11] = make_float4(r6[2], r6[3], r6[4], r6[5]);
  // the slot's own 6x6 block of S_red, every entry as the sum kernel forms
  // the blocks of two slots (no entry is mirrored)
  float dg[36];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < 6; ++m)
      dg[i * 6 + m] = (float)(whd[i * 3] * wc[m * 3] + whd[i * 3 + 1] * wc[m * 3 + 1] +
                              whd[i * 3 + 2] * wc[m * 3 + 2]);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    out[REC_D / 4 + k] = make_float4(dg[4 * k], dg[4 * k + 1], dg[4 * k + 2], dg[4 * k + 3]);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    out[REC_WH / 4 + i] = make_float4(wh[i * 3], wh[i * 3 + 1], wh[i * 3 + 2], 0.0f);
    out[REC_WC / 4 + i] = make_float4(wc[i * 3], wc[i * 3 + 1], wc[i * 3 + 2], 0.0f);
  }
}

// hi + lo += x without rounding error to first order (Knuth's TwoSum: the
// error of the f32 add is exact in err, and lo collects the errors), each op
// rounded on its own: an f32 pair that sums like an f64 accumulator
__device__ __forceinline__ void sum2_add(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float bb = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(x, bb));
  lo = __fadd_rn(lo, err);
  hi = s;
}

// hi + lo += a * b, the product exact (its rounding error from one FMA)
__device__ __forceinline__ void sum2_add_product(float& hi, float& lo, float a, float b) {
  const float p = __fmul_rn(a, b);
  lo = __fadd_rn(lo, __fmaf_rn(a, b, -p));
  sum2_add(hi, lo, p);
}

// the block's G x NV partials in sh ([g][NV], g padded with zeros to G2, a
// power of two) added in a fixed tree: sh[0..NV) holds the sums
template <int NV, int G2>
__device__ __forceinline__ void tree_sum(double* sh) {
  for (int half = G2 / 2; half > 0; half >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < half * NV; i += SUM_THREADS) sh[i] += sh[i + half * NV];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SUM_THREADS, SUM_BLOCKS_PER_SM)
ba_sum_kernel(const int* __restrict__ n_pts, int wk, int L, const float* __restrict__ rec,
              const float* __restrict__ cost_pt, const unsigned* __restrict__ mask,
              float* __restrict__ Hpp, float* __restrict__ bp, float* __restrict__ S_red,
              float* __restrict__ rhs, float* __restrict__ cost) {
  __shared__ double sh[S_PAD * 36 > LIN_PAD * 48 ? S_PAD * 36 : LIN_PAD * 48];
  __shared__ unsigned short list[LIST_MAX];
  __shared__ int warp_cnt[SUM_WARPS];
  const int a = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = min(*n_pts, L);

  if (blockIdx.y == 1) {  // the cost: one block
    if (a != 0) return;
    const float c = cost_sum(cost_pt, n, reinterpret_cast<float*>(sh));
    if (t == 0) cost[0] = c;
    return;
  }
  const bool pose = blockIdx.y == 0;
  const int col = pose ? a : blockIdx.y - 2;
  const unsigned need = (1u << a) | (1u << col);
  const float* rec_a = rec + (size_t)a * L * REC;
  const float* rec_b = rec + (size_t)col * L * REC;
  // a pose block and a diagonal block add records; a block of two slots
  // multiplies rows of the two slots' records
  const bool linear = pose || col == a;
  const int lanes = pose ? P_LANES : (linear ? D_LANES : S_LANES);
  const int q = t % lanes, grp = t / lanes, n_grp = SUM_THREADS / lanes;
  const int nv = pose ? 48 : 36;
  // accumulators as f32 pairs (sum2_add): the sums cancel (S = Hpp - S_red is
  // a difference of nearly equal matrices), and plain f32 sums made LM steps
  // follow their order; the partials are then added in f64
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, low[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool any = false;

  for (int base = 0; base < n; base += LIST_MAX) {
    // the points of this pass that hold the slot(s), compacted in point order:
    // a warp scans WARP_SPAN consecutive points, the loads issued together
    const int end = min(base + LIST_MAX, n);
    unsigned word[SUM_BATCHES];
#pragma unroll
    for (int j = 0; j < SUM_BATCHES; ++j) {
      const int l = base + warp * WARP_SPAN + j * 32 + lane;
      word[j] = l < end ? mask[l] : 0u;
    }
    int mine = 0;
#pragma unroll
    for (int j = 0; j < SUM_BATCHES; ++j)
      mine += __popc(__ballot_sync(FULL, (word[j] & need) == need));
    if (lane == 0) warp_cnt[warp] = mine;
    __syncthreads();
    int pos = 0, cnt = 0;
#pragma unroll
    for (int w = 0; w < SUM_WARPS; ++w) {
      const int c = warp_cnt[w];
      pos += w < warp ? c : 0;
      cnt += c;
    }
    if (cnt == 0) {  // most blocks: no point holds the slot(s)
      __syncthreads();
      continue;
    }
    any = true;
#pragma unroll
    for (int j = 0; j < SUM_BATCHES; ++j) {
      const bool hit = (word[j] & need) == need;
      const unsigned bal = __ballot_sync(FULL, hit);
      if (hit)
        list[pos + __popc(bal & ((1u << lane) - 1u))] =
            (unsigned short)(warp * WARP_SPAN + j * 32 + lane);
      pos += __popc(bal);
    }
    __syncthreads();
    if (grp < n_grp) {
      if (linear) {
        const float* src = rec_a + (pose ? 0 : REC_D) + q * 4;
#pragma unroll 8
        for (int i = grp; i < cnt; i += n_grp) {
          const float4 r = *reinterpret_cast<const float4*>(src + (size_t)(base + list[i]) * REC);
          sum2_add(acc[0], low[0], r.x), sum2_add(acc[1], low[1], r.y);
          sum2_add(acc[2], low[2], r.z), sum2_add(acc[3], low[3], r.w);
        }
      } else {
        for (int i = grp; i < cnt; i += n_grp) {
          const size_t off = (size_t)(base + list[i]) * REC;
          const float4 wh = *reinterpret_cast<const float4*>(rec_a + off + REC_WH + q * 4);
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            const float4 wb = *reinterpret_cast<const float4*>(rec_b + off + REC_WC + m * 4);
            sum2_add_product(acc[m], low[m], wh.x, wb.x);
            sum2_add_product(acc[m], low[m], wh.y, wb.y);
            sum2_add_product(acc[m], low[m], wh.z, wb.z);
          }
        }
      }
    }
    __syncthreads();  // the list is rebuilt in the next pass
  }

  if (any) {
    const int pad = linear ? LIN_PAD : S_PAD;
    for (int i = t; i < pad * nv; i += SUM_THREADS) sh[i] = 0.0;
    __syncthreads();
    if (grp < n_grp) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < (linear ? 4 : 6))
          sh[grp * nv + q * (linear ? 4 : 6) + k] = (double)acc[k] + (double)low[k];
    }
    if (pose) tree_sum<48, LIN_PAD>(sh);
    else if (linear) tree_sum<36, LIN_PAD>(sh);
    else tree_sum<36, S_PAD>(sh);
  }
  if (t >= nv) return;
  const float val = any ? (float)sh[t] : 0.0f;
  if (!pose) S_red[(size_t)(a * 6 + t / 6) * (wk * 6) + col * 6 + t % 6] = val;
  else if (t < 36) Hpp[a * 36 + t] = val;
  else if (t < 42) bp[a * 6 + t - 36] = val;
  else rhs[a * 6 + t - 42] = val;
}

// lane o's observation for the cost, loaded together (the fields of a live
// lane whatever its slot, so that no load waits for the slot's)
struct CostIn {
  int s;
  float x, y, z, uo, vo, uro, is2, a;
};

__device__ __forceinline__ CostIn cost_in(const float* __restrict__ X, const int* __restrict__ slot,
                                          const float* __restrict__ u, const float* __restrict__ v,
                                          const float* __restrict__ ur,
                                          const float* __restrict__ isig2,
                                          const float* __restrict__ act, int l, int o, int n, int O,
                                          int L) {
  CostIn c = {-1, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f, 0.f, 0.f};
  if (l < n && o < O) {
    const int i0 = o * L + l;
    c.s = slot[i0];
    c.x = X[l], c.y = X[L + l], c.z = X[2 * L + l];
    c.uo = u[i0], c.vo = v[i0], c.uro = ur[i0], c.is2 = isig2[i0], c.a = act[i0];
  }
  return c;
}

// The robust cost in one launch: a fixed grid (COST_BLOCKS_PER_SM blocks per
// SM) walks the live points, a group of 16 lanes to a point and one lane to an
// observation, as ba_point_kernel; the block that arrives last sums the
// points' costs (cost_sum) and puts the arrival count back to 0.
__global__ void __launch_bounds__(COST_THREADS)
ba_cost_kernel(const float* __restrict__ cam, const float* __restrict__ posesT,
               const float* __restrict__ X, const int* __restrict__ slot,
               const float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ ur, const float* __restrict__ isig2,
               const float* __restrict__ act, const int* __restrict__ n_pts, int WF, int O, int L,
               int huber, float* __restrict__ cost, float* __restrict__ cost_pt,
               unsigned* __restrict__ arrived) {
  extern __shared__ float sp[];  // rows 0..11 of posesT: [12][WF]
  __shared__ float sh[RED_THREADS];
  __shared__ bool last;
  const int t = threadIdx.x, o = t & (GROUP - 1);
  const int stride = gridDim.x * COST_PTS;
  int base = blockIdx.x * COST_PTS;  // the same for the whole block
  // the first points' loads and the poses' do not wait for n_pts
  const int n_in = *n_pts;
  CostIn in = cost_in(X, slot, u, v, ur, isig2, act, base + t / GROUP, o, L, O, L);
  if (base < L) {
    for (int i = t; i < 12 * WF; i += COST_THREADS) sp[i] = posesT[i];
    __syncthreads();
  }
  const int n = min(n_in, L);
  if (base + t / GROUP >= n) in.s = -1;
  while (base < n) {
    const int l = base + t / GROUP;
    float rho = 0.0f, a = 0.0f;
    if (in.s >= 0) {
      Obs ob;
      const float s2 = observe(sp, WF, in.s, in.x, in.y, in.z, in.uo, in.vo, in.uro, in.is2,
                               cam, ob);
      float wrob;
      rho = robust(s2, ob.stereo, huber, wrob);
      a = in.a;
    }
    const float c = group_cost(a, rho, O);
    if (o == 0 && l < n) cost_pt[l] = c;
    base += stride;
    if (base < n) in = cost_in(X, slot, u, v, ur, isig2, act, base + t / GROUP, o, n, O, L);
  }
  // the block's costs, then its count: after the barrier one thread's fence
  // orders every thread's stores before the count (as a grid barrier does)
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(arrived, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const float c = cost_sum(cost_pt, n, sh);
  if (t == 0) {
    cost[0] = c;
    *arrived = 0u;  // ready for the next launch, a CUDA-graph replay's too
  }
}

// dx_pt's terms of window slot a: tv += Wc_a^T dx_a, row by row, one FMA each
__device__ __forceinline__ void backsub_slot(const float* __restrict__ Wc, const float* sdx, int a,
                                             int l, int L, float tv[3]) {
  const float* wc = Wc + (size_t)a * 18 * L + l;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float d = sdx[a * 6 + i];
#pragma unroll
    for (int k = 0; k < 3; ++k) tv[k] += wc[(i * 3 + k) * L] * d;
  }
}

__global__ void __launch_bounds__(BS_THREADS)
ba_backsub_kernel(const float* __restrict__ Wc, const float* __restrict__ Hinv,
                  const float* __restrict__ bl, const float* __restrict__ dxp,
                  const unsigned* __restrict__ mask, const int* __restrict__ n_pts, int wk, int L,
                  float* __restrict__ dx) {
  __shared__ float sdx[MAX_WK * 6];
  const int t = threadIdx.x, lane = t & 31;
  const int l = blockIdx.x * BS_THREADS + t;
  const unsigned slots = wk == 32 ? FULL : (1u << wk) - 1u;
  // what does not wait for the pose step is loaded before the barrier
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
  for (int i = t; i < wk * 6; i += BS_THREADS) sdx[i] = dxp[i];
  __syncthreads();
  // each warp reads the step: is every entry finite, and which slots have an
  // entry without its sign bit (a zero Wc row times it is +0)
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
    if (finite) {
      // the slots of the mask in ascending order: the others' rows are zero
      // and would add fma(0, d, tv) = tv, except that a +0 product turns a
      // -0 sum into +0, which the last add repeats
      for (unsigned b = m; b; b &= b - 1) backsub_slot(Wc, sdx, __ffs(b) - 1, l, L, tv);
      if (pos_slots & ~m & slots) {
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k] = __fadd_rn(tv[k], 0.0f);
      }
    } else {
      // NaN or inf in the step (a failed Cholesky): every slot, so that 0 x
      // NaN makes every live point's step NaN and the LM test rejects it
      for (int a = 0; a < wk; ++a) backsub_slot(Wc, sdx, a, l, L, tv);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dx[i * L + l] = -(h[i * 3] * tv[0] + h[i * 3 + 1] * tv[1] + h[i * 3 + 2] * tv[2]);
}

// the card's SM count, read once per device
static cudaError_t sm_count(int* sms) {
  static int cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

// One LM iteration's normal equations + Schur reduction: two launches.
// Scratch: rec [wk,L,132] f32 (never zeroed), cost_pt [L] f32; mask [L] u32
// is the caller's (ba_backsub_launch reads it). Wc is written in the rows of
// the observing window slots only (zero it once per problem).
extern "C" int ba_accumulate_launch(
    const float* lam, const float* cam, const float* posesT, const float* X, const int* slot,
    const float* u, const float* v, const float* ur, const float* isig2, const float* act,
    const float* povar, const int* n_pts, int WF, int wk, int O, int L, int huber, float* Hpp,
    float* bp, float* S_red, float* rhs, float* cost, float* Hinv, float* bl, float* Wc,
    float* rec, float* cost_pt, unsigned* mask, void* stream) {
  const size_t smem = (size_t)12 * WF * sizeof(float);
  if (wk < 1 || wk > MAX_WK || L < 1 || O < 1 || O > GROUP || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ba_point_kernel<<<(L + PTS_PER_BLOCK - 1) / PTS_PER_BLOCK, PT_THREADS, smem, st>>>(
      lam, cam, posesT, X, slot, u, v, ur, isig2, act, povar, n_pts, WF, wk, O, L, huber, Hinv,
      bl, Wc, rec, cost_pt, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ba_sum_kernel<<<dim3(wk, wk + 2), SUM_THREADS, 0, st>>>(n_pts, wk, L, rec, cost_pt, mask, Hpp,
                                                         bp, S_red, rhs, cost);
  return (int)cudaGetLastError();
}

// The robust cost alone, one launch. arrived: a u32 that is 0 before the
// launch and after it (zero it once; the launch's last block resets it), so
// two launches must not run at once.
extern "C" int ba_cost_launch(const float* cam, const float* posesT, const float* X,
                              const int* slot, const float* u, const float* v, const float* ur,
                              const float* isig2, const float* act, const int* n_pts, int WF,
                              int O, int L, int huber, float* cost, float* cost_pt,
                              unsigned* arrived, void* stream) {
  const size_t smem = (size_t)12 * WF * sizeof(float);
  if (L < 1 || O < 1 || O > GROUP || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  ba_cost_kernel<<<sms * COST_BLOCKS_PER_SM, COST_THREADS, smem, (cudaStream_t)stream>>>(
      cam, posesT, X, slot, u, v, ur, isig2, act, n_pts, WF, O, L, huber, cost, cost_pt, arrived);
  return (int)cudaGetLastError();
}

// dx_pt [3,L] = -Hinv (bl + Wc^T dx_pose), one thread per point. mask: the
// mask words of the ba_accumulate_launch that wrote Wc.
extern "C" int ba_backsub_launch(const float* Wc, const float* Hinv, const float* bl,
                                 const float* dxp, const unsigned* mask, const int* n_pts, int wk,
                                 int L, float* dx, void* stream) {
  if (wk < 1 || wk > MAX_WK || L < 1) return (int)cudaErrorInvalidValue;
  ba_backsub_kernel<<<(L + BS_THREADS - 1) / BS_THREADS, BS_THREADS, 0, (cudaStream_t)stream>>>(
      Wc, Hinv, bl, dxp, mask, n_pts, wk, L, dx);
  return (int)cudaGetLastError();
}
