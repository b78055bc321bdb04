// FAST-9/16 corner score on a pyramid level batch, raw and with 3x3 NMS.
//
// Replaces the TPU kernel vo_slam_test_tpu/ops/fast_pallas.py:
// fast_score_nms_pallas in both its modes: with_nms=False (the mode the
// extractor runs, _kernel_raw/_kernel_common): fast_score_launch, plain version
// ops/fast.py::fast_score; with_nms=True (_kernel, the NMS branch of
// _kernel_common): fast_score_nms_launch at the end of this file, plain version
// ops/fast.py::fast_score_nms.
//
// What it computes: for every pixel, V = max over the 16 dark and 16 bright
// cyclic 9-arcs of the 16-pixel Bresenham ring of the minimum |center - ring|
// inside the arc, clamped at 0. Precondition: pixel values are integers in
// [0, 255] (the pyramid's 8-bit levels held as f32), so every difference fits
// 16 bits and integer arithmetic gives the plain version's f32 result exactly.
//
// Bound on this card: bytes. Each pixel is read once and one score written
// (8 bytes per pixel, ~6 us for [8,480,640] at the memory rate); the minima
// and maxima of the pixels that can score at all take about half of that at
// the integer min/max rate once they are packed. The design keeps the
// arithmetic, and the instructions around it, under the bytes:
//   - two pixels per thread in the two 16-bit lanes of a word, with Hopper's
//     three-input packed minima and maxima (__vimin3_s16x2/__vimax3_s16x2): a
//     9-arc minimum is min3 of three 3-runs (32 instructions for the 16 arcs of
//     both pixels where two-input f32 doubling took 64 for one), and the final
//     maxima are a chain of max3;
//   - differences are one 32-bit subtract for both lanes: the centre carries
//     +256 in each lane, so every lane stays in [1, 511] and nothing borrows
//     across lanes; the bias is taken off the final maximum;
//   - a 64x16 pixel tile per block of 32x8 threads, each scoring two words
//     (rows y and y + 8): the kernel's time follows its count of threads and
//     their fixed costs more than its bytes, so four pixels share one thread's
//     staging and index arithmetic. The staged tile (3-pixel halo) is stored
//     as words packing pixels j and j + 32 of a row, so a thread's 17 reads
//     per word are aligned 32-bit shared loads without bank conflicts and its
//     scores go to coalesced rows of stores;
//   - staging walks rows and columns, not a flat index: a thread's three
//     columns are wrapped once, a row's index once per row, with compares and
//     adds only (an offset is at most 3 past an edge; H and W are at least 3);
//   - 61% of a [8,480,640] batch lies beyond its pyramid level and is zero: a
//     block whose staged pixels are all zero writes zeros and returns (every
//     difference is 0 there, so this is exact for any input).
// Edge handling: indices wrap in both axes, exactly like the plain version's
// roll, so the kernel equals the plain version on every pixel (callers mask a
// 16 px border anyway). The input may be a strided view (the canvas interior);
// only the last axis must be contiguous, and loads stay 4 bytes wide (the
// view's rows are not 16-byte aligned).

#include <cuda_runtime.h>

#define LANES 32             // threads along x; thread x scores pixels x and x + 32
#define TW (2 * LANES)       // tile width in pixels
#define TH 8                 // threads along y
#define ROWS 2               // rows per thread: thread y scores rows y and y + TH
#define R 3
#define SH (ROWS * TH + 2 * R)  // staged rows
#define SWORDS (LANES + 2 * R)  // staged words per row: word j = pixel j | pixel j+32 << 16
#define BIAS 0x01000100u     // +256 in each 16-bit lane

#define MIN3(a, b, c) __vimin3_s16x2((a), (b), (c))
#define MAX3(a, b, c) __vimax3_s16x2((a), (b), (c))

// index g wrapped into [0, n) with two compares and adds, for n >= R: a
// written pixel reads at most R past an edge, so indices further out (tile
// rows and columns past the image, read by no written pixel) are clamped to
// n + R - 1 first. No loop: the compiler turns a subtract-until-in-range loop
// back into a division.
__device__ __forceinline__ int wrap(int g, int n) {
  g = min(g, n + R - 1);
  g += g < 0 ? n : 0;
  g -= g >= n ? n : 0;
  return g;
}

// The packed arc extremes of the staged word (cy, cx), two pixels in its two
// 16-bit lanes: per lane, dark = the largest 9-arc minimum and bright = the
// smallest 9-arc maximum of d = centre - ring + 256, so the pixel's score is
// max(0, dark - 256, 256 - bright). Both modes call it on a stage of words
// packing pixels j and j + 32 of a row, where word (cy, cx)'s ring
// neighbours are words (cy + dy, cx + dx), lane for lane.
template <int SW>
__device__ __forceinline__ void arc_extremes(const unsigned (*tile)[SW], int cy, int cx,
                                             unsigned& dark, unsigned& bright) {
  // ring offsets (dx, dy), index 0 at 12 o'clock, clockwise (ops/fast.py CIRCLE16)
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const unsigned c = tile[cy][cx] + BIAS;
  unsigned d[16];  // per lane: center - ring + 256, in [1, 511]
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = c - tile[cy + DY[k]][cx + DX[k]];

  // minima and maxima of 3 consecutive ring positions, then of 9 (three runs)
  unsigned lo3[16], hi3[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo3[k] = MIN3(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
    hi3[k] = MAX3(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
  }
  // dark arcs: the largest 9-arc minimum of d; bright arcs: min of -d over
  // an arc is -(max of d), so the smallest 9-arc maximum of d
  dark = 0u;
  bright = 0x7fff7fffu;
#pragma unroll
  for (int k = 0; k < 16; k += 2) {
    const unsigned lo_a = MIN3(lo3[k], lo3[(k + 3) & 15], lo3[(k + 6) & 15]);
    const unsigned lo_b = MIN3(lo3[k + 1], lo3[(k + 4) & 15], lo3[(k + 7) & 15]);
    const unsigned hi_a = MAX3(hi3[k], hi3[(k + 3) & 15], hi3[(k + 6) & 15]);
    const unsigned hi_b = MAX3(hi3[k + 1], hi3[(k + 4) & 15], hi3[(k + 7) & 15]);
    dark = MAX3(dark, lo_a, lo_b);
    bright = MIN3(bright, hi_a, hi_b);
  }
}

__global__ void __launch_bounds__(LANES * TH)
fast_score_kernel(const float* __restrict__ in, long long s_l, long long s_h,
                  float* __restrict__ out, int H, int W) {
  __shared__ unsigned tile[SH][SWORDS];
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * (ROWS * TH);
  const float* src = in + (long long)blockIdx.z * s_l;

  // the thread's staged columns: tile columns lane, lane + 32 and (for the
  // first 2R lanes) lane + 64; tile column 0 is pixel x0 - R
  const int gx0 = wrap(x0 - R + lane, W);
  const int gx1 = wrap(x0 - R + lane + LANES, W);
  const int gx2 = wrap(x0 - R + lane + 2 * LANES, W);
  unsigned any = 0u;
  for (int r = ty; r < SH; r += TH) {
    const float* row = src + (long long)wrap(y0 - R + r, H) * s_h;
    const unsigned p0 = (unsigned)(int)row[gx0], p1 = (unsigned)(int)row[gx1];
    tile[r][lane] = p0 | (p1 << 16);
    any |= p0 | p1;
    if (lane < 2 * R) {
      const unsigned p2 = (unsigned)(int)row[gx2];
      tile[r][LANES + lane] = p1 | (p2 << 16);
      any |= p2;
    }
  }
  const int live = __syncthreads_or(any != 0u);

  const int x = x0 + lane;
  if (x >= W) return;
  const bool second = x + LANES < W;
#pragma unroll
  for (int h = 0; h < ROWS; ++h) {
    const int y = y0 + ty + h * TH;
    if (y >= H) return;
    float* dst = out + ((long long)blockIdx.z * H + y) * W + x;
    if (!live) {
      dst[0] = 0.0f;
      if (second) dst[LANES] = 0.0f;
      continue;
    }
    unsigned dark, bright;
    arc_extremes(tile, ty + h * TH + R, lane + R, dark, bright);
    // per lane: max(0, dark - 256, 256 - bright)
    const int s0 = max(max((int)(dark & 0xffffu) - 256, 256 - (int)(bright & 0xffffu)), 0);
    const int s1 = max(max((int)(dark >> 16) - 256, 256 - (int)(bright >> 16)), 0);
    dst[0] = (float)s0;
    if (second) dst[LANES] = (float)s1;
  }
}

extern "C" int fast_score_launch(const float* in, long long s_l, long long s_h, float* out,
                                 int L, int H, int W, void* stream) {
  if (H < R || W < R || L < 1 || L > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(LANES, TH);
  dim3 grid((W + TW - 1) / TW, (H + ROWS * TH - 1) / (ROWS * TH), L);
  fast_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, s_l, s_h, out, H, W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3x3-NMS mode: a score is kept where it is strictly greater than all 8
// neighbours' scores, else 0 (ops/fast.py::nms3x3 on fast_score). Scores are
// integers, so the comparison is exact and a tie suppresses both pixels.
// Indices wrap in both axes, as the plain version's rolls do, so the mode
// equals its plain version on every pixel.
//
// Bound on this card: bytes, the same as the raw mode's (one f32 read and one
// f32 write per pixel); the scores of the one-pixel ring around a tile are
// computed twice. The design keeps the raw mode's packing from the staged
// pixels to the stored scores:
//   - a block of 32x8 threads writes a 64x16 tile; it stages the tile's
//     pixels with a halo of 4 (3 for the ring, 1 for the neighbours' scores)
//     as words packing pixels j and j + 32 of a row (pixel 0 at x0 - 4), with
//     the raw mode's row and column walk (each index wrapped once);
//   - the scores of tile columns -1 ... 64 are packed the same way: score word
//     s holds tile columns s - 1 and s + 31, so word s's left and right
//     neighbours are words s - 1 and s + 1, lane for lane. Each word is scored
//     by the raw mode's packed sequence (arc_extremes), two pixels at once;
//     each thread scores the two words of its own rows, and 100 threads one
//     word each of the ring (rows -1 and 16, and words 0 and 33);
//   - the comparison is packed too: the largest of the 8 neighbour words
//     (three-input packed maxima over each score row, reused by the thread's
//     two adjacent rows), one signed per-lane compare, and the score ANDed
//     with that lane mask, unpacked into two f32 stores;
//   - the raw mode's all-zero early exit is kept: every score of an all-zero
//     stage is 0, and 0 > 0 is false.

#define NR (R + 1)                     // staged pixel halo
#define NROWS 2                        // rows per thread: thread y writes rows 2y and 2y + 1
#define NH (NROWS * TH)                // tile height
#define NPH (NH + 2 * NR)              // staged pixel rows
#define NPWORDS (LANES + 2 * NR)       // staged words per row: word k = pixel k | pixel k+32 << 16
#define NSH (NH + 2)                   // score rows: row r is image row y0 - 1 + r
#define NSWORDS (LANES + 2)            // score words per row: word s = score s | score s+32 << 16
#define NRING (2 * NSWORDS + 2 * NH)   // score words of the ring around the tile
static_assert((NH & (NH - 1)) == 0 && NRING <= LANES * TH, "ring walk needs NH a power of 2");

// g wrapped into [0, n) for g in [-NR, n + NR - 1] and n >= NR; indices
// further out (stage rows and columns that no written pixel reads) are
// clamped first, as in wrap()
__device__ __forceinline__ int wrap_nms(int g, int n) {
  g = min(g, n + NR - 1);
  g += g < 0 ? n : 0;
  g -= g >= n ? n : 0;
  return g;
}

// the packed raw scores of score word (r, s): per lane max(0, dark - 256,
// 256 - bright) = max(dark, 512 - bright, 256) - 256; every lane stays in
// [1, 511] before the bias comes off, so nothing borrows across lanes
__device__ __forceinline__ unsigned score_word(const unsigned (*px)[NPWORDS], int r, int s) {
  unsigned dark, bright;
  arc_extremes(px, r + R, s + R, dark, bright);
  return MAX3(dark, 0x02000200u - bright, BIAS) - BIAS;
}

__global__ void __launch_bounds__(LANES * TH)
fast_score_nms_kernel(const float* __restrict__ in, long long s_l, long long s_h,
                      float* __restrict__ out, int H, int W) {
  __shared__ unsigned px[NPH][NPWORDS];
  __shared__ unsigned sc[NSH][NSWORDS];
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * NH;
  const float* src = in + (long long)blockIdx.z * s_l;

  // the thread's staged columns: stage columns lane, lane + 32 and (for the
  // first 2NR lanes) lane + 64; stage column 0 is pixel x0 - NR
  const int gx0 = wrap_nms(x0 - NR + lane, W);
  const int gx1 = wrap_nms(x0 - NR + lane + LANES, W);
  const int gx2 = wrap_nms(x0 - NR + lane + 2 * LANES, W);
  unsigned any = 0u;
#pragma unroll
  for (int r = ty; r < NPH; r += TH) {
    const float* row = src + (long long)wrap_nms(y0 - NR + r, H) * s_h;
    const unsigned p0 = (unsigned)(int)row[gx0], p1 = (unsigned)(int)row[gx1];
    px[r][lane] = p0 | (p1 << 16);
    any |= p0 | p1;
    if (lane < 2 * NR) {
      const unsigned p2 = (unsigned)(int)row[gx2];
      px[r][LANES + lane] = p1 | (p2 << 16);
      any |= p2;
    }
  }
  const int live = __syncthreads_or(any != 0u);

  const int x = x0 + lane, ly = ty * NROWS;
  if (live) {
    // the thread's own rows: score rows ly + 1 ..., words 1 ... 32
#pragma unroll
    for (int h = 0; h < NROWS; ++h) sc[ly + h + 1][lane + 1] = score_word(px, ly + h + 1, lane + 1);
    // the ring, one word a thread, warp by warp: rows 0 and NSH - 1 (words
    // 0 ... 31), then words 0 and NSWORDS - 1 of rows 1 ... NH, then the four
    // corner words 32 and 33 of rows 0 and NSH - 1
    const int t = ty * LANES + lane;
    if (t < NRING) {
      int r, s;
      if (t < 2 * LANES) {
        r = t < LANES ? 0 : NSH - 1;
        s = lane;
      } else if (t < 2 * LANES + 2 * NH) {
        const int k = t - 2 * LANES;
        r = 1 + (k & (NH - 1));
        s = k < NH ? 0 : NSWORDS - 1;
      } else {
        const int k = t - 2 * LANES - 2 * NH;
        r = (k & 2) ? NSH - 1 : 0;
        s = LANES + (k & 1);
      }
      sc[r][s] = score_word(px, r, s);
    }
    __syncthreads();
  }
  if (x >= W) return;
  // per score row ly ... ly + NROWS + 1: the largest of the three words
  // around column word lane + 1, and of the two beside it
  unsigned h3[NROWS + 2], side[NROWS + 2];
  if (live) {
#pragma unroll
    for (int k = 0; k < NROWS + 2; ++k) {
      const unsigned a = sc[ly + k][lane], b = sc[ly + k][lane + 1], c = sc[ly + k][lane + 2];
      side[k] = __vmaxs2(a, c);
      h3[k] = MAX3(a, b, c);
    }
  }
#pragma unroll
  for (int h = 0; h < NROWS; ++h) {
    const int y = y0 + ly + h;
    if (y >= H) return;
    unsigned v = 0u;
    if (live) {
      const unsigned c = sc[ly + h + 1][lane + 1];
      // per lane: the score where it is greater than all 8 neighbours', else 0
      v = c & __vcmpgts2(c, MAX3(h3[h], h3[h + 2], side[h + 1]));
    }
    float* dst = out + ((long long)blockIdx.z * H + y) * W + x;
    dst[0] = (float)(v & 0xffffu);
    if (x + LANES < W) dst[LANES] = (float)(v >> 16);
  }
}

extern "C" int fast_score_nms_launch(const float* in, long long s_l, long long s_h, float* out,
                                     int L, int H, int W, void* stream) {
  if (H < NR || W < NR || L < 1 || L > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(LANES, TH);
  dim3 grid((W + TW - 1) / TW, (H + NH - 1) / NH, L);
  fast_score_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, s_l, s_h, out, H, W);
  return (int)cudaGetLastError();
}
