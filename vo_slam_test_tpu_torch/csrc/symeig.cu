// Eigenvalues and eigenvectors of a batch of small symmetric f32 matrices (n <= 12):
// parallel-order cyclic Jacobi in f64, one thread block per matrix, f32 out. The plain
// version is utils/linalg.py::symeig_jacobi; this kernel does the same
// arithmetic in the same order (every product, sum, quotient and root rounded
// on its own: no contraction into an FMA), so the two agree to the last bit
// apart from the sign of a zero.
//
// Per matrix: load in f64, zero it if any entry is not finite (the outputs
// are then NaN), symmetrize (a_ij + a_ji) * 0.5, then at most `sweeps`
// sweeps. A sweep starts with the convergence test (every |a_pq| <= tol *
// max |a_ii| stops the matrix) and runs the m - 1 rounds of the round-robin
// order (m = n, or n + 1 with a bye when n is odd): round r pairs (r, m - 1)
// and ((r + k) mod (m - 1), (r - k) mod (m - 1)) for k = 1 .. m/2 - 1. A
// round computes every pair's rotation from the same matrix (Golub & Van
// Loan's sym.schur2; none where a_pq == 0), applies them to the rows, then to
// the columns of the matrix and of the eigenvector matrix. At the end the
// diagonal is sorted ascending (stable), the eigenvectors follow, and each
// eigenvector's first component of largest magnitude is made positive.
//
// Nothing is read back to the host: the launch returns cudaGetLastError().
//
// It replaces no TPU kernel: the JAX package calls XLA's eigh and svd (EPnP,
// Horn's alignment), which torch can only offer with a status the host reads
// back. Bound: its f64 operations (a few hundred thousand a 12x12 matrix,
// chip_smoke.symeig_bound), far from reached: one block works through ~100
// dependent rounds, each a handful of f64 ops behind a barrier (latency).

#include <cuda_runtime.h>

#define SYMEIG_MAXN 12
#define SYMEIG_THREADS 64

__global__ void __launch_bounds__(SYMEIG_THREADS)
symeig_kernel(const float* __restrict__ A, float* __restrict__ vals, float* __restrict__ vecs,
              int n, int sweeps, double tol) {
  __shared__ double M[2 * SYMEIG_MAXN][SYMEIG_MAXN + 1];  // rows 0..n-1 the matrix, n..2n-1 V
  __shared__ double cs[SYMEIG_MAXN / 2], sn[SYMEIG_MAXN / 2];
  __shared__ int pp[SYMEIG_MAXN / 2], qq[SYMEIG_MAXN / 2];
  __shared__ int order[SYMEIG_MAXN];
  __shared__ int bad, active;

  const int tid = threadIdx.x;
  const float* a = A + (size_t)blockIdx.x * n * n;
  if (tid == 0) {
    bad = 0;
    active = 1;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += SYMEIG_THREADS)
    if (!isfinite((double)a[e])) bad = 1;
  __syncthreads();
  for (int e = tid; e < n * n; e += SYMEIG_THREADS) {
    const int i = e / n, j = e % n;
    const double x = bad ? 0.0 : (double)a[i * n + j];
    const double y = bad ? 0.0 : (double)a[j * n + i];
    M[i][j] = __dmul_rn(0.5, __dadd_rn(x, y));
    M[n + i][j] = i == j ? 1.0 : 0.0;
  }
  const int m = n + (n & 1);
  const int h = m / 2;
  for (int sweep = 0; sweep < sweeps && n > 1; ++sweep) {
    __syncthreads();
    if (tid == 0) {
      double off = 0.0, dmax = 0.0;
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
          const double v = fabs(M[i][j]);
          if (i == j)
            dmax = fmax(dmax, v);
          else
            off = fmax(off, v);
        }
      if (off <= __dmul_rn(tol, dmax)) active = 0;
    }
    __syncthreads();
    if (!active) break;
    for (int r = 0; r < m - 1; ++r) {
      if (tid < h) {
        const int k = tid;
        const int u = k == 0 ? r : (r + k) % (m - 1);
        const int w = k == 0 ? m - 1 : (r - k + (m - 1)) % (m - 1);
        const int p = min(u, w), q = max(u, w);
        double c = 1.0, s = 0.0;
        if (q < n) {
          const double app = M[p][p], aqq = M[q][q], apq = M[p][q];
          if (apq != 0.0) {
            const double tau = __ddiv_rn(__dsub_rn(aqq, app), __dmul_rn(2.0, apq));
            const double sgn = tau >= 0.0 ? 1.0 : -1.0;
            const double t = __ddiv_rn(
                sgn, __dadd_rn(fabs(tau), __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(tau, tau)))));
            c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
            s = __dmul_rn(t, c);
          }
        }
        cs[k] = c;
        sn[k] = s;
        pp[k] = p;
        qq[k] = q < n ? q : -1;
      }
      __syncthreads();
      // rows p and q of the matrix
      for (int e = tid; e < h * n; e += SYMEIG_THREADS) {
        const int k = e / n, j = e % n, q = qq[k];
        if (q < 0) continue;
        const int p = pp[k];
        const double c = cs[k], s = sn[k], x = M[p][j], y = M[q][j];
        M[p][j] = __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));
        M[q][j] = __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));
      }
      __syncthreads();
      // columns p and q of the matrix and of the eigenvectors
      for (int e = tid; e < h * 2 * n; e += SYMEIG_THREADS) {
        const int k = e / (2 * n), i = e % (2 * n), q = qq[k];
        if (q < 0) continue;
        const int p = pp[k];
        const double c = cs[k], s = sn[k], x = M[i][p], y = M[i][q];
        M[i][p] = __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));
        M[i][q] = __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (tid == 0) {  // stable insertion sort of the diagonal, ascending
    for (int i = 0; i < n; ++i) order[i] = i;
    for (int i = 1; i < n; ++i) {
      const int o = order[i];
      const double v = M[o][o];
      int j = i - 1;
      while (j >= 0 && M[order[j]][order[j]] > v) {
        order[j + 1] = order[j];
        --j;
      }
      order[j + 1] = o;
    }
  }
  __syncthreads();
  const double nan = __longlong_as_double(0x7ff8000000000000ll);
  float* va = vals + (size_t)blockIdx.x * n;
  float* ve = vecs + (size_t)blockIdx.x * n * n;
  for (int k = tid; k < n; k += SYMEIG_THREADS) {
    const int o = order[k];
    va[k] = (float)(bad ? nan : M[o][o]);
    int big = 0;
    double best = fabs(M[n][o]);
    for (int i = 1; i < n; ++i) {
      const double v = fabs(M[n + i][o]);
      if (v > best) {
        best = v;
        big = i;
      }
    }
    const bool flip = M[n + big][o] < 0.0;
    for (int i = 0; i < n; ++i) {
      const double v = M[n + i][o];
      ve[i * n + k] = (float)(bad ? nan : (flip ? -v : v));
    }
  }
}

extern "C" int symeig_f32_launch(const void* A, void* vals, void* vecs, int batch, int n,
                                 int sweeps, double tol, void* stream) {
  if (n < 1 || n > SYMEIG_MAXN) return (int)cudaErrorInvalidValue;
  symeig_kernel<<<batch, SYMEIG_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)vals, (float*)vecs, n, sweeps, tol);
  return (int)cudaGetLastError();
}
