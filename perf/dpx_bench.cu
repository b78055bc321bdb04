// Throughput of three-input minima on this card: the packed 16-bit DPX
// intrinsic __vimin3_s16x2 / __vimax3_s16x2 against min(min(a, b), c) on int,
// the 32-bit DPX form, the two-input packed form and fminf. Each thread runs
// four independent (a, b, c) triples through n rounds of three operations;
// perf/kernel_split.py times the launches and reports operations per second.

#include <cuda_runtime.h>

struct PackedMin3 {
  static __device__ __forceinline__ unsigned lo(unsigned a, unsigned b, unsigned c) {
    return __vimin3_s16x2(a, b, c);
  }
  static __device__ __forceinline__ unsigned hi(unsigned a, unsigned b, unsigned c) {
    return __vimax3_s16x2(a, b, c);
  }
};
struct IntMin3 {
  static __device__ __forceinline__ unsigned lo(unsigned a, unsigned b, unsigned c) {
    return (unsigned)min(min((int)a, (int)b), (int)c);
  }
  static __device__ __forceinline__ unsigned hi(unsigned a, unsigned b, unsigned c) {
    return (unsigned)max(max((int)a, (int)b), (int)c);
  }
};
struct DpxMin3 {
  static __device__ __forceinline__ unsigned lo(unsigned a, unsigned b, unsigned c) {
    return (unsigned)__vimin3_s32((int)a, (int)b, (int)c);
  }
  static __device__ __forceinline__ unsigned hi(unsigned a, unsigned b, unsigned c) {
    return (unsigned)__vimax3_s32((int)a, (int)b, (int)c);
  }
};
struct PackedMin2 {  // two-input packed: two instructions per call
  static __device__ __forceinline__ unsigned lo(unsigned a, unsigned b, unsigned c) {
    return __vmins2(__vmins2(a, b), c);
  }
  static __device__ __forceinline__ unsigned hi(unsigned a, unsigned b, unsigned c) {
    return __vmaxs2(__vmaxs2(a, b), c);
  }
};
struct FloatMin3 {  // f32: two instructions per call
  static __device__ __forceinline__ unsigned lo(unsigned a, unsigned b, unsigned c) {
    return __float_as_uint(
        fminf(fminf(__uint_as_float(a), __uint_as_float(b)), __uint_as_float(c)));
  }
  static __device__ __forceinline__ unsigned hi(unsigned a, unsigned b, unsigned c) {
    return __float_as_uint(
        fmaxf(fmaxf(__uint_as_float(a), __uint_as_float(b)), __uint_as_float(c)));
  }
};

template <class Op>
__global__ void bench_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned a[4], b[4], c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = in[(t * 12 + j * 3) & 4095];
    b[j] = in[(t * 12 + j * 3 + 1) & 4095];
    c[j] = in[(t * 12 + j * 3 + 2) & 4095];
  }
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = Op::lo(a[j], b[j], c[j]);
      b[j] = Op::hi(b[j], c[j], a[j] ^ 0x00010001u);
      c[j] = Op::lo(c[j] ^ 0x00020002u, a[j], b[j]);
    }
  }
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r ^= a[j] ^ b[j] ^ c[j];
  out[t] = r;
}

// which: 0 packed 16x2 min3, 1 int min(min()), 2 32-bit DPX min3, 3 packed
// two-input, 4 f32. The two XORs per round are in every variant.
extern "C" int dpx_bench_launch(const unsigned* in, unsigned* out, int which, int blocks,
                                int threads, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 0: bench_kernel<PackedMin3><<<blocks, threads, 0, st>>>(in, out, n); break;
    case 1: bench_kernel<IntMin3><<<blocks, threads, 0, st>>>(in, out, n); break;
    case 2: bench_kernel<DpxMin3><<<blocks, threads, 0, st>>>(in, out, n); break;
    case 3: bench_kernel<PackedMin2><<<blocks, threads, 0, st>>>(in, out, n); break;
    default: bench_kernel<FloatMin3><<<blocks, threads, 0, st>>>(in, out, n); break;
  }
  return (int)cudaGetLastError();
}
