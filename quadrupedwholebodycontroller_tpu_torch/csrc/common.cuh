// Helpers shared by the kernels: one thread block per scenario, the
// scenario's matrices in (dynamic) shared memory with an odd row stride or
// in registers, vectors in shared memory, one thread per output row.
//
// Code written with the stage macros alone also compiles as plain C++: a
// block is then one thread that runs each stage's items in turn, in rising
// or falling order (qwbc_host_reverse), so a test without a GPU can check
// the arithmetic and that no item of a stage reads what another item of the
// same stage writes.  It cannot show a missing barrier.  Two forms:
//   * QWBC_FOR / QWBC_SYNC: every value that crosses a barrier lives in
//     shared memory, none in a register;
//   * QWBC_STAGE(state, count, f): values that cross barriers in registers
//     live in one state struct per thread; a stage is a callable
//     f(struct&, tid) that reads and writes its own struct and shared
//     memory.  On the device the thread calls it once on its struct (state
//     is a one-element array), then __syncthreads(); on the host `state`
//     holds `count` structs, one per emulated thread, and the stage runs
//     over them in rising or falling tid order.
#pragma once
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define QWBC_FOR(i, n) for (int i = threadIdx.x; i < (n); i += blockDim.x)
#define QWBC_SYNC() __syncthreads()
#define QWBC_STAGE(state, count, ...)                                       \
  do {                                                                       \
    (__VA_ARGS__)((state)[0], (int)threadIdx.x);                             \
    __syncthreads();                                                         \
  } while (0)
#else
#include <math.h>
#include <cmath>
#include <cstddef>
#include <limits>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
extern "C" int qwbc_host_reverse;
#define QWBC_FOR(i, n)                                                       \
  for (int i##_k = 0, i##_n = (n), i = (qwbc_host_reverse ? i##_n - 1 : 0);  \
       i##_k < i##_n; ++i##_k, i += (qwbc_host_reverse ? -1 : 1))
#define QWBC_SYNC() ((void)0)
#define QWBC_STAGE(state, count, ...)                                       \
  do {                                                                       \
    const int qs_n = (count);                                                \
    for (int qs_k = 0; qs_k < qs_n; ++qs_k) {                                \
      const int qs_t = qwbc_host_reverse ? qs_n - 1 - qs_k : qs_k;           \
      (__VA_ARGS__)((state)[qs_t], qs_t);                                    \
    }                                                                        \
  } while (0)
#endif

namespace qwbc {

// Odd row stride: thread i reading M[i*stride + j] for fixed j then hits 32
// different banks across a warp (42- and 70-word rows would 2-way conflict).
__host__ __device__ inline int row_stride(int cols) { return cols | 1; }

// a vector region's words, padded to eight (16-byte loads may read past len)
__host__ __device__ inline int pad8(int words) { return (words + 7) & ~7; }

// a * b + c rounded once, written out where the rounding must not depend on
// the compiler: nvcc's default contraction turns `acc += a * b` into it but
// may fuse either product of `a * b + c * d`, and the host build
// (-ffp-contract=off) fuses nothing
template <typename T>
__device__ __forceinline__ T fmadd(T a, T b, T c) {
#ifdef __CUDACC__
  if constexpr (sizeof(T) == 4) return __fmaf_rn(a, b, c);
  else return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

#ifdef __CUDACC__
// Raises a kernel's dynamic shared-memory limit above the 48 KB default,
// once per kernel and size (float64 at m = 70 needs 69 KB); launches within
// the limit already granted call nothing.  The kernel is a template argument,
// so each kernel has its own grant even where two share one signature.
// Returns a cudaError_t as int.
template <auto kernel>
inline int allow_shared_memory(size_t bytes) {
  static size_t granted = 48 * 1024;   // one per instantiation, so per kernel
  if (bytes <= granted) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return (int)err;
}

#endif  // __CUDACC__

// Hardware-only pieces behind helpers with a plain host definition:
//   * async_copy(dst, src): one element from device memory into shared
//     memory by cp.async (4 or 8 bytes, so the destination may be a padded
//     row), async_commit() closing a group, async_wait<N>() waiting until at
//     most N of this thread's groups are in flight (a barrier must follow
//     before other threads read the copies); on the host a plain copy;
//   * QWBC_LANES(i, n) / lead_warp() / lead_lane() / warp_max(v): a stage
//     run by the first warp alone, its lanes striding over n items and
//     reducing with shuffles; on the host the one thread runs every item
//     and the reduction is the value itself; warp_index(), warps_per_block()
//     and lead_lane_of_warp() name a thread's warp (on the host: one warp);
//   * QWBC_FOR_UNIFORM(i, n): QWBC_FOR with the same number of rounds on
//     every thread, for bodies with warp-wide reductions.
#ifdef __CUDACC__
template <typename T>
__device__ __forceinline__ void async_copy(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async of 4 or 8 bytes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#define QWBC_LANES(i, n) \
  _Pragma("unroll 1") for (int i = (int)(threadIdx.x & 31u); i < (n); i += 32)
__device__ __forceinline__ bool lead_warp() { return threadIdx.x < 32; }
__device__ __forceinline__ bool lead_lane() { return threadIdx.x == 0; }
__device__ __forceinline__ bool lead_lane_of_warp() { return (threadIdx.x & 31u) == 0; }
__device__ __forceinline__ int warp_index() { return (int)(threadIdx.x >> 5); }
__device__ __forceinline__ int warps_per_block() { return (int)(blockDim.x >> 5); }
// a stage whose items are spread as QWBC_FOR spreads them, but with the
// same number of rounds on every thread, so that a warp-wide reduction in
// the body runs on full warps: on the last round i may be >= n
#define QWBC_FOR_UNIFORM(i, n)                                               \
  _Pragma("unroll 1")                                                        \
  for (int i##_b = 0; i##_b < (n); i##_b += (int)blockDim.x)                 \
    if (const int i = i##_b + (int)threadIdx.x; true)
#else
template <typename T>
inline void async_copy(T* dst, const T* src) { *dst = *src; }
inline void async_commit() {}
template <int N>
inline void async_wait() {}
#define QWBC_LANES(i, n) QWBC_FOR(i, n)
inline bool lead_warp() { return true; }
inline bool lead_lane() { return true; }
inline bool lead_lane_of_warp() { return true; }
inline int warp_index() { return 0; }
inline int warps_per_block() { return 1; }
#define QWBC_FOR_UNIFORM(i, n) QWBC_FOR(i, n)
#endif  // __CUDACC__

// index of the lowest set bit of a non-zero mask: `for (m = mask; m; m &= m - 1)`
// with j = lowest_bit(m) visits the set bits in rising order
__device__ __forceinline__ int lowest_bit(unsigned m) {
#ifdef __CUDACC__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// zero `words` values from a 16-byte aligned p, 16 bytes a store
template <typename T>
__device__ __forceinline__ void zero_words(T* p, int words) {
#ifdef __CUDACC__
  constexpr int per = 16 / sizeof(T);
  const int vec = words / per;
  QWBC_FOR(i, vec) reinterpret_cast<float4*>(p)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  QWBC_FOR(i, words - vec * per) p[vec * per + i] = T(0);
#else
  QWBC_FOR(i, words) p[i] = T(0);
#endif
}

// a quiet NaN of T
template <typename T>
__device__ __forceinline__ T nan_value() {
#ifdef __CUDACC__
  if constexpr (sizeof(T) == 4) return __int_as_float(0x7fffffff);
  else return __longlong_as_double(0x7fffffffffffffffLL);
#else
  return std::numeric_limits<T>::quiet_NaN();
#endif
}

// max that propagates NaN (fmax would swallow it and certify a bad iterate)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {   // min(max(v, lo), hi), NaN kept
  T t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

template <typename T>
__device__ __forceinline__ T absv(T v) { return v < T(0) ? -v : v; }

// NaN-propagating max over the lanes of a warp (QWBC_LANES stages)
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#ifdef __CUDACC__
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
#endif
  return v;
}

// sum over the lanes of a warp (QWBC_LANES stages), in the butterfly's order
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#ifdef __CUDACC__
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
#endif
  return v;
}

template <typename T>
__device__ __forceinline__ void async_load_vector(T* dst, const T* __restrict__ src,
                                                  int len) {
  QWBC_FOR(i, len) async_copy(dst + i, src + i);
}

// a row-major (rows, cols) matrix into rows of stride ld, element by element
template <typename T>
__device__ __forceinline__ void async_load_matrix(T* dst, const T* __restrict__ src,
                                                  int rows, int cols, int ld) {
  if (rows * cols == 0) return;
#ifdef __CUDACC__
  const int step = blockDim.x, dr = step / cols, dc = step - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int idx = threadIdx.x; idx < rows * cols; idx += step) {
    async_copy(dst + r * ld + c, src + idx);
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
#else
  QWBC_FOR(idx, rows * cols) {
    const int r = idx / cols, c = idx - r * cols;
    async_copy(dst + r * ld + c, src + idx);
  }
#endif
}

// The certificate of an unscaled primal/dual pair (relative KKT residuals,
// OSQP normalization, and the sign violation; the plain versions'
// `kkt_epilogue` in ops/kernels/admm_zy.py), with its maxima reduced per
// warp in one pass.  Each thread fills the
// CERT_MAXIMA values of its item (zeros where it has none): a constraint
// row its finite bounds, |Ax| and |Ax - clip(Ax)| (cert_row_terms), a
// variable |Hx|, |A^T y|, |g| and |Hx + g + A^T y| (cert_var_terms); every
// lane of every warp then calls cert_warp_maxima, which folds the warp's
// maxima into red[q * nw + warp] (zeroed before; nw the stride, at least the
// warps of the block).  After a barrier the first warp alone calls
// cert_finish: the scales, the sign violation over the rows from ax, y
// (unscaled), lo and uo in shared memory, and pr[b], du[b], sv[b].  The
// maxima are order-free, so the result is the same bit for bit however the
// items are spread over warps.
constexpr int CERT_MAXIMA = 7;

template <typename T>
__device__ __forceinline__ void cert_row_terms(T lo, T uo, T ax, T* v) {
  const T fin = T(1e19);
  v[0] = nan_max(absv(lo) < fin ? absv(lo) : T(0), absv(uo) < fin ? absv(uo) : T(0));
  v[1] = absv(ax);
  v[2] = absv(ax - clip(ax, lo, uo));
}

template <typename T>
__device__ __forceinline__ void cert_var_terms(T hx, T aty, T gu, T* v) {
  v[3] = absv(hx);
  v[4] = absv(aty);
  v[5] = absv(gu);
  v[6] = absv(hx + gu + aty);
}

template <typename T>
__device__ __forceinline__ void cert_warp_maxima(const T* v, T* red, int nw) {
#pragma unroll
  for (int q = 0; q < CERT_MAXIMA; ++q) {
    const T w = warp_max(v[q]);
    if (lead_lane_of_warp())
      red[q * nw + warp_index()] = nan_max(red[q * nw + warp_index()], w);
  }
}

template <typename T>
__device__ __forceinline__ void cert_finish(const T* red, int nw, const T* axs,
                                            const T* ys, const T* ls, const T* us, int m,
                                            T* __restrict__ pr, T* __restrict__ du,
                                            T* __restrict__ sv, int b) {
  if (!lead_warp()) return;
  const T big = T(1e20), fin = T(1e19);
  T mx[CERT_MAXIMA] = {};
  QWBC_LANES(i, warps_per_block()) {
#pragma unroll
    for (int q = 0; q < CERT_MAXIMA; ++q) mx[q] = nan_max(mx[q], red[q * nw + i]);
  }
#pragma unroll
  for (int q = 0; q < CERT_MAXIMA; ++q) mx[q] = warp_max(mx[q]);   // side by side
  const T pscale = nan_max(T(1), nan_max(mx[1], mx[0]));
  const T dscale = nan_max(T(1), nan_max(mx[3], nan_max(mx[4], mx[5])));
  T vsv = T(0);
  QWBC_LANES(r, m) {
    const T lo = ls[r], uo = us[r], ax = axs[r], y = ys[r];
    const bool eq = (uo - lo) <= T(1e-9);
    const T d_up = absv(uo) < fin ? nan_max(uo - ax, T(0)) : big;
    const T d_lo = absv(lo) < fin ? nan_max(ax - lo, T(0)) : big;
    const T dist = eq ? T(0) : (y > T(0) ? d_up : d_lo);
    const T a = absv(y) / dscale, c = dist / pscale;
    vsv = nan_max(vsv, (a < c || a != a) ? a : c);   // min, NaN kept
  }
  const T svn = warp_max(vsv);
  if (lead_lane()) {
    pr[b] = mx[2] / pscale;
    du[b] = mx[6] / dscale;
    sv[b] = svn;
  }
}

// Cooperative load of a dense row-major (rows, cols) matrix into shared
// memory with row stride `stride`; global reads are coalesced.
template <typename T>
__device__ __forceinline__ void load_matrix(T* dst, const T* __restrict__ src,
                                            int rows, int cols, int stride) {
  QWBC_FOR(idx, rows * cols) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * stride + c] = src[idx];
  }
}

}  // namespace qwbc
