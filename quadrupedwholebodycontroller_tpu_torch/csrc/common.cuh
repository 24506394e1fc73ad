// Helpers shared by the kernels: one thread block per scenario, the
// scenario's matrices in (dynamic) shared memory with an odd row stride,
// vectors in shared memory, one thread per output row.
//
// Code written with QWBC_FOR / QWBC_SYNC alone (every value that crosses a
// barrier lives in shared memory, none in a register) also compiles as plain
// C++: a block is then one thread that runs each stage's items in turn, in
// rising or falling order (qwbc_host_reverse), so a test without a GPU can
// check the arithmetic and that no item of a stage reads what another item
// of the same stage writes.  It cannot show a missing barrier.
#pragma once
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define QWBC_FOR(i, n) for (int i = threadIdx.x; i < (n); i += blockDim.x)
#define QWBC_SYNC() __syncthreads()
#else
#include <math.h>
#include <cmath>
#include <cstddef>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
extern "C" int qwbc_host_reverse;
#define QWBC_FOR(i, n)                                                       \
  for (int i##_k = 0, i##_n = (n), i = (qwbc_host_reverse ? i##_n - 1 : 0);  \
       i##_k < i##_n; ++i##_k, i += (qwbc_host_reverse ? -1 : 1))
#define QWBC_SYNC() ((void)0)
#endif

namespace qwbc {

// Odd row stride: thread i reading M[i*stride + j] for fixed j then hits 32
// different banks across a warp (42- and 70-word rows would 2-way conflict).
__host__ __device__ inline int row_stride(int cols) { return cols | 1; }

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

#ifdef __CUDACC__
// Block-wide NaN-propagating max; every thread of the block must call it.
// `scratch` holds one value per warp.  Returns the max to all threads.
template <typename T>
__device__ T block_max(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                 // previous readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = nan_max(r, scratch[i]);
  return r;
}

#endif  // __CUDACC__

// out_row = sum_j M[row][j] * v[j]   (M in shared memory, v in shared memory)
template <typename T>
__device__ __forceinline__ T row_dot(const T* M, int stride, int row,
                                     const T* v, int cols) {
  T acc = T(0);
  const T* r = M + row * stride;
  for (int j = 0; j < cols; ++j) acc += r[j] * v[j];
  return acc;
}

// out_col = sum_i M[i][col] * w[i]   (the transposed product)
template <typename T>
__device__ __forceinline__ T col_dot(const T* M, int stride, int col,
                                     const T* w, int rows) {
  T acc = T(0);
  for (int i = 0; i < rows; ++i) acc += M[i * stride + col] * w[i];
  return acc;
}

#ifdef __CUDACC__
// Relative KKT residuals (OSQP normalization) and sign violation of an
// unscaled primal/dual pair, from per-thread row/column values:
//   thread i < m holds ax_i, y_i (unscaled) and the clipped bounds lo_i, uo_i;
//   thread j < n holds hx_j, aty_j, g_j (unscaled).
// Thread 0 writes pr[b], du[b], sv[b].
template <typename T>
__device__ void kkt_epilogue(bool is_row, bool is_col, T ax, T y, T lo, T uo,
                             T hx, T aty, T gu, T* red,
                             T* pr, T* du, T* sv, int b) {
  const T big = T(1e20), fin = T(1e19);
  const bool l_fin = absv(lo) < fin, u_fin = absv(uo) < fin;
  T v_fb = T(0), v_ax = T(0), v_pr = T(0);
  if (is_row) {
    v_fb = nan_max(l_fin ? absv(lo) : T(0), u_fin ? absv(uo) : T(0));
    v_ax = absv(ax);
    v_pr = absv(ax - clip(ax, lo, uo));
  }
  T v_h = T(0), v_a = T(0), v_g = T(0), v_du = T(0);
  if (is_col) {
    v_h = absv(hx); v_a = absv(aty); v_g = absv(gu);
    v_du = absv(hx + gu + aty);
  }
  const T finite_b = block_max(v_fb, red);
  const T pscale = nan_max(T(1), nan_max(block_max(v_ax, red), finite_b));
  const T dscale = nan_max(
      T(1), nan_max(block_max(v_h, red),
                    nan_max(block_max(v_a, red), block_max(v_g, red))));
  const T prn = block_max(v_pr, red);
  const T dun = block_max(v_du, red);
  T v_sv = T(0);
  if (is_row) {
    const bool eq = (uo - lo) <= T(1e-9);
    const T d_up = u_fin ? nan_max(uo - ax, T(0)) : big;
    const T d_lo = l_fin ? nan_max(ax - lo, T(0)) : big;
    const T dist = eq ? T(0) : (y > T(0) ? d_up : d_lo);
    const T a = absv(y) / dscale, c = dist / pscale;
    v_sv = (a < c || a != a) ? a : c;   // min, NaN kept
  }
  const T svn = block_max(v_sv, red);
  if (threadIdx.x == 0) {
    pr[b] = prn / pscale;
    du[b] = dun / dscale;
    sv[b] = svn;
  }
}

#endif  // __CUDACC__

}  // namespace qwbc
