// The residual epilogue of the x-space ADMM kernel (admm.cu): the unscaled
// relative KKT residuals and sign violation of the block's scaled iterate,
// on the block's resident scaled A.
#pragma once
#include "common.cuh"

namespace qwbc {

// Preconditions: thread j < n holds g_j (scaled) in `gj` and has written x_j
// (scaled) to kv[j]; thread i < m holds y_i (scaled) in `y` and has written
// it to tv[i]; nothing reads Ks any more.  Loads the scaled H over Ks and
// scores the pair unscaled through A x = (As xs)/e, H x = (Hs xs)/d,
// A^T y = (As^T ys)/d, g = gs/d, y = e ys against the unscaled bounds.
template <typename T>
__device__ void admm_epilogue(T* Ks, const T* As, const T* kv, const T* tv, T* red,
                              int sn, int n, int m, T gj, T y,
                              const T* __restrict__ Hs, const T* __restrict__ lo,
                              const T* __restrict__ uo, const T* __restrict__ d,
                              const T* __restrict__ e, T* __restrict__ pr,
                              T* __restrict__ du, T* __restrict__ sv) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const bool is_row = tid < m, is_col = tid < n;
  __syncthreads();                                          // Ks is free now
  load_matrix(Ks, Hs + bn * n, n, n, sn);
  __syncthreads();

  T ax = T(0), yu = T(0), lov = T(0), uov = T(0);
  if (is_row) {
    const T ei = e[bm + tid];
    ax = row_dot(As, sn, tid, kv, n) / ei;
    yu = ei * y;
    lov = lo[bm + tid]; uov = uo[bm + tid];
  }
  T hx = T(0), aty = T(0), gu = T(0);
  if (is_col) {
    const T dj = d[bn + tid];
    hx = row_dot(Ks, sn, tid, kv, n) / dj;
    aty = col_dot(As, sn, tid, tv, m) / dj;
    gu = gj / dj;
  }
  kkt_epilogue(is_row, is_col, ax, yu, lov, uov, hx, aty, gu, red, pr, du, sv, b);
}

}  // namespace qwbc
