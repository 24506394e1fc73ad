// Safeguarded warm Newton-Schulz inverse of a batch of SPD matrices, one
// block per matrix.
//
// Replaces the TPU kernel ops/pallas/ns_kernel.py::ns_inverse_warm_pallas
// (_ns_warm_kernel) of the JAX package.  That kernel keeps 128 matrices on
// the lane axis and, because its compiler contracts only the leading axis,
// tracks the transposed iterate beside the iterate; here one block owns one
// matrix and computes X (2I - A X) directly.  Semantics, as there:
//   * start from W unless ||I - A W||_inf < 1e3 fails (also for NaN), then
//     from the Jacobi-scaled X0 = (D A D) o (d d^T) / (||DAD||_inf ||DAD||_1),
//     D = diag(d), d = |diag A|^-1/2;
//   * `iters` steps X <- X (2I - A X);
//   * where max |X| < 1e30 fails (a blown-up or NaN iterate), return X0.
//
// Bound on this card: operations.  A warm update of two steps is five n*n
// products (the check and two per step), 2 n^3 operations each: about
// 0.74 Mflop per matrix at n = 42 against 28 KB read and written in
// float32.  What the design does about it: A, W, the iterate and 2I - AX
// live in shared memory (4 n*(n|1) words: 29 KB at n = 42 in float32, 159
// KB at n = 70 in float64, above the 48 KB default, so the launcher raises
// the limit), each thread computes whole entries of a product, and X0 is
// never stored: its entries are recomputed from A where they are needed.
// Tensor-core products are later work.
//
// Written with the stage macros of common.cuh alone, so the file also
// compiles as plain C++ (see common.cuh), where the tests check it.
#include "common.cuh"

namespace qwbc {

__host__ __device__ inline size_t ns_warm_words(int n) {
  return 4 * (size_t)n * row_stride(n) + 4 * (size_t)n + 4;
}

// X0[i][j] from A, d and r1 * c1 (the un-iterated cold start)
template <typename T>
__device__ __forceinline__ T ns_x0(const T* As, int sn, const T* d, T rc, int i, int j) {
  const T dd = d[i] * d[j];
  return (As[i * sn + j] * dd) * dd / rc;
}

template <typename T>
__device__ void ns_warm_block(const T* __restrict__ A, const T* __restrict__ W,
                              T* __restrict__ X, int b, int n, int iters, T* smem) {
  const int sn = row_stride(n), nn = n * n;
  T* As = smem;              // n * sn   A
  T* P = As + n * sn;        // n * sn   W, then the iterate
  T* Q = P + n * sn;         // n * sn   A W, then the next iterate
  T* R = Q + n * sn;         // n * sn   2I - A X
  T* d = R + n * sn;         // n        |diag A|^-1/2
  T* rs = d + n;             // n        row sums / row maxima
  T* cs = rs + n;            // n        column sums
  T* es = cs + n;            // n        row sums of |I - A W|
  T* sc = es + n;            // 4        r1 * c1, warm ok, max |X| ok
  const size_t off = (size_t)b * nn;

  load_matrix(As, A + off, n, n, sn);
  load_matrix(P, W + off, n, n, sn);
  QWBC_SYNC();
  QWBC_FOR(i, n) d[i] = T(1) / sqrt(absv(As[i * sn + i]) + T(1e-30));
  QWBC_FOR(idx, nn) {                        // E = I - A W
    const int i = idx / n, j = idx - i * n;
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc += As[i * sn + k] * P[k * sn + j];
    Q[i * sn + j] = (i == j ? T(1) : T(0)) - acc;
  }
  QWBC_SYNC();
  QWBC_FOR(i, n) {
    T r = T(0), c = T(0), e = T(0);
    for (int j = 0; j < n; ++j) {
      r += absv(As[i * sn + j] * (d[i] * d[j]));
      c += absv(As[j * sn + i] * (d[j] * d[i]));
      e += absv(Q[i * sn + j]);
    }
    rs[i] = r; cs[i] = c; es[i] = e;
  }
  QWBC_SYNC();
  QWBC_FOR(t, 1) {
    T r1 = rs[0], c1 = cs[0], err = es[0];
    for (int i = 1; i < n; ++i) {
      r1 = nan_max(r1, rs[i]); c1 = nan_max(c1, cs[i]); err = nan_max(err, es[i]);
    }
    sc[0] = r1 * c1;
    sc[1] = err < T(1e3) ? T(1) : T(0);        // false for NaN
  }
  QWBC_SYNC();
  if (sc[1] == T(0)) {                         // block-uniform
    QWBC_FOR(idx, nn) {
      const int i = idx / n, j = idx - i * n;
      P[i * sn + j] = ns_x0(As, sn, d, sc[0], i, j);
    }
  }
  QWBC_SYNC();
  for (int it = 0; it < iters; ++it) {
    QWBC_FOR(idx, nn) {                      // R = 2I - A X
      const int i = idx / n, j = idx - i * n;
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += As[i * sn + k] * P[k * sn + j];
      R[i * sn + j] = (i == j ? T(2) : T(0)) - acc;
    }
    QWBC_SYNC();
    QWBC_FOR(idx, nn) {                      // X R
      const int i = idx / n, j = idx - i * n;
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += P[i * sn + k] * R[k * sn + j];
      Q[i * sn + j] = acc;
    }
    QWBC_SYNC();
    T* tmp = P; P = Q; Q = tmp;
  }
  QWBC_FOR(i, n) {
    T v = absv(P[i * sn]);
    for (int j = 1; j < n; ++j) v = nan_max(v, absv(P[i * sn + j]));
    rs[i] = v;
  }
  QWBC_SYNC();
  QWBC_FOR(t, 1) {
    T v = rs[0];
    for (int i = 1; i < n; ++i) v = nan_max(v, rs[i]);
    sc[2] = v < T(1e30) ? T(1) : T(0);       // false for inf and NaN
  }
  QWBC_SYNC();
  QWBC_FOR(idx, nn) {
    const int i = idx / n, j = idx - i * n;
    X[off + idx] = sc[2] != T(0) ? P[i * sn + j] : ns_x0(As, sn, d, sc[0], i, j);
  }
}

#ifdef __CUDACC__

template <typename T>
__global__ void ns_warm_kernel(const T* __restrict__ A, const T* __restrict__ W,
                               T* __restrict__ X, int n, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ns_warm_block<T>(A, W, X, blockIdx.x, n, iters, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
int launch_ns_warm(const void* A, const void* W, void* X, int B, int n, int iters,
                   void* stream) {
  const size_t smem = sizeof(T) * ns_warm_words(n);
  if (int err = allow_shared_memory<ns_warm_kernel<T>>(smem)) return err;
  ns_warm_kernel<T><<<B, 256, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)W, (T*)X, n, iters);
  return (int)cudaGetLastError();
}

#else  // plain C++: one thread runs the blocks one after the other

template <typename T>
int launch_ns_warm(const void* A, const void* W, void* X, int B, int n, int iters,
                   void*) {
  T* smem = new T[ns_warm_words(n)];
  for (int b = 0; b < B; ++b)
    ns_warm_block<T>((const T*)A, (const T*)W, (T*)X, b, n, iters, smem);
  delete[] smem;
  return 0;
}

#endif

}  // namespace qwbc

extern "C" {

int qwbc_ns_warm_f32(const void* A, const void* W, void* X, int B, int n, int iters,
                     void* stream) {
  return qwbc::launch_ns_warm<float>(A, W, X, B, n, iters, stream);
}

int qwbc_ns_warm_f64(const void* A, const void* W, void* X, int B, int n, int iters,
                     void* stream) {
  return qwbc::launch_ns_warm<double>(A, W, X, B, n, iters, stream);
}

}  // extern "C"
