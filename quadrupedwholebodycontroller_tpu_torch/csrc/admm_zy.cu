// Constraint-space (sigma = 0) ADMM loop + residual epilogue, one launch,
// one block per scenario.
//
// Replaces the TPU kernel pair of ops/pallas/qp_kernel.py in the JAX package:
// admm_zy_iterations_res (_admm_zy_kernel + _zy_epilogue_kernel).  Those keep
// 128 scenarios on the lane axis of batch-minor tiles and run as two calls;
// here the batch-major contiguous inputs are taken as they are, one thread
// block owns one scenario, and the loop and the epilogue share the block.
//
// Bound on this card: operations and bytes are nearly level at the main
// path's 40 iterations (about 0.65 Mflop per scenario against K^-1, A and
// the scaled H, about 26 KB in float32); beyond that the operations grow
// with the iteration count and the bytes do not.  What the design does
// about it: K^-1 and A are read from device memory once into shared memory
// and every iteration's three chained matvecs (A^T t, K^-1 ., A .) run from
// there; z, y and the accumulator V live in registers, one constraint row
// per thread.  The scaled H is needed once, in the epilogue, and is loaded
// over K^-1's slot then.  What still limits the kernel is shared-memory
// bandwidth (one matrix word per multiply-add); register-resident rows or
// tensor-core products are later work.
#include "admm_epilogue.cuh"

namespace qwbc {

template <typename T>
__global__ void admm_zy_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ z0, const T* __restrict__ y0,
    const T* __restrict__ Hs, const T* __restrict__ lo, const T* __restrict__ uo,
    const T* __restrict__ d, const T* __restrict__ e,
    T* __restrict__ xo, T* __restrict__ zo, T* __restrict__ yo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int iters, T alpha, T oma, T w0, T omw0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int sn = row_stride(n);
  T* Ks = smem;              // n * sn   K^-1, later the scaled H
  T* As = Ks + n * sn;       // m * sn
  T* tv = As + m * sn;       // m        t, later V, later y
  T* av = tv + m;            // n        g, A^T t, A^T V
  T* kv = av + n;            // n        K^-1 A^T t, later x
  T* kg = kv + n;            // n        K^-1 g
  T* red = kg + n;           // 32

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const bool is_row = tid < m, is_col = tid < n;

  load_matrix(Ks, Kinv + bn * n, n, n, sn);
  load_matrix(As, A + bm * n, m, n, sn);
  T gj = T(0);
  if (is_col) { gj = g[bn + tid]; av[tid] = gj; }
  __syncthreads();
  if (is_col) kg[tid] = row_dot(Ks, sn, tid, av, n);
  __syncthreads();

  T c = T(0), z = T(0), y = T(0), V = T(0);
  T lv = T(0), uv = T(0), rh = T(1), irh = T(1);
  if (is_row) {
    c = -row_dot(As, sn, tid, kg, n);          // c = -A K^-1 g
    z = z0[bm + tid]; y = y0[bm + tid];
    lv = l[bm + tid]; uv = u[bm + tid];
    rh = rho[bm + tid]; irh = T(1) / rh;
  }

  for (int it = 0; it < iters; ++it) {
    T t = T(0);
    if (is_row) { t = rh * z - y; tv[tid] = t; }
    __syncthreads();
    if (is_col) av[tid] = col_dot(As, sn, tid, tv, m);      // A^T t
    __syncthreads();
    if (is_col) kv[tid] = row_dot(Ks, sn, tid, av, n);      // K^-1 A^T t
    __syncthreads();
    if (is_row) {
      const T z_t = row_dot(As, sn, tid, kv, n) + c;
      const T z_rel = alpha * z_t + oma * z;
      const T z_n = clip(z_rel + y * irh, lv, uv);
      y = y + rh * (z_rel - z_n);
      V = oma * V + alpha * t;
      z = z_n;
    }
  }

  // ---- epilogue: x from the accumulator, then the unscaled certificate ----
  if (is_row) { zo[bm + tid] = z; yo[bm + tid] = y; tv[tid] = V; }
  __syncthreads();
  if (is_col) av[tid] = col_dot(As, sn, tid, tv, m);        // A^T V
  __syncthreads();
  T x = T(0);
  if (is_col) {
    x = w0 * x0[bn + tid] + row_dot(Ks, sn, tid, av, n) - omw0 * kg[tid];
    xo[bn + tid] = x;
    kv[tid] = x;
  }
  if (is_row) tv[tid] = y;
  admm_epilogue(Ks, As, kv, tv, red, sn, n, m, gj, y, Hs, lo, uo, d, e, pr, du, sv);
}

template <typename T>
int launch_admm_zy(const void* Kinv, const void* A, const void* g, const void* l,
                   const void* u, const void* rho, const void* x0, const void* z0,
                   const void* y0, const void* Hs, const void* lo, const void* uo,
                   const void* d, const void* e, void* xo, void* zo, void* yo,
                   void* pr, void* du, void* sv, int B, int n, int m, int iters,
                   T alpha, T oma, T w0, T omw0, void* stream) {
  const int sn = row_stride(n);
  const size_t smem = sizeof(T) * ((size_t)(n + m) * sn + m + 3 * n + 32);
  const int mx = n > m ? n : m;
  const int threads = ((mx + 31) / 32) * 32;
  if (int err = allow_shared_memory<admm_zy_kernel<T>>(smem)) return err;
  admm_zy_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)Kinv, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
      (const T*)rho, (const T*)x0, (const T*)z0, (const T*)y0, (const T*)Hs,
      (const T*)lo, (const T*)uo, (const T*)d, (const T*)e,
      (T*)xo, (T*)zo, (T*)yo, (T*)pr, (T*)du, (T*)sv,
      n, m, iters, alpha, oma, w0, omw0);
  return (int)cudaGetLastError();
}

}  // namespace qwbc

extern "C" {

int qwbc_admm_zy_f32(const void* Kinv, const void* A, const void* g, const void* l,
                     const void* u, const void* rho, const void* x0, const void* z0,
                     const void* y0, const void* Hs, const void* lo, const void* uo,
                     const void* d, const void* e, void* xo, void* zo, void* yo,
                     void* pr, void* du, void* sv, int B, int n, int m, int iters,
                     float alpha, float oma, float w0, float omw0, void* stream) {
  return qwbc::launch_admm_zy<float>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo,
                                     d, e, xo, zo, yo, pr, du, sv, B, n, m, iters,
                                     alpha, oma, w0, omw0, stream);
}

int qwbc_admm_zy_f64(const void* Kinv, const void* A, const void* g, const void* l,
                     const void* u, const void* rho, const void* x0, const void* z0,
                     const void* y0, const void* Hs, const void* lo, const void* uo,
                     const void* d, const void* e, void* xo, void* zo, void* yo,
                     void* pr, void* du, void* sv, int B, int n, int m, int iters,
                     double alpha, double oma, double w0, double omw0, void* stream) {
  return qwbc::launch_admm_zy<double>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo,
                                      d, e, xo, zo, yo, pr, du, sv, B, n, m, iters,
                                      alpha, oma, w0, omw0, stream);
}

}  // extern "C"
