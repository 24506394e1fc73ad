// x-space ADMM loop with the proximal term sigma, with or without the
// residual epilogue, one launch, one block per scenario.
//
// Replaces the TPU kernels of ops/pallas/qp_kernel.py in the JAX package:
// admm_iterations_res (_admm_res_kernel, loop _make_admm_body) with the
// epilogue, admm_iterations (_admm_kernel) without it.  Those keep 128
// scenarios on the lane axis of batch-minor tiles; here the batch-major
// contiguous inputs are taken as they are and one thread block owns one
// scenario.  Each iteration:
//   t = rho z - y,  x~ = K^-1 (sigma x - g + A^T t),  z~ = A x~,
//   x = alpha x~ + (1-alpha) x,  z_rel = alpha z~ + (1-alpha) z,
//   z = clip(z_rel + y / rho, l, u),  y = y + rho (z_rel - z).
//
// Bound on this card: operations and bytes are nearly level at the main
// path's 40 iterations (about 0.61 Mflop per scenario against K^-1, A and
// the scaled H, about 26 KB in float32); beyond that the operations grow
// with the iteration count and the bytes do not.  What the design does
// about it: K^-1 and A are read from device memory once into shared memory
// and every iteration's three matvecs (A^T t, K^-1 ., A .) run from there,
// three barriers an iteration; x lives in the registers of the column
// threads, z and y in those of the row threads.  The epilogue
// (admm_epilogue.cuh) loads the scaled H over K^-1's slot.  What still
// limits the kernel is shared-memory bandwidth (one matrix word per
// multiply-add); the constraint-space kernel (admm_zy.cu) keeps its
// matrices in registers instead.
#include "admm_epilogue.cuh"

namespace qwbc {

template <typename T, bool kEpilogue>
__global__ void admm_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ z0, const T* __restrict__ y0,
    const T* __restrict__ Hs, const T* __restrict__ lo, const T* __restrict__ uo,
    const T* __restrict__ d, const T* __restrict__ e,
    T* __restrict__ xo, T* __restrict__ zo, T* __restrict__ yo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int iters, T sigma, T alpha, T oma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int sn = row_stride(n);
  T* Ks = smem;              // n * sn   K^-1, later the scaled H
  T* As = Ks + n * sn;       // m * sn
  T* tv = As + m * sn;       // m        t, later y
  T* av = tv + m;            // n        sigma x - g + A^T t
  T* kv = av + n;            // n        x~, later x
  T* red = kv + n;           // 32

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const bool is_row = tid < m, is_col = tid < n;

  load_matrix(Ks, Kinv + bn * n, n, n, sn);
  load_matrix(As, A + bm * n, m, n, sn);
  T gj = T(0), x = T(0);
  if (is_col) { gj = g[bn + tid]; x = x0[bn + tid]; }
  T z = T(0), y = T(0), lv = T(0), uv = T(0), rh = T(1), irh = T(1);
  if (is_row) {
    z = z0[bm + tid]; y = y0[bm + tid];
    lv = l[bm + tid]; uv = u[bm + tid];
    rh = rho[bm + tid]; irh = T(1) / rh;
  }

  for (int it = 0; it < iters; ++it) {
    if (is_row) tv[tid] = rh * z - y;
    __syncthreads();
    if (is_col) av[tid] = sigma * x - gj + col_dot(As, sn, tid, tv, m);
    __syncthreads();
    if (is_col) {
      const T x_t = row_dot(Ks, sn, tid, av, n);
      kv[tid] = x_t;
      x = alpha * x_t + oma * x;
    }
    __syncthreads();
    if (is_row) {
      const T z_t = row_dot(As, sn, tid, kv, n);
      const T z_rel = alpha * z_t + oma * z;
      const T z_n = clip(z_rel + y * irh, lv, uv);
      y = y + rh * (z_rel - z_n);
      z = z_n;
    }
  }

  if (is_row) { zo[bm + tid] = z; yo[bm + tid] = y; }
  if (is_col) xo[bn + tid] = x;
  if constexpr (kEpilogue) {
    __syncthreads();                     // every row thread has read kv
    if (is_col) kv[tid] = x;
    if (is_row) tv[tid] = y;
    admm_epilogue(Ks, As, kv, tv, red, sn, n, m, gj, y, Hs, lo, uo, d, e, pr, du, sv);
  }
}

template <typename T, bool kEpilogue>
int launch_admm_t(const void* Kinv, const void* A, const void* g, const void* l,
                  const void* u, const void* rho, const void* x0, const void* z0,
                  const void* y0, const void* Hs, const void* lo, const void* uo,
                  const void* d, const void* e, void* xo, void* zo, void* yo,
                  void* pr, void* du, void* sv, int B, int n, int m, int iters,
                  T sigma, T alpha, T oma, void* stream) {
  const int sn = row_stride(n);
  const size_t smem = sizeof(T) * ((size_t)(n + m) * sn + m + 2 * n + 32);
  const int mx = n > m ? n : m;
  const int threads = ((mx + 31) / 32) * 32;
  if (int err = allow_shared_memory<admm_kernel<T, kEpilogue>>(smem)) return err;
  admm_kernel<T, kEpilogue><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)Kinv, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
      (const T*)rho, (const T*)x0, (const T*)z0, (const T*)y0, (const T*)Hs,
      (const T*)lo, (const T*)uo, (const T*)d, (const T*)e,
      (T*)xo, (T*)zo, (T*)yo, (T*)pr, (T*)du, (T*)sv,
      n, m, iters, sigma, alpha, oma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_admm(const void* Kinv, const void* A, const void* g, const void* l,
                const void* u, const void* rho, const void* x0, const void* z0,
                const void* y0, const void* Hs, const void* lo, const void* uo,
                const void* d, const void* e, void* xo, void* zo, void* yo,
                void* pr, void* du, void* sv, int B, int n, int m, int iters,
                int epilogue, T sigma, T alpha, T oma, void* stream) {
  if (epilogue)
    return launch_admm_t<T, true>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d,
                                  e, xo, zo, yo, pr, du, sv, B, n, m, iters, sigma,
                                  alpha, oma, stream);
  return launch_admm_t<T, false>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d,
                                 e, xo, zo, yo, pr, du, sv, B, n, m, iters, sigma,
                                 alpha, oma, stream);
}

}  // namespace qwbc

extern "C" {

int qwbc_admm_f32(const void* Kinv, const void* A, const void* g, const void* l,
                  const void* u, const void* rho, const void* x0, const void* z0,
                  const void* y0, const void* Hs, const void* lo, const void* uo,
                  const void* d, const void* e, void* xo, void* zo, void* yo,
                  void* pr, void* du, void* sv, int B, int n, int m, int iters,
                  int epilogue, float sigma, float alpha, float oma, void* stream) {
  return qwbc::launch_admm<float>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d,
                                  e, xo, zo, yo, pr, du, sv, B, n, m, iters,
                                  epilogue, sigma, alpha, oma, stream);
}

int qwbc_admm_f64(const void* Kinv, const void* A, const void* g, const void* l,
                  const void* u, const void* rho, const void* x0, const void* z0,
                  const void* y0, const void* Hs, const void* lo, const void* uo,
                  const void* d, const void* e, void* xo, void* zo, void* yo,
                  void* pr, void* du, void* sv, int B, int n, int m, int iters,
                  int epilogue, double sigma, double alpha, double oma,
                  void* stream) {
  return qwbc::launch_admm<double>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d,
                                   e, xo, zo, yo, pr, du, sv, B, n, m, iters,
                                   epilogue, sigma, alpha, oma, stream);
}

}  // extern "C"
