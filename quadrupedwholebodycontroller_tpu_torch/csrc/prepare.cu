// Ruiz equilibration + problem / warm-start scaling, one block per scenario.
//
// Replaces the TPU kernel ops/pallas/prepare_kernel.py::prepare_scaled
// (_prepare_kernel) of the JAX package.  That kernel keeps the scenario batch
// on the lane axis of batch-minor tiles; here the batch-major contiguous
// inputs are taken as they are and one thread block owns one scenario.
//
// Bound on this card: bytes.  H (n*n) and A (m*n) are read once and written
// once scaled (about 38 KB per scenario at n = 42, m = 70 in float32)
// against roughly 50 kflop of max-reductions.  The design reads H and A from
// device memory exactly once into shared memory, runs all sweeps there, and
// writes the scaled problem in one coalesced pass.  The shell: H and A
// arrive by cp.async, and g, l, u and the warm start into shared memory in
// the same group (the tail reads them only in its last stage); 2 (n + m)
// threads up to 256 (224 at n = 42, m = 70), so that each sweep's n + m
// column and row tasks, two lanes a task (prepare_tail.cuh), take one round.
#include "prepare_tail.cuh"

namespace qwbc {

// at most this many threads a block, six blocks an SM: 40 registers a thread
// where the compiler alone took 56 (float32) and 64 (float64)
constexpr int PREPARE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PREPARE_THREADS, 6) prepare_kernel(
    const T* __restrict__ H, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ wx,
    const T* __restrict__ wz, const T* __restrict__ wy,
    T* __restrict__ sH, T* __restrict__ sA, T* __restrict__ sg,
    T* __restrict__ sl, T* __restrict__ su, T* __restrict__ rho,
    T* __restrict__ wxs, T* __restrict__ wzs, T* __restrict__ wys,
    T* __restrict__ dout, T* __restrict__ eout,
    int n, int m, int sweeps, T rho0, T rho_eq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int sn = row_stride(n);
  T* Hs = smem;              // n * sn
  T* As = Hs + n * sn;       // m * sn
  T* d0 = As + m * sn;       // n, m, n, m: the scalings, double-buffered
  T* e0 = d0 + n;
  T* d1 = e0 + m;
  T* e1 = d1 + n;
  T* gs = e1 + m;            // n, n: g and the warm x
  T* wxs_in = gs + n;
  T* ls = wxs_in + n;        // m, m, m, m: l, u and the warm z, y
  T* us = ls + m;
  T* wzs_in = us + m;
  T* wys_in = wzs_in + m;

  const size_t bn = (size_t)blockIdx.x * n, bm = (size_t)blockIdx.x * m;
  async_load_matrix(Hs, H + bn * n, n, n, sn);
  async_load_matrix(As, A + bm * n, m, n, sn);
  async_load_vector(gs, g + bn, n);
  async_load_vector(wxs_in, wx + bn, n);
  async_load_vector(ls, l + bm, m);
  async_load_vector(us, u + bm, m);
  async_load_vector(wzs_in, wz + bm, m);
  async_load_vector(wys_in, wy + bm, m);
  async_commit();
  async_wait<0>();
  __syncthreads();
  // the body is shared with the fused setup kernel (prepare_tail.cuh)
  prepare_tail(DenseH<T>{Hs, sn}, As, sn, d0, e0, d1, e1, gs, ls, us,
               wxs_in, wzs_in, wys_in, false,
               sH + bn * n, sA + bm * n, sg + bn, sl + bm, su + bm, rho + bm,
               wxs + bn, wzs + bm, wys + bm, dout + bn, eout + bm,
               n, m, sweeps, rho0, rho_eq);
}

template <typename T>
int launch_prepare(const void* H, const void* A, const void* g, const void* l,
                   const void* u, const void* wx, const void* wz, const void* wy,
                   void* sH, void* sA, void* sg, void* sl, void* su, void* rho,
                   void* wxs, void* wzs, void* wys, void* d, void* e,
                   int B, int n, int m, int sweeps, T rho0, T rho_eq,
                   void* stream) {
  const int sn = row_stride(n);
  const size_t smem = sizeof(T) * ((size_t)(n + m) * sn + 4 * (n + m) + 2 * m);
  const int tasks = 2 * (n + m);
  const int threads = tasks < PREPARE_THREADS ? (tasks + 31) / 32 * 32 : PREPARE_THREADS;
  if (int err = allow_shared_memory<prepare_kernel<T>>(smem)) return err;
  prepare_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
      (const T*)wx, (const T*)wz, (const T*)wy,
      (T*)sH, (T*)sA, (T*)sg, (T*)sl, (T*)su, (T*)rho,
      (T*)wxs, (T*)wzs, (T*)wys, (T*)d, (T*)e, n, m, sweeps, rho0, rho_eq);
  return (int)cudaGetLastError();
}

}  // namespace qwbc

extern "C" {

int qwbc_prepare_f32(const void* H, const void* A, const void* g, const void* l,
                     const void* u, const void* wx, const void* wz, const void* wy,
                     void* sH, void* sA, void* sg, void* sl, void* su, void* rho,
                     void* wxs, void* wzs, void* wys, void* d, void* e,
                     int B, int n, int m, int sweeps, float rho0, float rho_eq,
                     void* stream) {
  return qwbc::launch_prepare<float>(H, A, g, l, u, wx, wz, wy, sH, sA, sg, sl,
                                     su, rho, wxs, wzs, wys, d, e, B, n, m,
                                     sweeps, rho0, rho_eq, stream);
}

int qwbc_prepare_f64(const void* H, const void* A, const void* g, const void* l,
                     const void* u, const void* wx, const void* wz, const void* wy,
                     void* sH, void* sA, void* sg, void* sl, void* su, void* rho,
                     void* wxs, void* wzs, void* wys, void* d, void* e,
                     int B, int n, int m, int sweeps, double rho0, double rho_eq,
                     void* stream) {
  return qwbc::launch_prepare<double>(H, A, g, l, u, wx, wz, wy, sH, sA, sg, sl,
                                      su, rho, wxs, wzs, wys, d, e, B, n, m,
                                      sweeps, rho0, rho_eq, stream);
}

const char* qwbc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
