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
// writes the scaled problem in one coalesced pass.
//
// Equality rows are detected on the UNSCALED bounds (u - l <= 1e-9): the
// scaled difference e*u - e*l may be contracted into an FMA whose exact
// partial product makes an exactly-equal row look unequal.
#include "common.cuh"

namespace qwbc {

template <typename T>
__global__ void prepare_kernel(
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
  T* ds = As + m * sn;       // n
  T* es = ds + n;            // m

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  load_matrix(Hs, H + bn * n, n, n, sn);
  load_matrix(As, A + bm * n, m, n, sn);
  if (tid < n) ds[tid] = T(1);
  if (tid < m) es[tid] = T(1);
  __syncthreads();

  for (int s = 0; s < sweeps; ++s) {
    T cx = T(0), rz = T(0);
    if (tid < n) {           // column tid of |H| d d and |A| e d
      const T dj = ds[tid];
      for (int i = 0; i < n; ++i)
        cx = nan_max(cx, absv(Hs[i * sn + tid]) * dj * ds[i]);
      for (int i = 0; i < m; ++i)
        cx = nan_max(cx, absv(As[i * sn + tid]) * es[i] * dj);
    }
    if (tid < m) {           // row tid of |A| e d
      const T ei = es[tid];
      for (int j = 0; j < n; ++j)
        rz = nan_max(rz, absv(As[tid * sn + j]) * ei * ds[j]);
    }
    __syncthreads();
    if (tid < n) ds[tid] = ds[tid] * (T(1) / sqrt(nan_max(cx, T(1e-8))));
    if (tid < m) es[tid] = es[tid] * (T(1) / sqrt(nan_max(rz, T(1e-8))));
    __syncthreads();
  }

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    sH[bn * n + idx] = Hs[i * sn + j] * ds[j] * ds[i];
  }
  for (int idx = tid; idx < m * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    sA[bm * n + idx] = As[i * sn + j] * es[i] * ds[j];
  }
  if (tid < n) {
    const T d = ds[tid];
    sg[bn + tid] = d * g[bn + tid];
    wxs[bn + tid] = wx[bn + tid] / d;
    dout[bn + tid] = d;
  }
  if (tid < m) {
    const T e = es[tid], lv = l[bm + tid], uv = u[bm + tid];
    sl[bm + tid] = e * lv;
    su[bm + tid] = e * uv;
    rho[bm + tid] = ((uv - lv) <= T(1e-9)) ? rho_eq : rho0;
    wzs[bm + tid] = wz[bm + tid] * e;
    wys[bm + tid] = wy[bm + tid] / e;
    eout[bm + tid] = e;
  }
}

template <typename T>
int launch_prepare(const void* H, const void* A, const void* g, const void* l,
                   const void* u, const void* wx, const void* wz, const void* wy,
                   void* sH, void* sA, void* sg, void* sl, void* su, void* rho,
                   void* wxs, void* wzs, void* wys, void* d, void* e,
                   int B, int n, int m, int sweeps, T rho0, T rho_eq,
                   void* stream) {
  const int sn = row_stride(n);
  const size_t smem = sizeof(T) * ((size_t)(n + m) * sn + n + m);
  const int mx = n > m ? n : m;
  const int threads = ((mx + 31) / 32) * 32;
  if (int err = allow_shared_memory(prepare_kernel<T>, smem)) return err;
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
