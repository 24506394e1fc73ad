// Active-set polish solve + coupled refinement with a dense H and H^-1
// (n*n), one block per scenario.
//
// Replaces the TPU kernel ops/pallas/polish_kernel.py::polish_solve of the
// JAX package in its dense form (_polish_kernel via _polish_call); the
// compact form is csrc/polish_compact.cu.  That kernel keeps 128 scenarios
// on the lane axis of batch-minor tiles; here the batch-major contiguous
// inputs are taken as they are, one thread block owns one scenario, and
// any batch size B >= 1 works with no padding.  The body is templated on
// how H and H^-1 are applied (DenseApply).
//
// Bound on this card: bytes.  Sinv (m*m), A (m*n), H and H^-1 (2*n*n) are
// about 46 KB per scenario in float32 (n = 42, m = 70) against about 0.3
// Mflop for the solve and five refinement passes.  The design reads each
// matrix from device memory once into shared memory (in float64 about 95
// KB per block, above the 48 KB default, so the launcher raises the limit)
// and runs the whole cascade (solve, refinement, z = clip(Ax), residuals,
// sign violation) from there; B = da * A is never formed (B v = da * (A v),
// B^T w = A^T (da * w)).
#include "common.cuh"

namespace qwbc {

template <typename T>
struct DenseApply {          // an n*n matrix in shared memory
  const T* M;
  int sn, n;
  __device__ __forceinline__ T operator()(int row, const T* v) const {
    return row_dot(M, sn, row, v, n);
  }
};

// The cascade on the resident Sinv, A and the two H applies; `work` holds
// 3n + 2m + 32 scratch words.
template <typename T, typename Apply>
__device__ void polish_body(
    Apply apply_H, Apply apply_Hinv, const T* Ss, const T* As, T* work,
    const T* __restrict__ da_g, const T* __restrict__ g_g,
    const T* __restrict__ b_g, const T* __restrict__ l_g,
    const T* __restrict__ u_g,
    T* __restrict__ xo, T* __restrict__ yo, T* __restrict__ zo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int refine, T reg) {
  const int sn = row_stride(n), sm = row_stride(m);
  T* xs = work;               // n        x
  T* tn = xs + n;             // n        scratch over the variables
  T* tn2 = tn + n;            // n        second scratch over the variables
  T* ws = tn2 + n;            // m        da * (y or dy)
  T* tm = ws + m;             // m        scratch over the constraints
  T* red = tm + m;            // 32

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const bool is_row = tid < m, is_col = tid < n;

  T gj = T(0);
  if (is_col) {
    gj = g_g[bn + tid];
    tn2[tid] = gj;
  }
  T da = T(0), dab = T(0), D = T(0), lv = T(0), uv = T(0), y = T(0);
  if (is_row) {
    da = da_g[bm + tid];
    dab = da * b_g[bm + tid];
    D = (T(1) - da) - reg * da;
    lv = l_g[bm + tid]; uv = u_g[bm + tid];
  }
  __syncthreads();

  // y = Sinv (-(da*b + B Hinv g)),  x = Hinv (-g - B^T y)
  if (is_col) tn[tid] = apply_Hinv(tid, tn2);
  __syncthreads();
  if (is_row) tm[tid] = -(dab + da * row_dot(As, sn, tid, tn, n));
  __syncthreads();
  if (is_row) { y = row_dot(Ss, sm, tid, tm, m); ws[tid] = da * y; }
  __syncthreads();
  if (is_col) tn[tid] = -gj - col_dot(As, sn, tid, ws, m);
  __syncthreads();
  T x = T(0);
  if (is_col) { x = apply_Hinv(tid, tn); xs[tid] = x; }
  __syncthreads();

  for (int it = 0; it < refine; ++it) {
    // r1 = -g - H x - B^T y (per variable), r2 = da*b - B x - D y (per row)
    T r1 = T(0), r2 = T(0);
    if (is_col) {
      r1 = -gj - apply_H(tid, xs) - col_dot(As, sn, tid, ws, m);
      tn2[tid] = r1;
    }
    if (is_row) r2 = dab - da * row_dot(As, sn, tid, xs, n) - D * y;
    __syncthreads();
    if (is_col) tn[tid] = apply_Hinv(tid, tn2);
    __syncthreads();
    if (is_row) tm[tid] = da * row_dot(As, sn, tid, tn, n) - r2;
    __syncthreads();
    T dy = T(0);
    if (is_row) { dy = row_dot(Ss, sm, tid, tm, m); ws[tid] = da * dy; }
    __syncthreads();
    if (is_col) tn[tid] = r1 - col_dot(As, sn, tid, ws, m);
    __syncthreads();
    // xs was last read before this pass's first barrier and ws before the
    // barrier just above, so both can be rewritten here
    if (is_col) { x = x + apply_Hinv(tid, tn); xs[tid] = x; }
    if (is_row) { y = y + dy; ws[tid] = da * y; }
    __syncthreads();
  }

  // z = clip(A x), certificate on the resident data
  if (is_row) tm[tid] = y;
  __syncthreads();
  T ax = T(0);
  if (is_row) {
    ax = row_dot(As, sn, tid, xs, n);
    zo[bm + tid] = clip(ax, lv, uv);
    yo[bm + tid] = y;
  }
  T hx = T(0), aty = T(0);
  if (is_col) {
    xo[bn + tid] = x;
    hx = apply_H(tid, xs);
    aty = col_dot(As, sn, tid, tm, m);          // A^T y, not active-masked
  }
  kkt_epilogue(is_row, is_col, ax, y, lv, uv, hx, aty, gj, red, pr, du, sv, b);
}

template <typename T>
__global__ void polish_dense_kernel(
    const T* __restrict__ H, const T* __restrict__ Hinv,
    const T* __restrict__ Sinv, const T* __restrict__ A,
    const T* __restrict__ da, const T* __restrict__ g, const T* __restrict__ bb,
    const T* __restrict__ l, const T* __restrict__ u,
    T* __restrict__ xo, T* __restrict__ yo, T* __restrict__ zo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int refine, T reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int sn = row_stride(n), sm = row_stride(m);
  T* Ss = smem;               // m * sm   Sinv
  T* As = Ss + m * sm;        // m * sn   A
  T* Hs = As + m * sn;        // n * sn   regularized H
  T* His = Hs + n * sn;       // n * sn   H^-1
  T* work = His + n * sn;     // 3n + 2m + 32

  const int b = blockIdx.x;
  load_matrix(Ss, Sinv + (size_t)b * m * m, m, m, sm);
  load_matrix(As, A + (size_t)b * m * n, m, n, sn);
  load_matrix(Hs, H + (size_t)b * n * n, n, n, sn);
  load_matrix(His, Hinv + (size_t)b * n * n, n, n, sn);
  polish_body<T>(DenseApply<T>{Hs, sn, n}, DenseApply<T>{His, sn, n}, Ss, As, work,
                 da, g, bb, l, u, xo, yo, zo, pr, du, sv, n, m, refine, reg);
}

template <typename T>
int launch_polish_dense(const void* H, const void* Hinv, const void* Sinv,
                        const void* A, const void* da, const void* g,
                        const void* bb, const void* l, const void* u, void* xo,
                        void* yo, void* zo, void* pr, void* du, void* sv, int B,
                        int n, int m, int refine, T reg, void* stream) {
  const int sn = row_stride(n), sm = row_stride(m);
  const size_t smem = sizeof(T) * ((size_t)m * sm + (size_t)m * sn +
                                   2 * (size_t)n * sn + 3 * n + 2 * m + 32);
  const int mx = n > m ? n : m;
  const int threads = ((mx + 31) / 32) * 32;
  if (int err = allow_shared_memory<polish_dense_kernel<T>>(smem)) return err;
  polish_dense_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)Hinv, (const T*)Sinv, (const T*)A, (const T*)da,
      (const T*)g, (const T*)bb, (const T*)l, (const T*)u, (T*)xo, (T*)yo,
      (T*)zo, (T*)pr, (T*)du, (T*)sv, n, m, refine, reg);
  return (int)cudaGetLastError();
}

}  // namespace qwbc

extern "C" {

int qwbc_polish_dense_f32(const void* H, const void* Hinv, const void* Sinv,
                          const void* A, const void* da, const void* g,
                          const void* bb, const void* l, const void* u, void* xo,
                          void* yo, void* zo, void* pr, void* du, void* sv, int B,
                          int n, int m, int refine, float reg, void* stream) {
  return qwbc::launch_polish_dense<float>(H, Hinv, Sinv, A, da, g, bb, l, u, xo, yo,
                                          zo, pr, du, sv, B, n, m, refine, reg,
                                          stream);
}

int qwbc_polish_dense_f64(const void* H, const void* Hinv, const void* Sinv,
                          const void* A, const void* da, const void* g,
                          const void* bb, const void* l, const void* u, void* xo,
                          void* yo, void* zo, void* pr, void* du, void* sv, int B,
                          int n, int m, int refine, double reg, void* stream) {
  return qwbc::launch_polish_dense<double>(H, Hinv, Sinv, A, da, g, bb, l, u, xo, yo,
                                           zo, pr, du, sv, B, n, m, refine, reg,
                                           stream);
}

}  // extern "C"
