// Active-set polish solve + coupled refinement, one block per scenario, in
// two variants: H and H^-1 compact (a diagonal plus one dense k*k block) or
// dense (n*n).
//
// Replaces the TPU kernel ops/pallas/polish_kernel.py::polish_solve of the
// JAX package, both variants (_polish_kernel_compact and _polish_kernel via
// _polish_call).  That kernel keeps 128 scenarios on the lane axis of
// batch-minor tiles; here the batch-major contiguous inputs are taken as
// they are, one thread block owns one scenario, and any batch size B >= 1
// works with no padding.  One body serves both variants; it is templated
// on how H and H^-1 are applied (CompactApply, DenseApply).
//
// Bound on this card: bytes.  Compact: Sinv (m*m), A (m*n) and the two k*k
// blocks are about 32 KB per scenario in float32 (n = 42, m = 70, k = 12)
// against about 0.2 Mflop for the solve and five refinement passes.
// Dense: H and H^-1 add 2*n*n, about 46 KB per scenario in float32, and
// the solve about 0.3 Mflop.  The design reads each matrix from device
// memory once into shared memory (dense in float64: about 95 KB per block,
// above the 48 KB default, so the launcher raises the limit) and runs the
// whole cascade (solve, refinement, z = clip(Ax), residuals, sign
// violation) from there; B = da * A is never formed (B v = da * (A v),
// B^T w = A^T (da * w)).
#include "common.cuh"

namespace qwbc {

// (diag + blk at rows start:start+k) @ v for row `row`; diag is zero on the
// block rows, so the two terms never overlap.
template <typename T>
__device__ __forceinline__ T blockdiag_row(const T* diag, const T* blk, int sk,
                                           int start, int k, int row,
                                           const T* v) {
  if (row >= start && row < start + k)
    return row_dot(blk, sk, row - start, v + start, k);
  return diag[row] * v[row];
}

template <typename T>
struct CompactApply {        // diag + one k*k block, both in shared memory
  const T* diag;
  const T* blk;
  int sk, start, k;
  __device__ __forceinline__ T operator()(int row, const T* v) const {
    return blockdiag_row(diag, blk, sk, start, k, row, v);
  }
};

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
__global__ void polish_compact_kernel(
    const T* __restrict__ hd, const T* __restrict__ hblk,
    const T* __restrict__ hid, const T* __restrict__ hiblk,
    const T* __restrict__ Sinv, const T* __restrict__ A,
    const T* __restrict__ da, const T* __restrict__ g, const T* __restrict__ bb,
    const T* __restrict__ l, const T* __restrict__ u,
    T* __restrict__ xo, T* __restrict__ yo, T* __restrict__ zo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int k, int start, int refine, T reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int sn = row_stride(n), sm = row_stride(m), sk = row_stride(k);
  T* Ss = smem;               // m * sm   Sinv
  T* As = Ss + m * sm;        // m * sn   A
  T* Hb = As + m * sn;        // k * sk   H block
  T* Hib = Hb + k * sk;       // k * sk   H^-1 block
  T* hds = Hib + k * sk;      // n        H diagonal
  T* hids = hds + n;          // n        H^-1 diagonal
  T* work = hids + n;         // 3n + 2m + 32

  const int b = blockIdx.x, tid = threadIdx.x;
  load_matrix(Ss, Sinv + (size_t)b * m * m, m, m, sm);
  load_matrix(As, A + (size_t)b * m * n, m, n, sn);
  load_matrix(Hb, hblk + (size_t)b * k * k, k, k, sk);
  load_matrix(Hib, hiblk + (size_t)b * k * k, k, k, sk);
  if (tid < n) {
    hds[tid] = hd[(size_t)b * n + tid];
    hids[tid] = hid[(size_t)b * n + tid];
  }
  polish_body<T>(CompactApply<T>{hds, Hb, sk, start, k},
                 CompactApply<T>{hids, Hib, sk, start, k}, Ss, As, work,
                 da, g, bb, l, u, xo, yo, zo, pr, du, sv, n, m, refine, reg);
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
int launch_polish(const void* hd, const void* hblk, const void* hid,
                  const void* hiblk, const void* Sinv, const void* A,
                  const void* da, const void* g, const void* bb, const void* l,
                  const void* u, void* xo, void* yo, void* zo, void* pr,
                  void* du, void* sv, int B, int n, int m, int k, int start,
                  int refine, T reg, void* stream) {
  const int sn = row_stride(n), sm = row_stride(m), sk = row_stride(k);
  const size_t smem = sizeof(T) * ((size_t)m * sm + (size_t)m * sn +
                                   2 * (size_t)k * sk + 5 * n + 2 * m + 32);
  const int mx = n > m ? n : m;
  const int threads = ((mx + 31) / 32) * 32;
  if (int err = allow_shared_memory<polish_compact_kernel<T>>(smem)) return err;
  polish_compact_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)hd, (const T*)hblk, (const T*)hid, (const T*)hiblk,
      (const T*)Sinv, (const T*)A, (const T*)da, (const T*)g, (const T*)bb,
      (const T*)l, (const T*)u, (T*)xo, (T*)yo, (T*)zo, (T*)pr, (T*)du, (T*)sv,
      n, m, k, start, refine, reg);
  return (int)cudaGetLastError();
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

int qwbc_polish_f32(const void* hd, const void* hblk, const void* hid,
                    const void* hiblk, const void* Sinv, const void* A,
                    const void* da, const void* g, const void* bb, const void* l,
                    const void* u, void* xo, void* yo, void* zo, void* pr,
                    void* du, void* sv, int B, int n, int m, int k, int start,
                    int refine, float reg, void* stream) {
  return qwbc::launch_polish<float>(hd, hblk, hid, hiblk, Sinv, A, da, g, bb, l, u,
                                    xo, yo, zo, pr, du, sv, B, n, m, k, start,
                                    refine, reg, stream);
}

int qwbc_polish_f64(const void* hd, const void* hblk, const void* hid,
                    const void* hiblk, const void* Sinv, const void* A,
                    const void* da, const void* g, const void* bb, const void* l,
                    const void* u, void* xo, void* yo, void* zo, void* pr,
                    void* du, void* sv, int B, int n, int m, int k, int start,
                    int refine, double reg, void* stream) {
  return qwbc::launch_polish<double>(hd, hblk, hid, hiblk, Sinv, A, da, g, bb, l, u,
                                     xo, yo, zo, pr, du, sv, B, n, m, k, start,
                                     refine, reg, stream);
}

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
