// Active-set polish solve + coupled refinement, one block per scenario, in
// two forms of H and H^-1: compact (a diagonal plus one dense k*k block)
// and dense (n*n).
//
// Replaces the TPU kernel ops/pallas/polish_kernel.py::polish_solve of the
// JAX package in both its forms (_polish_kernel_compact; _polish_kernel via
// _polish_call).  It computes
//   y = Sinv (-(da*b + B Hinv g)),  x = Hinv (-g - B^T y),
//   `refine` passes  r1 = -g - H x - B^T y,  r2 = da*b - B x - D y,
//                    dy = Sinv (B Hinv r1 - r2),  dx = Hinv (r1 - B^T dy),
//   z = clip(A x, l, u), the relative KKT residuals pr, du and the sign
//   violation sv,
// with B = da * A never formed and l, u clipped to +-1e20 as they come in.
// Any batch size B >= 1, no padding.  One body (polish_block) is
// instantiated for both forms; only where H and H^-1 sit in shared memory,
// how they come in and how a row of them is applied differ (CompactH,
// DenseH).
//
// Bound on this card: bytes.  Sinv (m*m), A (m*n) and H, H^-1 are about 33
// KB per scenario in float32 in the compact form (n = 42, m = 70, k = 12:
// Sinv 19.6 KB, A 11.8 KB) and 46 KB in the dense one, against about 0.17
// and 0.3 Mflop for the solve and five refinement passes.  The matrices are
// read from device memory once into shared memory and the whole cascade
// runs from there.
//
// What the design does about the shared-memory traffic.  Measured on an
// NVIDIA H100 (tools/torch_kernel_times.py, with 0 and 5 refinement
// passes), the one-thread-per-row kernel this replaces was not held back
// by shared-memory bandwidth: at B = 32 a block took ~50 us, 31 of them
// for the load (each element waited for in turn), the first solve and the
// certificate, and ~0.7 us for each barrier-separated stage whatever its
// arithmetic; at B = 4096 the batch runs in ~5 waves of 6 blocks an SM.
// The sums keep that kernel's order exactly: every dot product is one
// accumulator over j = 0, 1, ... (splitting it across lanes re-rounds the
// polish, and the control step's path-against-path torque checks sit close
// enough to the certificate's edge to notice), so the outputs are the old
// kernel's bit for bit.  Within that:
//   * the load is asynchronous and all in flight at once (cp.async, 4 or 8
//     bytes an element into the padded rows): A, H and H^-1 and the
//     vectors first, Sinv second, so the first two stages (H^-1 g, A H^-1
//     g) run while Sinv arrives;
//   * a dot product keeps the loads of its next eight terms in flight
//     while the multiply-adds of these eight run, and takes the vector's
//     eight by two 16-byte loads (one 16-byte broadcast serves every row;
//     the vector regions are padded to eight words); only the last batch
//     checks the length;
//   * one thread an output, the variables on warps of their own in the
//     stages that hold both, so no warp runs a 70-long column chain and a
//     42-long row chain one after the other; the B^T y that the next
//     pass's residual needs is summed beside B^T dy, one stage earlier;
//   * the certificate's eight maxima (order-free): seven reduced per warp
//     in the last product stage, the sign violation by the first warp
//     after one barrier.
// Shared memory is the matrices with odd row strides (a thread a row reads
// 32 different banks) and 5 + 10 padded vectors, plus the compact form's
// two diagonals: compact 37.5 KB in float32 (6 blocks an SM), 75 KB in
// float64 (3); dense 50 KB (4), 101 KB (2).
//
// Written with the stage macros of common.cuh alone (every value that
// crosses a barrier lives in shared memory), so the file also compiles as
// plain C++ (see common.cuh), where the tests check it.
#include "common.cuh"

namespace qwbc {

// one thread an item; in the stages over both the variables and the rows
// the n = 42 variables take the first 64 threads and the m = 70 rows the
// next, so no warp runs both kinds: 134 of 160 threads, one round
constexpr int POLISH_THREADS = 160;
constexpr int NW = POLISH_THREADS / 32;   // warps of a block

// Eight terms of a dot product into registers; CHECK: the batch may pass
// len (zeros there).  VV: v is 16-byte aligned at j0 and readable up to
// j0 + 8 (a vector region padded to eight words), so its eight entries
// come in by 16-byte loads.
template <bool VV, bool CHECK, typename T>
__device__ __forceinline__ void load8(const T* a, int sa, const T* v, int j0, int len,
                                      T* x, T* w) {
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = !CHECK || j0 + u < len ? a[(j0 + u) * sa] : T(0);
#ifdef __CUDACC__
  if constexpr (VV) {
    if constexpr (sizeof(T) == 4) {
      const float4 p = *reinterpret_cast<const float4*>(v + j0);
      const float4 q = *reinterpret_cast<const float4*>(v + j0 + 4);
      w[0] = p.x; w[1] = p.y; w[2] = p.z; w[3] = p.w;
      w[4] = q.x; w[5] = q.y; w[6] = q.z; w[7] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < 8; u += 2) {
        const double2 p = *reinterpret_cast<const double2*>(v + j0 + u);
        w[u] = p.x; w[u + 1] = p.y;
      }
    }
    return;
  }
#endif
#pragma unroll
  for (int u = 0; u < 8; ++u) w[u] = !CHECK || j0 + u < len ? v[j0 + u] : T(0);
}

// sum_j a[j * sa] * v[j] for j = 0, 1, ... in order, in one accumulator
// (the rounding of the plain loop), the loads of the next eight terms in
// flight while the multiply-adds of these eight run; only the last batch
// checks against len
template <bool VV, typename T>
__device__ __forceinline__ T seq_dot(const T* a, int sa, const T* v, int len) {
  T acc = T(0), xa[8], wa[8], xb[8], wb[8];
  const auto load = [&](int j0, T* x, T* w) {
    if (j0 + 8 <= len) load8<VV, false>(a, sa, v, j0, len, x, w);
    else load8<VV, true>(a, sa, v, j0, len, x, w);
  };
  const auto fma8 = [&](int j0, const T* x, const T* w) {
    if (j0 + 8 <= len) {
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += x[u] * w[u];
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < len) acc += x[u] * w[u];
    }
  };
  if (len <= 0) return acc;
  load(0, xa, wa);
#pragma unroll 1
  for (int j0 = 0;; j0 += 16) {
    if (j0 + 8 < len) load(j0 + 8, xb, wb);
    fma8(j0, xa, wa);
    if (j0 + 8 >= len) break;
    if (j0 + 16 < len) load(j0 + 16, xa, wa);
    fma8(j0 + 8, xb, wb);
    if (j0 + 16 >= len) break;
  }
  return acc;
}

// (diag + blk at rows start:start+k) @ v for row `row`; diag is zero on the
// block rows, so the two terms never overlap
template <typename T>
struct Compact {
  const T* diag;
  const T* blk;
  int sk, start, k;
  __device__ __forceinline__ T operator()(int row, const T* v) const {
    if (row >= start && row < start + k)
      return seq_dot<false>(blk + (row - start) * sk, 1, v + start, k);
    return diag[row] * v[row];
  }
};

// row `row` of an n*n matrix (odd row stride sn) @ v, v a padded vector
template <typename T>
struct Dense {
  const T* M;
  int sn, n;
  __device__ __forceinline__ T operator()(int row, const T* v) const {
    return seq_dot<true>(M + row * sn, 1, v, n);
  }
};

// The two forms of H and H^-1 (the regularized polish Hessian and its
// inverse) in device memory: what they take of shared memory (words of
// matrices after Sinv and A, and padded n-vectors at the head of the vector
// region), their asynchronous load into it, and their applies there.  The
// body takes its form by value: ptxas then gives the compact float32 kernel
// 64 registers and a 4-byte spill, and it runs 2.4% faster on an H100 than
// with a __grid_constant__ form taken by reference (62 registers, no
// spill; tools/torch_kernel_times.py, the two in turns).
template <typename T>
struct CompactH {            // diag (B, n), zero on the block rows; blk (B, k, k)
  const T *hd, *hblk, *hid, *hiblk;
  int k, start;
  using Apply = Compact<T>;
  static constexpr int VECTORS = 2;                      // the two diagonals
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 6 : 3;   // an SM
  __host__ __device__ int matrix_words(int) const { return 2 * k * row_stride(k); }
  __device__ void load(T* mats, T* vecs, int n8, int b, int n) const {
    const int sk = row_stride(k);
    const size_t bn = (size_t)b * n;
    async_load_matrix(mats, hblk + (size_t)b * k * k, k, k, sk);
    async_load_matrix(mats + k * sk, hiblk + (size_t)b * k * k, k, k, sk);
    async_load_vector(vecs, hd + bn, n);
    async_load_vector(vecs + n8, hid + bn, n);
  }
  __device__ Apply H(T* mats, T* vecs, int, int) const {
    return {vecs, mats, row_stride(k), start, k};
  }
  __device__ Apply Hinv(T* mats, T* vecs, int n8, int) const {
    return {vecs + n8, mats + k * row_stride(k), row_stride(k), start, k};
  }
};

template <typename T>
struct DenseH {              // H, H^-1 (B, n, n)
  const T *h, *hi;
  using Apply = Dense<T>;
  static constexpr int VECTORS = 0;
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 4 : 2;
  __host__ __device__ int matrix_words(int n) const { return 2 * n * row_stride(n); }
  __device__ void load(T* mats, T*, int, int b, int n) const {
    const int sn = row_stride(n);
    async_load_matrix(mats, h + (size_t)b * n * n, n, n, sn);
    async_load_matrix(mats + n * sn, hi + (size_t)b * n * n, n, n, sn);
  }
  __device__ Apply H(T* mats, T*, int, int n) const { return {mats, row_stride(n), n}; }
  __device__ Apply Hinv(T* mats, T*, int, int n) const {
    return {mats + n * row_stride(n), row_stride(n), n};
  }
};

// the matrices, then the vectors, each vector region padded to eight words
template <typename Form>
__host__ __device__ inline int matrix_words(const Form& f, int n, int m) {
  return pad8(m * row_stride(m) + m * row_stride(n) + f.matrix_words(n));
}

template <typename Form>
__host__ __device__ inline size_t polish_words(const Form& f, int n, int m) {
  return (size_t)matrix_words(f, n, m) + (Form::VECTORS + 5) * (size_t)pad8(n) +
         10 * (size_t)pad8(m) + CERT_MAXIMA * NW;
}

template <typename T, typename Form>
__device__ void polish_block(
    const Form form, const T* __restrict__ Sinv, const T* __restrict__ A,
    const T* __restrict__ da, const T* __restrict__ g, const T* __restrict__ bb,
    const T* __restrict__ l, const T* __restrict__ u,
    T* __restrict__ xo, T* __restrict__ yo, T* __restrict__ zo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int b, int n, int m, int refine, T reg, T* smem) {
  const int sn = row_stride(n), sm = row_stride(m);
  T* Ss = smem;               // m * sm   Sinv
  T* As = Ss + m * sm;        // m * sn   A
  T* Hm = As + m * sn;        // H and H^-1's matrices (Form)
  const int n8 = pad8(n), m8 = pad8(m);
  T* Hv = smem + matrix_words(form, n, m);   // Form::VECTORS * n8: H's vectors
  T* gs = Hv + Form::VECTORS * n8;   // n  g
  T* xs = gs + n8;            // n        x
  T* r1 = xs + n8;            // n        r1
  T* tn = r1 + n8;            // n        scratch over the variables
  T* btw = tn + n8;           // n        B^T y = A^T (da * y)
  T* das = btw + n8;          // m        da
  T* dab = das + m8;          // m        b, then da * b
  T* Ds = dab + m8;           // m        D = (1 - da) - reg * da
  T* ls = Ds + m8;            // m        l, clipped to +-1e20
  T* us = ls + m8;            // m        u, clipped to +-1e20
  T* ys = us + m8;            // m        y
  T* ws = ys + m8;            // m        da * y, then da * dy
  T* r2 = ws + m8;            // m        r2, then dy
  T* tm = r2 + m8;            // m        Sinv's right-hand side; A x in the tail
  T* wn = tm + m8;            // m        da * (y + dy)
  T* red = wn + m8;           // CERT_MAXIMA*NW  per-warp maxima of the certificate
  const auto H = form.H(Hm, Hv, n8, n), Hinv = form.Hinv(Hm, Hv, n8, n);
  const int nc = (n + 31) & ~31;   // items of the variables in the mixed stages
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const T big = T(1e20);      // bounds are clipped to +-1e20 (the plain version's clamp)
  // row r of A or Sinv, column c of A, times a vector
  // (the vectors are padded regions: 16-byte loads)
  auto a_row = [&](int r, const T* v) { return seq_dot<true>(As + r * sn, 1, v, n); };
  auto s_row = [&](int r, const T* v) { return seq_dot<true>(Ss + r * sm, 1, v, m); };
  auto a_col = [&](int c, const T* w) { return seq_dot<true>(As + c, sn, w, m); };

  // A, H and H^-1 and the vectors first, Sinv second
  async_load_matrix(As, A + (size_t)b * m * n, m, n, sn);
  form.load(Hm, Hv, n8, b, n);
  async_load_vector(gs, g + bn, n);
  async_load_vector(das, da + bm, m);
  async_load_vector(dab, bb + bm, m);
  async_load_vector(ls, l + bm, m);
  async_load_vector(us, u + bm, m);
  async_commit();
  async_load_matrix(Ss, Sinv + (size_t)b * m * m, m, m, sm);
  async_commit();
  async_wait<1>();
  QWBC_SYNC();

  // y = Sinv (-(da*b + B Hinv g)),  x = Hinv (-g - B^T y)
  QWBC_FOR(it, n + m + CERT_MAXIMA * NW) {
    if (it < n) {
      tn[it] = Hinv(it, gs);
    } else if (it < n + m) {
      const int r = it - n;
      const T a = das[r];
      dab[r] = a * dab[r];
      Ds[r] = (T(1) - a) - reg * a;
      ls[r] = clip(ls[r], -big, big);
      us[r] = clip(us[r], -big, big);
    } else {
      red[it - n - m] = T(0);
    }
  }
  QWBC_SYNC();
  QWBC_FOR(r, m) tm[r] = -(dab[r] + das[r] * a_row(r, tn));
  async_wait<0>();
  QWBC_SYNC();
  QWBC_FOR(r, m) {
    const T y = s_row(r, tm);
    ys[r] = y;
    ws[r] = das[r] * y;
  }
  QWBC_SYNC();
  QWBC_FOR(c, n) {
    const T s = a_col(c, ws);
    btw[c] = s;
    tn[c] = -gs[c] - s;
  }
  QWBC_SYNC();
  QWBC_FOR(c, n) xs[c] = Hinv(c, tn);
  QWBC_SYNC();

  for (int pass = 0; pass < refine; ++pass) {
    // r1 = -g - H x - B^T y (per variable; B^T y from the stage before),
    // r2 = da*b - B x - D y (per row)
    QWBC_FOR(it, nc + m) {
      if (it < n) {
        r1[it] = -gs[it] - H(it, xs) - btw[it];
      } else if (it >= nc) {
        const int r = it - nc;
        r2[r] = dab[r] - das[r] * a_row(r, xs) - Ds[r] * ys[r];
      }
    }
    QWBC_SYNC();
    // dy = Sinv (B Hinv r1 - r2)
    QWBC_FOR(c, n) tn[c] = Hinv(c, r1);
    QWBC_SYNC();
    QWBC_FOR(r, m) tm[r] = das[r] * a_row(r, tn) - r2[r];
    QWBC_SYNC();
    QWBC_FOR(r, m) {
      const T dy = s_row(r, tm);
      r2[r] = dy;
      ws[r] = das[r] * dy;
      wn[r] = das[r] * (ys[r] + dy);   // da * y of the next pass
    }
    QWBC_SYNC();
    // dx = Hinv (r1 - B^T dy), and beside it B^T y of the next pass
    QWBC_FOR(it, nc + n) {
      if (it < n) tn[it] = r1[it] - a_col(it, ws);
      else if (it >= nc) btw[it - nc] = a_col(it - nc, wn);
    }
    QWBC_SYNC();
    QWBC_FOR(it, nc + m) {
      if (it < n) {
        xs[it] = xs[it] + Hinv(it, tn);
      } else if (it >= nc) {
        const int r = it - nc;
        ys[r] = ys[r] + r2[r];
      }
    }
    QWBC_SYNC();
  }

  // z = clip(A x), the outputs, and the certificate (common.cuh): each
  // warp reduces its items' values (every lane takes part, with zeros past
  // the last item), then the first warp finishes it
  QWBC_FOR_UNIFORM(it, nc + m) {
    T v[CERT_MAXIMA] = {};
    if (it < n) {
      xo[bn + it] = xs[it];
      cert_var_terms(H(it, xs), a_col(it, ys), gs[it], v);   // A^T y, not active-masked
    } else if (it >= nc && it < nc + m) {
      const int r = it - nc;
      const T lo = ls[r], uo = us[r], ax = a_row(r, xs);
      tm[r] = ax;
      zo[bm + r] = clip(ax, lo, uo);
      yo[bm + r] = ys[r];
      cert_row_terms(lo, uo, ax, v);
    }
    cert_warp_maxima(v, red, NW);
  }
  QWBC_SYNC();
  cert_finish(red, NW, tm, ys, ls, us, m, pr, du, sv, b);
}

#ifdef __CUDACC__

template <typename T, typename Form>
__global__ void __launch_bounds__(POLISH_THREADS, Form::MIN_BLOCKS) polish_kernel(
    const Form form, const T* __restrict__ Sinv, const T* __restrict__ A,
    const T* __restrict__ da, const T* __restrict__ g, const T* __restrict__ bb,
    const T* __restrict__ l, const T* __restrict__ u,
    T* __restrict__ xo, T* __restrict__ yo, T* __restrict__ zo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int refine, T reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  polish_block<T>(form, Sinv, A, da, g, bb, l, u, xo, yo, zo, pr, du, sv, blockIdx.x,
                  n, m, refine, reg, reinterpret_cast<T*>(smem_raw));
}

template <typename T, typename Form>
int launch_polish(const Form& form, const void* Sinv, const void* A, const void* da,
                  const void* g, const void* bb, const void* l, const void* u,
                  void* xo, void* yo, void* zo, void* pr, void* du, void* sv, int B,
                  int n, int m, int refine, T reg, void* stream) {
  const size_t smem = sizeof(T) * polish_words(form, n, m);
  if (int err = allow_shared_memory<polish_kernel<T, Form>>(smem)) return err;
  polish_kernel<T, Form><<<B, POLISH_THREADS, smem, (cudaStream_t)stream>>>(
      form, (const T*)Sinv, (const T*)A, (const T*)da, (const T*)g, (const T*)bb,
      (const T*)l, (const T*)u, (T*)xo, (T*)yo, (T*)zo, (T*)pr, (T*)du, (T*)sv,
      n, m, refine, reg);
  return (int)cudaGetLastError();
}

#else  // plain C++: one thread runs the blocks one after the other

template <typename T, typename Form>
int launch_polish(const Form& form, const void* Sinv, const void* A, const void* da,
                  const void* g, const void* bb, const void* l, const void* u,
                  void* xo, void* yo, void* zo, void* pr, void* du, void* sv, int B,
                  int n, int m, int refine, T reg, void*) {
  T* smem = new T[polish_words(form, n, m)];
  for (int b = 0; b < B; ++b)
    polish_block<T>(form, (const T*)Sinv, (const T*)A, (const T*)da, (const T*)g,
                    (const T*)bb, (const T*)l, (const T*)u, (T*)xo, (T*)yo, (T*)zo,
                    (T*)pr, (T*)du, (T*)sv, b, n, m, refine, reg, smem);
  delete[] smem;
  return 0;
}

#endif

template <typename T>
int launch_polish_compact(const void* hd, const void* hblk, const void* hid,
                          const void* hiblk, const void* Sinv, const void* A,
                          const void* da, const void* g, const void* bb, const void* l,
                          const void* u, void* xo, void* yo, void* zo, void* pr,
                          void* du, void* sv, int B, int n, int m, int k, int start,
                          int refine, T reg, void* stream) {
  const CompactH<T> form{(const T*)hd, (const T*)hblk, (const T*)hid, (const T*)hiblk,
                         k, start};
  return launch_polish<T>(form, Sinv, A, da, g, bb, l, u, xo, yo, zo, pr, du, sv, B, n,
                          m, refine, reg, stream);
}

template <typename T>
int launch_polish_dense(const void* H, const void* Hinv, const void* Sinv,
                        const void* A, const void* da, const void* g, const void* bb,
                        const void* l, const void* u, void* xo, void* yo, void* zo,
                        void* pr, void* du, void* sv, int B, int n, int m, int refine,
                        T reg, void* stream) {
  const DenseH<T> form{(const T*)H, (const T*)Hinv};
  return launch_polish<T>(form, Sinv, A, da, g, bb, l, u, xo, yo, zo, pr, du, sv, B, n,
                          m, refine, reg, stream);
}

}  // namespace qwbc

extern "C" {

int qwbc_polish_f32(const void* hd, const void* hblk, const void* hid,
                    const void* hiblk, const void* Sinv, const void* A,
                    const void* da, const void* g, const void* bb, const void* l,
                    const void* u, void* xo, void* yo, void* zo, void* pr,
                    void* du, void* sv, int B, int n, int m, int k, int start,
                    int refine, float reg, void* stream) {
  return qwbc::launch_polish_compact<float>(hd, hblk, hid, hiblk, Sinv, A, da, g, bb, l,
                                            u, xo, yo, zo, pr, du, sv, B, n, m, k, start,
                                            refine, reg, stream);
}

int qwbc_polish_f64(const void* hd, const void* hblk, const void* hid,
                    const void* hiblk, const void* Sinv, const void* A,
                    const void* da, const void* g, const void* bb, const void* l,
                    const void* u, void* xo, void* yo, void* zo, void* pr,
                    void* du, void* sv, int B, int n, int m, int k, int start,
                    int refine, double reg, void* stream) {
  return qwbc::launch_polish_compact<double>(hd, hblk, hid, hiblk, Sinv, A, da, g, bb, l,
                                             u, xo, yo, zo, pr, du, sv, B, n, m, k, start,
                                             refine, reg, stream);
}

int qwbc_polish_dense_f32(const void* H, const void* Hinv, const void* Sinv,
                          const void* A, const void* da, const void* g,
                          const void* bb, const void* l, const void* u, void* xo,
                          void* yo, void* zo, void* pr, void* du, void* sv, int B,
                          int n, int m, int refine, float reg, void* stream) {
  return qwbc::launch_polish_dense<float>(H, Hinv, Sinv, A, da, g, bb, l, u, xo, yo, zo,
                                          pr, du, sv, B, n, m, refine, reg, stream);
}

int qwbc_polish_dense_f64(const void* H, const void* Hinv, const void* Sinv,
                          const void* A, const void* da, const void* g,
                          const void* bb, const void* l, const void* u, void* xo,
                          void* yo, void* zo, void* pr, void* du, void* sv, int B,
                          int n, int m, int refine, double reg, void* stream) {
  return qwbc::launch_polish_dense<double>(H, Hinv, Sinv, A, da, g, bb, l, u, xo, yo, zo,
                                           pr, du, sv, B, n, m, refine, reg, stream);
}

// shared memory of one block, in words (the wrapper's limit check)
size_t qwbc_polish_compact_words(int n, int m, int k) {
  return qwbc::polish_words(qwbc::CompactH<float>{nullptr, nullptr, nullptr, nullptr, k, 0},
                            n, m);
}

size_t qwbc_polish_dense_words(int n, int m) {
  return qwbc::polish_words(qwbc::DenseH<float>{nullptr, nullptr}, n, m);
}

}  // extern "C"
