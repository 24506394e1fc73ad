// Ruiz equilibration + problem / warm-start scaling of ONE scenario whose H
// and A already lie in shared memory: the body of the prepare kernel
// (prepare.cu), shared with the fused setup kernel (setup.cu), which runs it
// on the A and H it has just assembled.
//
// Every pointer is this scenario's own slice.  H: an accessor of H in
// shared memory (DenseH, or BlockDiagH where H is a diagonal and one dense
// block); As: A in shared memory, row stride sn; both complete before the
// call (the caller's barrier).  g, l, u: the unscaled vectors, in shared or
// device memory.  d0..e1: shared scratch of n, m, n, m words.  wx, wz, wy:
// the carried warm start in device memory; with `drop_duals` the duals z, y
// are taken as zero (their rows were re-masked by a contact switch) and only
// the primal is kept.
//
// Equality rows are detected on the UNSCALED bounds (u - l <= 1e-9): the
// scaled difference e*u - e*l may be contracted into an FMA whose exact
// partial product makes an exactly-equal row look unequal.
//
// A sweep's n column and m row maxima are spread over the block two lanes
// a task (a column or row of the matrix, its entries alternating between
// the two lanes, the two maxima joined by one shuffle), every warp full,
// and each lane keeps two chains.  A max is exact in any order and every
// product is the one of the serial chain, so the scaling is the chain's bit
// for bit.  Of a column of A only |A_ij| e_i is maximised and then scaled
// by d_j once: rounding is monotone, so max_i fl(a_i d_j) = fl(d_j max_i
// a_i) (NaN for NaN, a zero's sign lost to the clamp at 1e-8).  The first
// sweep reads no scaling (all ones: |H| * 1 * 1 is |H|), so the tail needs
// no barrier of its own before it.
//
// A column of a block-diagonal H multiplies only its stored entries: the
// structural zeros of the dense chain give +0 (no effect on a max that
// starts at +0), or NaN where d_j or a d_i of a structural zero is not
// finite, and exactly then the column's max is NaN here too.
#pragma once
#include "common.cuh"

namespace qwbc {

// H in shared memory, dense, row stride sn (the prepare kernel)
template <typename T>
struct DenseH {
  const T* p;
  int sn;
  __device__ T at(int i, int j) const { return p[i * sn + j]; }
};

// H with a diagonal and one dense block on rows and columns [B0, B0 + NB),
// +0 everywhere else (the WBC QP: the fused setup kernel)
template <typename T, int B0, int NB>
struct BlockDiagH {
  static constexpr int LDB = NB | 1;   // the block's odd row stride
  T* diag;                             // n words; the block's own are unused
  T* blk;                              // NB rows of LDB
  __device__ static bool in_block(int i) { return i >= B0 && i < B0 + NB; }
  __device__ T at(int i, int j) const {
    if (in_block(i) && in_block(j)) return blk[(i - B0) * LDB + (j - B0)];
    return i == j ? diag[i] : T(0);
  }
};

template <typename T>
__device__ __forceinline__ bool finite_val(T v) {
#ifdef __CUDACC__
  return isfinite(v);
#else
  return std::isfinite(v);
#endif
}

// NaN-propagating max of f(e) over e = half, half + lanes, ... < len, in
// two chains with a trip count that does not depend on half
template <typename T, typename F>
__device__ __forceinline__ T strided_max(int len, int half, int lanes, F f) {
  T m0 = T(0), m1 = T(0);
  const int full = len / lanes;   // entries every lane has
  int k = 0;
  for (; k + 1 < full; k += 2) {
    m0 = nan_max(m0, f(k * lanes + half));
    m1 = nan_max(m1, f((k + 1) * lanes + half));
  }
  if (k < full) m0 = nan_max(m0, f(k * lanes + half));
  if (half < len - full * lanes) m1 = nan_max(m1, f(full * lanes + half));
  return nan_max(m0, m1);
}

// what a sweep knows of ds before it starts: whether any d_i is not finite,
// and (block-diagonal H) whether any outside the block is not
struct SweepFlags {
  bool nf_all = false, nf_out = false;
};

template <typename T>
__device__ __forceinline__ SweepFlags sweep_flags(const DenseH<T>&, const T*, int) {
  return {};
}

template <typename T, int B0, int NB>
__device__ __forceinline__ SweepFlags sweep_flags(const BlockDiagH<T, B0, NB>&, const T* ds,
                                                  int n) {
  SweepFlags f;
#ifdef __CUDACC__
  // each warp reads ds itself: every thread needs the flags
  for (int i = (int)(threadIdx.x & 31u); i < n; i += 32) {
#else
  for (int i = 0; i < n; ++i) {
#endif
    const bool nf = !finite_val(ds[i]);
    f.nf_all = f.nf_all || nf;
    f.nf_out = f.nf_out || (nf && !BlockDiagH<T, B0, NB>::in_block(i));
  }
#ifdef __CUDACC__
  f.nf_all = __any_sync(0xffffffffu, f.nf_all);
  f.nf_out = __any_sync(0xffffffffu, f.nf_out);
#endif
  return f;
}

// max over column t of |H| d d, dj = d_t
template <typename T, bool FIRST>
__device__ __forceinline__ T h_column_max(const DenseH<T>& H, const T* ds, int n, int t,
                                          T dj, int half, int lanes, const SweepFlags&) {
  return strided_max<T>(n, half, lanes, [&](int i) {
    return absv(H.at(i, t)) * dj * (FIRST ? T(1) : ds[i]);
  });
}

template <typename T, bool FIRST, int B0, int NB>
__device__ __forceinline__ T h_column_max(const BlockDiagH<T, B0, NB>& H, const T* ds, int,
                                          int t, T dj, int half, int lanes,
                                          const SweepFlags& f) {
  const T nan = nan_value<T>();
  if (!BlockDiagH<T, B0, NB>::in_block(t)) {   // the diagonal alone
    if (f.nf_all) return nan;
    return half == 0 ? absv(H.diag[t]) * dj * (FIRST ? T(1) : ds[t]) : T(0);
  }
  if (!FIRST && (f.nf_out || !finite_val(dj))) return nan;
  return strided_max<T>(NB, half, lanes, [&](int k) {
    return absv(H.blk[k * H.LDB + t - B0]) * dj * (FIRST ? T(1) : ds[B0 + k]);
  });
}

// the max of one task of a sweep: column t (t < n) of |H| d d and |A| e d,
// or row t - n of |A| e d; `half` and `lanes` split its entries
template <typename T, bool FIRST, typename HM>
__device__ __forceinline__ T sweep_task_max(const HM& H, const T* As, int sn, const T* ds,
                                            const T* es, int n, int m, int t, int half,
                                            int lanes, const SweepFlags& f) {
  if (t < n) {
    const T dj = FIRST ? T(1) : ds[t];
    const T mh = h_column_max<T, FIRST>(H, ds, n, t, dj, half, lanes, f);
    const T ma = strided_max<T>(m, half, lanes, [&](int i) {
      return absv(As[i * sn + t]) * (FIRST ? T(1) : es[i]);
    });
    return nan_max(mh, ma * dj);
  }
  if (t < n + m) {
    const int i = t - n;
    const T ei = FIRST ? T(1) : es[i];
    return strided_max<T>(n, half, lanes, [&](int j) {
      return absv(As[i * sn + j]) * ei * (FIRST ? T(1) : ds[j]);
    });
  }
  return T(0);
}

template <typename T, bool FIRST, typename HM>
__device__ __forceinline__ void ruiz_sweep(const HM& H, const T* As, int sn, const T* ds,
                                           const T* es, T* dn, T* en, int n, int m) {
  const SweepFlags f = FIRST ? SweepFlags{} : sweep_flags(H, ds, n);
  auto finish = [&](int t, T mx) {
    const T s = T(1) / sqrt(nan_max(mx, T(1e-8)));
    if (t < n) dn[t] = (FIRST ? T(1) : ds[t]) * s;
    else en[t - n] = (FIRST ? T(1) : es[t - n]) * s;
  };
#ifdef __CUDACC__
  // lanes 2s and 2s+1 share task s of a round; every thread runs every
  // round, so the shuffle always finds both lanes
  const int half = (int)(threadIdx.x & 1u), slots = (int)(blockDim.x >> 1);
  for (int t0 = 0; t0 < n + m; t0 += slots) {
    const int t = t0 + (int)(threadIdx.x >> 1);
    T mx = sweep_task_max<T, FIRST>(H, As, sn, ds, es, n, m, t, half, 2, f);
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    if (half == 0 && t < n + m) finish(t, mx);
  }
#else
  QWBC_FOR(t, n + m)
      finish(t, sweep_task_max<T, FIRST>(H, As, sn, ds, es, n, m, t, 0, 1, f));
#endif
}

template <typename T, typename HM>
__device__ void prepare_tail(
    const HM& H, const T* As, int sn, T* d0, T* e0, T* d1, T* e1,
    const T* g, const T* l, const T* u,
    const T* __restrict__ wx, const T* __restrict__ wz,
    const T* __restrict__ wy, bool drop_duals,
    T* __restrict__ sH, T* __restrict__ sA, T* __restrict__ sg,
    T* __restrict__ sl, T* __restrict__ su, T* __restrict__ rho,
    T* __restrict__ wxs, T* __restrict__ wzs, T* __restrict__ wys,
    T* __restrict__ dout, T* __restrict__ eout,
    int n, int m, int sweeps, T rho0, T rho_eq) {
  // each sweep reads (ds, es) and writes the other pair
  T *ds = d0, *es = e0, *dn = d1, *en = e1;
  if (sweeps == 0) {
    QWBC_FOR(j, n) d0[j] = T(1);
    QWBC_FOR(i, m) e0[i] = T(1);
  }
  for (int s = 0; s < sweeps; ++s) {
    if (s == 0)
      ruiz_sweep<T, true>(H, As, sn, ds, es, dn, en, n, m);
    else
      ruiz_sweep<T, false>(H, As, sn, ds, es, dn, en, n, m);
    QWBC_SYNC();
    T* t = ds; ds = dn; dn = t;
    t = es; es = en; en = t;
  }
  if (sweeps == 0) QWBC_SYNC();

  QWBC_FOR(idx, n * n) {
    const int i = idx / n, j = idx - i * n;
    sH[idx] = H.at(i, j) * ds[j] * ds[i];
  }
  QWBC_FOR(idx, m * n) {
    const int i = idx / n, j = idx - i * n;
    sA[idx] = As[i * sn + j] * es[i] * ds[j];
  }
  QWBC_FOR(j, n) {
    const T d = ds[j];
    sg[j] = d * g[j];
    wxs[j] = wx[j] / d;
    dout[j] = d;
  }
  QWBC_FOR(i, m) {
    const T e = es[i], lv = l[i], uv = u[i];
    sl[i] = e * lv;
    su[i] = e * uv;
    rho[i] = ((uv - lv) <= T(1e-9)) ? rho_eq : rho0;
    wzs[i] = (drop_duals ? T(0) : wz[i]) * e;
    wys[i] = (drop_duals ? T(0) : wy[i]) / e;
    eout[i] = e;
  }
}

}  // namespace qwbc
