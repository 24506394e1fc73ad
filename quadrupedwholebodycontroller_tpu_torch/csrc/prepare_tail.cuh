// Ruiz equilibration + problem / warm-start scaling of ONE scenario whose H
// and A already lie in shared memory: the body of the prepare kernel
// (prepare.cu), shared with the fused setup kernel (setup.cu), which runs it
// on the A and H it has just assembled.
//
// Every pointer is this scenario's own slice.  Hs, As: shared memory, row
// stride sn, complete before the call (the caller's barrier).  g, l, u: the
// unscaled vectors, in shared or device memory.  d0..e1: shared scratch of
// n, m, n, m words.  wx, wz, wy: the carried warm start in device memory; with
// `drop_duals` the duals z, y are taken as zero (their rows were re-masked by
// a contact switch) and only the primal is kept.
//
// Equality rows are detected on the UNSCALED bounds (u - l <= 1e-9): the
// scaled difference e*u - e*l may be contracted into an FMA whose exact
// partial product makes an exactly-equal row look unequal.
#pragma once
#include "common.cuh"

namespace qwbc {

template <typename T>
__device__ void prepare_tail(
    const T* Hs, const T* As, int sn, T* d0, T* e0, T* d1, T* e1,
    const T* g, const T* l, const T* u,
    const T* __restrict__ wx, const T* __restrict__ wz,
    const T* __restrict__ wy, bool drop_duals,
    T* __restrict__ sH, T* __restrict__ sA, T* __restrict__ sg,
    T* __restrict__ sl, T* __restrict__ su, T* __restrict__ rho,
    T* __restrict__ wxs, T* __restrict__ wzs, T* __restrict__ wys,
    T* __restrict__ dout, T* __restrict__ eout,
    int n, int m, int sweeps, T rho0, T rho_eq) {
  QWBC_FOR(j, n) d0[j] = T(1);
  QWBC_FOR(i, m) e0[i] = T(1);
  QWBC_SYNC();

  // each sweep reads (ds, es) and writes the other pair
  T *ds = d0, *es = e0, *dn = d1, *en = e1;
  for (int s = 0; s < sweeps; ++s) {
    QWBC_FOR(j, n) {         // column j of |H| d d and |A| e d
      const T dj = ds[j];
      T cx = T(0);
      for (int i = 0; i < n; ++i)
        cx = nan_max(cx, absv(Hs[i * sn + j]) * dj * ds[i]);
      for (int i = 0; i < m; ++i)
        cx = nan_max(cx, absv(As[i * sn + j]) * es[i] * dj);
      dn[j] = dj * (T(1) / sqrt(nan_max(cx, T(1e-8))));
    }
    QWBC_FOR(i, m) {         // row i of |A| e d
      const T ei = es[i];
      T rz = T(0);
      for (int j = 0; j < n; ++j)
        rz = nan_max(rz, absv(As[i * sn + j]) * ei * ds[j]);
      en[i] = ei * (T(1) / sqrt(nan_max(rz, T(1e-8))));
    }
    QWBC_SYNC();
    T* t = ds; ds = dn; dn = t;
    t = es; es = en; en = t;
  }

  QWBC_FOR(idx, n * n) {
    const int i = idx / n, j = idx - i * n;
    sH[idx] = Hs[i * sn + j] * ds[j] * ds[i];
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
