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
// The epilogue scores the unscaled pair: relative KKT residuals and the
// sign violation, through A x = (As xs)/e, H x = (Hs xs)/d,
// A^T y = (As^T ys)/d, g = gs/d, y = e ys against the unscaled bounds.
//
// Bound on this card: operations (about 0.63 Mflop per scenario at the main
// path's 40 iterations against about 29 KB of inputs and outputs in
// float32).  Every dot product is one accumulator over j = 0, 1, ... in
// rising order, and the update's products are fused as the kernel this
// design replaced had them (its compiler's contraction, read from its SASS,
// written out with fmadd): its outputs bit for bit (the sigma path's
// torque and certificate gates sit close to the certificate's edge).  So
// the time is set by where the operands live and by the latency of the
// chains, not by the operations.
//
// Design: the constraint-space kernel's (admm_zy.cu), from admm_words.cuh.
// One thread an output, in three roles (zy_who): a row of A (A x~, the z
// and y update), a column of A (sigma x - g + A^T t, later A^T y) and a row
// of K^-1 (x~ = K^-1 ., the x update, later H x).  In float32 within
// ZY_NMAX variables and ZY_MMAX rows each thread holds its matrix words in
// registers for the whole launch, loaded once straight from device memory;
// the vectors of the products come by 16-byte broadcast loads from padded
// shared-memory regions.  Three barriers an iteration: x is updated on the
// K^-1-row threads right after x~ (in a register of each) and reaches the
// column threads through shared memory across the barriers that follow.  The
// scaled H and the epilogue's vectors arrive by cp.async during the loop;
// the certificate's maxima are reduced per warp (common.cuh).  Above the
// maxima, and in float64, the same stages read the matrices from shared
// memory (ZyWords<T, 0>), the same sums in the same order.  l and u (and
// the unscaled bounds) are clipped to +-1e20 here, not by the caller.
//
// Written with the stage macros of common.cuh, so the file also compiles as
// plain C++ (see common.cuh), where the tests check both instantiations.
#include "admm_words.cuh"
#ifndef __CUDACC__
#include <vector>
#endif

namespace qwbc {

// shared memory in words: 7 vectors over the rows and 4 over the variables
// (with the epilogue 12 and 6), each padded (zy_pad), first, so that in the
// register instantiation every vector sits at an offset known at compile
// time; then with the epilogue the scaled H, with the matrices in shared
// memory A and K^-1, in rows of odd stride; then with the epilogue the
// per-warp maxima
__host__ __device__ inline size_t admm_smem_words(int n, int m, bool in_registers,
                                                  bool epilogue) {
  const size_t sn = row_stride(n);
  const size_t mats = (epilogue ? (size_t)n * sn : 0) +
                      (in_registers ? 0 : (size_t)(m + n) * sn);
  const int un = in_registers ? ZY_NMAX : 0, um = in_registers ? ZY_MMAX : 0;
  return (epilogue ? 12 : 7) * (size_t)zy_pad(m, um) +
         (epilogue ? 6 : 4) * (size_t)zy_pad(n, un) + (size_t)pad8((int)mats) +
         (epilogue ? (size_t)CERT_MAXIMA * (zy_threads(n, m) / 32) : 0);
}

// what one thread carries across barriers: its matrix words (its row of A,
// column of A or row of K^-1) and, on a K^-1-row thread, its x; a row's
// iterate and data wait in shared memory, so that the registers go to the
// words
template <typename T, int W>
struct AdmmThread {
  ZyWords<T, W> a;
  T x;
};

template <typename T, int W, bool EPI>
__device__ __forceinline__ void admm_block(
    const T* __restrict__ Kinv, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ z0, const T* __restrict__ y0,
    const T* __restrict__ Hs, const T* __restrict__ lo, const T* __restrict__ uo,
    const T* __restrict__ d, const T* __restrict__ e,
    T* __restrict__ xo, T* __restrict__ zo, T* __restrict__ yo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int b, int n, int m, int iters, T sigma, T alpha, T oma, T* smem,
    AdmmThread<T, W>* st) {
  using S = AdmmThread<T, W>;
  constexpr bool REG = W > 0;
  constexpr int LN = REG ? ZY_NMAX : 0, LM = REG ? ZY_MMAX : 0;   // unrolled lengths
  // the vector regions' words (zy_pad): in the register instantiation, where
  // n <= ZY_NMAX and m <= ZY_MMAX, the constants pad8(ZY_NMAX), pad8(ZY_MMAX)
  const int sn = row_stride(n), n8 = REG ? pad8(LN) : pad8(n), m8 = REG ? pad8(LM) : pad8(m);
  const int nt = zy_threads(n, m), nw = nt / 32;
  T* tv = smem;               // m        t
  T* ys = tv + m8;            // m        y
  T* zs = ys + m8;            // m        z
  T* ls = zs + m8;            // m        l
  T* us = ls + m8;            // m        u
  T* rhs = us + m8;           // m        rho
  T* irhs = rhs + m8;         // m        1 / rho
  T* es = irhs + m8;          // m        e                 (epilogue only, as below)
  T* los = es + m8;           // m        unscaled lower bounds
  T* uos = los + m8;          // m        unscaled upper bounds
  T* axs = uos + m8;          // m        A x, unscaled
  T* yus = axs + m8;          // m        y, unscaled
  T* gs = tv + (EPI ? 12 : 7) * m8;   // n   g
  T* av = gs + n8;            // n        sigma x - g + A^T t
  T* kv = av + n8;            // n        x~
  T* xs = kv + n8;            // n        x (a K^-1-row thread's own is in its state)
  T* ds = xs + n8;            // n        d                 (epilogue only, as below)
  T* atys = ds + n8;          // n        A^T y
  T* Hss = gs + (EPI ? 6 : 4) * n8;   // n * sn   the scaled H   (epilogue only)
  T* As = Hss + (EPI ? n * sn : 0);   // m * sn   A      (matrices in shared memory only)
  T* Ks = As + m * sn;        // n * sn   K^-1   (matrices in shared memory only)
  // CERT_MAXIMA * nw words: the per-warp maxima (epilogue only)
  T* red = Hss + pad8((EPI ? n * sn : 0) + (REG ? 0 : (m + n) * sn));
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const T big = T(1e20);      // bounds are clipped to +-1e20 (the plain version's clamp)

  // group 1: the matrices the first stages read (shared-memory
  // instantiation); group 2: what only the epilogue reads, arriving during
  // the loop
  if constexpr (!REG) {
    async_load_matrix(As, A + bm * n, m, n, sn);
    async_load_matrix(Ks, Kinv + bn * n, n, n, sn);
  }
  async_commit();
  if constexpr (EPI) {
    async_load_matrix(Hss, Hs + bn * n, n, n, sn);
    async_load_vector(ds, d + bn, n);
    async_load_vector(es, e + bm, m);
    async_load_vector(los, lo + bm, m);
    async_load_vector(uos, uo + bm, m);
    async_commit();
    QWBC_FOR(i, CERT_MAXIMA * nw) red[i] = T(0);
  }
  // the padding of the regions the products read: zero (see ZyWords)
  QWBC_FOR(i, m8 - m) tv[m + i] = ys[m + i] = T(0);
  QWBC_FOR(i, n8 - n) av[n + i] = kv[n + i] = xs[n + i] = T(0);
  async_wait<EPI ? 1 : 0>();

  // each thread's matrix words, a row's iterate and the first t, a
  // variable's x and g
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    const int i = w.idx;
    if (w.role == ZY_ROW) {
      if constexpr (REG) s.a.template load_row<LN>(A + (bm + i) * n, n);
      else s.a.p = As + i * sn;
      const T z = z0[bm + i], y = y0[bm + i], rh = rho[bm + i];
      zs[i] = z; ys[i] = y;
      ls[i] = clip(l[bm + i], -big, big);
      us[i] = clip(u[bm + i], -big, big);
      rhs[i] = rh;
      irhs[i] = T(1) / rh;
      tv[i] = fmadd(z, rh, -y);                                         // t = rho z - y
    } else if (w.role == ZY_COL) {
      if constexpr (REG) {
        s.a.template load_col<LM>(A + bm * n + i, n, m);
      } else {
        s.a.p = As + i;
        s.a.stride = sn;
      }
    } else if (w.role == ZY_KROW) {
      if constexpr (REG) s.a.template load_row<LN>(Kinv + (bn + i) * n, n);
      else s.a.p = Ks + i * sn;
      gs[i] = g[bn + i];
      s.x = x0[bn + i];
      xs[i] = s.x;
    }
  });

  // each product of a sum fused as the kernel this design replaced had it
  // (its compiler's contraction), so that the rounding is the same
  for (int it = 0; it < iters; ++it) {
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      if (w.role == ZY_COL) {
        const int j = w.idx;
        av[j] = fmadd(xs[j], sigma, -gs[j]) + s.a.template dot<LM>(tv, m);
      }
    });
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      if (w.role == ZY_KROW) {
        const int k = w.idx;
        const T x_t = s.a.template dot<LN>(av, n);                     // x~
        kv[k] = x_t;
        s.x = fmadd(s.x, oma, alpha * x_t);                             // x
        xs[k] = s.x;
      }
    });
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      const int i = w.idx;
      if (w.role == ZY_ROW) {
        const T rh = rhs[i], z = zs[i], y = ys[i];
        const T z_t = s.a.template dot<LN>(kv, n);
        const T z_rel = fmadd(z, oma, alpha * z_t);
        const T z_n = clip(fmadd(y, irhs[i], z_rel), ls[i], us[i]);
        const T y_n = fmadd(z_rel - z_n, rh, y);
        zs[i] = z_n;
        ys[i] = y_n;
        tv[i] = fmadd(z_n, rh, -y_n);                                   // the next t
      }
    });
  }

  if constexpr (!EPI) {
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      if (w.role == ZY_ROW) {
        zo[bm + w.idx] = zs[w.idx];
        yo[bm + w.idx] = ys[w.idx];
      } else if (w.role == ZY_KROW) {
        xo[bn + w.idx] = s.x;
      }
    });
  } else {
    // ---- epilogue: the unscaled certificate of (x, y) ----
    async_wait<0>();          // group 2, for the stages after the next barrier
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      if (w.role == ZY_COL) atys[w.idx] = s.a.template dot<LM>(ys, m);   // A^T y
    });
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      T v[CERT_MAXIMA] = {};
      const int i = w.idx;
      if (w.role == ZY_ROW) {
        const T ei = es[i], lo_i = clip(los[i], -big, big), uo_i = clip(uos[i], -big, big);
        const T ax = s.a.template dot<LN>(xs, n) / ei;
        axs[i] = ax;
        yus[i] = ei * ys[i];
        zo[bm + i] = zs[i];
        yo[bm + i] = ys[i];
        los[i] = lo_i;
        uos[i] = uo_i;
        cert_row_terms(lo_i, uo_i, ax, v);
      } else if (w.role == ZY_KROW) {
        xo[bn + i] = s.x;
        s.a.template load_smem_row<LN>(Hss + i * sn, n);              // K^-1 is done with
        const T dj = ds[i];
        cert_var_terms(s.a.template dot<LN>(xs, n) / dj, atys[i] / dj, gs[i] / dj, v);
      }
      cert_warp_maxima(v, red, nw);
    });
    cert_finish(red, nw, axs, yus, los, uos, m, pr, du, sv, b);
  }
}

#ifdef __CUDACC__

template <typename T, int W, bool EPI>
__global__ void __launch_bounds__(W > 0 ? ZY_THREADS : 1024, W > 0 ? 4 : 1)
    admm_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ z0, const T* __restrict__ y0,
    const T* __restrict__ Hs, const T* __restrict__ lo, const T* __restrict__ uo,
    const T* __restrict__ d, const T* __restrict__ e,
    T* __restrict__ xo, T* __restrict__ zo, T* __restrict__ yo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int iters, T sigma, T alpha, T oma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AdmmThread<T, W> st[1];
  admm_block<T, W, EPI>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d, e, xo, zo,
                        yo, pr, du, sv, blockIdx.x, n, m, iters, sigma, alpha, oma,
                        reinterpret_cast<T*>(smem_raw), st);
}

template <typename T, int W, bool EPI>
int launch_admm_variant(const void* Kinv, const void* A, const void* g, const void* l,
                        const void* u, const void* rho, const void* x0, const void* z0,
                        const void* y0, const void* Hs, const void* lo, const void* uo,
                        const void* d, const void* e, void* xo, void* zo, void* yo,
                        void* pr, void* du, void* sv, int B, int n, int m, int iters,
                        T sigma, T alpha, T oma, void* stream) {
  const size_t smem = sizeof(T) * admm_smem_words(n, m, W > 0, EPI);
  if (int err = allow_shared_memory<admm_kernel<T, W, EPI>>(smem)) return err;
  admm_kernel<T, W, EPI><<<B, zy_threads(n, m), smem, (cudaStream_t)stream>>>(
      (const T*)Kinv, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
      (const T*)rho, (const T*)x0, (const T*)z0, (const T*)y0, (const T*)Hs,
      (const T*)lo, (const T*)uo, (const T*)d, (const T*)e,
      (T*)xo, (T*)zo, (T*)yo, (T*)pr, (T*)du, (T*)sv,
      n, m, iters, sigma, alpha, oma);
  return (int)cudaGetLastError();
}

#else  // plain C++: one thread runs the blocks one after the other

template <typename T, int W, bool EPI>
int launch_admm_variant(const void* Kinv, const void* A, const void* g, const void* l,
                        const void* u, const void* rho, const void* x0, const void* z0,
                        const void* y0, const void* Hs, const void* lo, const void* uo,
                        const void* d, const void* e, void* xo, void* zo, void* yo,
                        void* pr, void* du, void* sv, int B, int n, int m, int iters,
                        T sigma, T alpha, T oma, void*) {
  std::vector<T> smem(admm_smem_words(n, m, W > 0, EPI));
  std::vector<AdmmThread<T, W>> st(zy_threads(n, m));
  for (int b = 0; b < B; ++b)
    admm_block<T, W, EPI>(
        (const T*)Kinv, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
        (const T*)rho, (const T*)x0, (const T*)z0, (const T*)y0, (const T*)Hs,
        (const T*)lo, (const T*)uo, (const T*)d, (const T*)e,
        (T*)xo, (T*)zo, (T*)yo, (T*)pr, (T*)du, (T*)sv,
        b, n, m, iters, sigma, alpha, oma, smem.data(), st.data());
  return 0;
}

#endif

// the instantiation by shape and type (zy_in_registers): registers, else the
// matrices in shared memory; with the epilogue (K5) or without it (K6)
template <typename T, bool EPI>
int launch_admm_t(const void* Kinv, const void* A, const void* g, const void* l,
                  const void* u, const void* rho, const void* x0, const void* z0,
                  const void* y0, const void* Hs, const void* lo, const void* uo,
                  const void* d, const void* e, void* xo, void* zo, void* yo,
                  void* pr, void* du, void* sv, int B, int n, int m, int iters,
                  T sigma, T alpha, T oma, void* stream) {
  if constexpr (sizeof(T) == 4) {
    if (zy_in_registers(n, m, 4))
      return launch_admm_variant<T, ZY_MMAX, EPI>(
          Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d, e, xo, zo, yo, pr, du, sv,
          B, n, m, iters, sigma, alpha, oma, stream);
  }
  return launch_admm_variant<T, 0, EPI>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo,
                                        d, e, xo, zo, yo, pr, du, sv, B, n, m, iters,
                                        sigma, alpha, oma, stream);
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

// the wrapper's check, for a shape, an element size in bytes and the
// epilogue flag: the block's shared memory in words (the threads and the
// instantiation are the constraint-space kernel's: qwbc_admm_zy_threads,
// qwbc_admm_zy_in_registers)
size_t qwbc_admm_words(int n, int m, int elem_bytes, int epilogue) {
  return qwbc::admm_smem_words(n, m, qwbc::zy_in_registers(n, m, elem_bytes), epilogue);
}

}  // extern "C"
