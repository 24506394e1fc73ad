// Constraint-space (sigma = 0) ADMM loop + x recovery + residual epilogue,
// one launch, one block per scenario.
//
// Replaces the TPU kernel pair of ops/pallas/qp_kernel.py in the JAX package:
// admm_zy_iterations_res (_admm_zy_kernel + _zy_epilogue_kernel).  Those keep
// 128 scenarios on the lane axis of batch-minor tiles and run as two calls;
// here the batch-major contiguous inputs are taken as they are, one thread
// block owns one scenario, and the loop and the epilogue share the block.
//
// Bound on this card: operations (about 0.65 Mflop per scenario at the main
// path's 40 iterations against about 28 KB of inputs in float32).  Each
// iteration is three chained matvecs, A^T t, K^-1 . and A ., and every dot
// product is one accumulator over j = 0, 1, ... in rising order, with the
// update's products fused as the kernel this design replaced had them: its
// outputs bit for bit (the control step's path-against-path torque checks
// sit close enough to the certificate's edge to notice a re-rounded
// iterate).  So the time is set by where the operands live and by the
// latency of the chains, not by the operations.
//
// Design: one thread an output, in three roles (zy_who): a row of A
// (threads 0..m-1: A x, the z, y, V update), a column of A (the warps after
// them: A^T t, A^T V, A^T y) and a row of K^-1 (the threads left over:
// K^-1 v, the x recovery, then H x).  In float32 each thread holds its
// matrix words in registers for the whole launch (loaded once, straight
// from device memory: a column by loads coalesced across the warp, a row by
// 8-byte loads), so a multiply-add reads only its vector word, which comes
// by 16-byte broadcast loads from a padded shared-memory region, issued
// ahead of the chain (volatile: ptxas otherwise moves each load next to its
// use).  Values that cross barriers live in the thread's state struct
// (QWBC_STAGE), a row's iterate in shared memory.  The scaled H and the
// epilogue's vectors arrive by cp.async during the loop; the certificate's
// maxima are reduced per warp in one pass (common.cuh).  Registers cap the
// size: n <= ZY_NMAX and m <= ZY_MMAX (the WBC's 42 and 70 with room).
// Above that, and in float64, the same stages run with the matrices in
// shared memory (ZyWords<T, 0>), the same sums in the same order.  The
// roles, the words and their loads are in admm_words.cuh, which the x-space
// ADMM kernel (admm.cu) shares.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/torch_kernel_times.py,
// the smoke's step-60 inputs, against the kernel this design replaced in the
// same call): float32 B = 4096, 40 iterations 0.306 ms (was 0.633), B = 128
// 35.0 us (was 105); float64 B = 4096 1.074 ms (was 1.073), where the
// register design took 1.23 (its words leave no registers to load ahead).
// What holds float32 back is latency: at B = 128 an iteration of one block
// takes ~0.57 us, the 160 dependent multiply-adds of its three chains
// (~0.35 us) plus three barriers and the shared-memory round trips between
// them; at B = 4096 four blocks an SM (96 registers a thread, no spill)
// stretch it to ~0.74 us.  The load (~28 KB a scenario from device memory)
// takes ~0.05 ms of the 0.31, the epilogue ~0.03.
//
// Written with the stage macros of common.cuh, so the file also compiles as
// plain C++ (see common.cuh), where the tests check both instantiations.
#include "admm_words.cuh"
#ifndef __CUDACC__
#include <vector>
#endif

namespace qwbc {

// shared memory in words: the scaled H (and, with the matrices in shared
// memory, A and K^-1) in rows of odd stride, 14 vectors over the rows and 7
// over the variables, each padded (zy_pad), and the per-warp maxima
__host__ __device__ inline size_t zy_smem_words(int n, int m, bool in_registers) {
  const size_t sn = row_stride(n);
  const size_t mats = (size_t)n * sn + (in_registers ? 0 : (size_t)(m + n) * sn);
  const int un = in_registers ? ZY_NMAX : 0, um = in_registers ? ZY_MMAX : 0;
  return (size_t)pad8((int)mats) + 14 * (size_t)zy_pad(m, um) + 7 * (size_t)zy_pad(n, un) +
         (size_t)CERT_MAXIMA * (zy_threads(n, m) / 32);
}

// what one thread carries across barriers: its matrix words (its row of A,
// column of A or row of K^-1); a row's iterate and data wait in shared
// memory, so that the registers go to the words
template <typename T, int W>
struct ZyThread {
  ZyWords<T, W> a;
};

template <typename T, int W>
__device__ __forceinline__ void admm_zy_block(
    const T* __restrict__ Kinv, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ z0, const T* __restrict__ y0,
    const T* __restrict__ Hs, const T* __restrict__ lo, const T* __restrict__ uo,
    const T* __restrict__ d, const T* __restrict__ e,
    T* __restrict__ xo, T* __restrict__ zo, T* __restrict__ yo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int b, int n, int m, int iters, T alpha, T oma, T w0, T omw0, T* smem,
    ZyThread<T, W>* st) {
  using S = ZyThread<T, W>;
  constexpr bool REG = W > 0;
  constexpr int LN = REG ? ZY_NMAX : 0, LM = REG ? ZY_MMAX : 0;   // unrolled lengths
  const int sn = row_stride(n), n8 = zy_pad(n, LN), m8 = zy_pad(m, LM);
  const int nt = zy_threads(n, m), nw = nt / 32;
  T* Hss = smem;              // n * sn   the scaled H
  T* As = Hss + n * sn;       // m * sn   A      (matrices in shared memory only)
  T* Ks = As + m * sn;        // n * sn   K^-1   (matrices in shared memory only)
  T* tv = smem + pad8(n * sn + (REG ? 0 : (m + n) * sn));
  T* Vs = tv + m8;            // m        V
  T* ys = Vs + m8;            // m        y
  T* zs = ys + m8;            // m        z
  T* cs = zs + m8;            // m        c = -A K^-1 g
  T* ls = cs + m8;            // m        l
  T* us = ls + m8;            // m        u
  T* rhs = us + m8;           // m        rho
  T* irhs = rhs + m8;         // m        1 / rho
  T* es = irhs + m8;          // m        e
  T* los = es + m8;           // m        unscaled lower bounds
  T* uos = los + m8;          // m        unscaled upper bounds
  T* axs = uos + m8;          // m        A x, unscaled
  T* yus = axs + m8;          // m        y, unscaled
  T* gs = yus + m8;           // n        g
  T* kgs = gs + n8;           // n        K^-1 g
  T* av = kgs + n8;           // n        A^T t, later A^T V
  T* kv = av + n8;            // n        K^-1 A^T t, later x
  T* atys = kv + n8;          // n        A^T y
  T* x0s = atys + n8;         // n        x0
  T* ds = x0s + n8;           // n        d
  T* red = ds + n8;           // CERT_MAXIMA * nw   per-warp maxima
  // tv: t of the iteration
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const T big = T(1e20);      // bounds are clipped to +-1e20 (the plain version's clamp)

  // group 1: what the first stages read; group 2: what only the epilogue
  // reads, arriving during the loop
  if constexpr (!REG) {
    async_load_matrix(As, A + bm * n, m, n, sn);
    async_load_matrix(Ks, Kinv + bn * n, n, n, sn);
  }
  async_load_vector(gs, g + bn, n);
  async_commit();
  async_load_matrix(Hss, Hs + bn * n, n, n, sn);
  async_load_vector(x0s, x0 + bn, n);
  async_load_vector(ds, d + bn, n);
  async_load_vector(es, e + bm, m);
  async_load_vector(los, lo + bm, m);
  async_load_vector(uos, uo + bm, m);
  async_commit();
  QWBC_FOR(i, CERT_MAXIMA * nw) red[i] = T(0);
  // the padding of the regions the products read: zero (see ZyWords)
  QWBC_FOR(i, m8 - m) tv[m + i] = Vs[m + i] = ys[m + i] = T(0);
  QWBC_FOR(i, n8 - n) gs[n + i] = kgs[n + i] = av[n + i] = kv[n + i] = T(0);
  async_wait<1>();

  // each thread's matrix words and a row's iterate
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    const int i = w.idx;
    if (w.role == ZY_ROW) {
      if constexpr (REG) s.a.template load_row<LN>(A + (bm + i) * n, n);
      else s.a.p = As + i * sn;
      zs[i] = z0[bm + i]; ys[i] = y0[bm + i]; Vs[i] = T(0);
      ls[i] = clip(l[bm + i], -big, big);
      us[i] = clip(u[bm + i], -big, big);
      const T rh = rho[bm + i];
      rhs[i] = rh;
      irhs[i] = T(1) / rh;
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
    }
  });
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    if (w.role == ZY_KROW) kgs[w.idx] = s.a.template dot<LN>(gs, n);      // K^-1 g
  });
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    if (w.role == ZY_ROW) {
      cs[w.idx] = -s.a.template dot<LN>(kgs, n);                        // c = -A K^-1 g
      tv[w.idx] = fmadd(zs[w.idx], rhs[w.idx], -ys[w.idx]);             // t = rho z - y
    }
  });

  for (int it = 0; it < iters; ++it) {
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      if (w.role == ZY_COL) av[w.idx] = s.a.template dot<LM>(tv, m);     // A^T t
    });
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      if (w.role == ZY_KROW) kv[w.idx] = s.a.template dot<LN>(av, n);    // K^-1 A^T t
    });
    QWBC_STAGE(st, nt, [&](S& s, int tid) {
      const ZyWho w = zy_who(tid, n, m);
      // each product of a sum fused as the kernel this design replaced had
      // it (its compiler's contraction), so that the rounding is the same
      if (w.role == ZY_ROW) {
        const int i = w.idx;
        const T rh = rhs[i], t = tv[i], z = zs[i], y = ys[i];
        const T z_t = s.a.template dot<LN>(kv, n) + cs[i];
        const T z_rel = fmadd(z, oma, alpha * z_t);
        const T z_n = clip(fmadd(y, irhs[i], z_rel), ls[i], us[i]);
        const T y_n = fmadd(z_rel - z_n, rh, y);
        Vs[i] = fmadd(Vs[i], oma, alpha * t);
        zs[i] = z_n;
        ys[i] = y_n;
        tv[i] = fmadd(z_n, rh, -y_n);                                   // the next t
      }
    });
  }

  // ---- epilogue: x from the accumulator, then the unscaled certificate ----
  async_wait<0>();            // group 2, for the stages after the next barrier
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    if (w.role == ZY_COL) {
      av[w.idx] = s.a.template dot<LM>(Vs, m);
      atys[w.idx] = s.a.template dot<LM>(ys, m);
    }
  });
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    if (w.role == ZY_KROW) {
      const int k = w.idx;
      const T x = fmadd(-kgs[k], omw0, fmadd(x0s[k], w0, s.a.template dot<LN>(av, n)));
      xo[bn + k] = x;
      kv[k] = x;
      s.a.template load_smem_row<LN>(Hss + k * sn, n);                // K^-1 is done with
    }
  });
  // A x = (As xs)/e, H x = (Hs xs)/d, A^T y = (As^T ys)/d, g = gs/d and
  // y = e ys against the unscaled bounds
  QWBC_STAGE(st, nt, [&](S& s, int tid) {
    const ZyWho w = zy_who(tid, n, m);
    T v[CERT_MAXIMA] = {};
    const int i = w.idx;
    if (w.role == ZY_ROW) {
      const T ei = es[i], lo_i = clip(los[i], -big, big), uo_i = clip(uos[i], -big, big);
      const T ax = s.a.template dot<LN>(kv, n) / ei;
      axs[i] = ax;
      yus[i] = ei * ys[i];
      zo[bm + i] = zs[i];
      yo[bm + i] = ys[i];
      los[i] = lo_i;
      uos[i] = uo_i;
      cert_row_terms(lo_i, uo_i, ax, v);
    } else if (w.role == ZY_KROW) {
      const T dj = ds[i];
      cert_var_terms(s.a.template dot<LN>(kv, n) / dj, atys[i] / dj, gs[i] / dj, v);
    }
    cert_warp_maxima(v, red, nw);
  });
  cert_finish(red, nw, axs, yus, los, uos, m, pr, du, sv, b);
}

#ifdef __CUDACC__

template <typename T, int W>
__global__ void __launch_bounds__(W > 0 ? ZY_THREADS : 1024, W > 0 ? 4 : 1)
    admm_zy_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A, const T* __restrict__ g,
    const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ x0, const T* __restrict__ z0, const T* __restrict__ y0,
    const T* __restrict__ Hs, const T* __restrict__ lo, const T* __restrict__ uo,
    const T* __restrict__ d, const T* __restrict__ e,
    T* __restrict__ xo, T* __restrict__ zo, T* __restrict__ yo,
    T* __restrict__ pr, T* __restrict__ du, T* __restrict__ sv,
    int n, int m, int iters, T alpha, T oma, T w0, T omw0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ZyThread<T, W> st[1];
  admm_zy_block<T, W>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d, e, xo, zo, yo,
                      pr, du, sv, blockIdx.x, n, m, iters, alpha, oma, w0, omw0,
                      reinterpret_cast<T*>(smem_raw), st);
}

template <typename T, int W>
int launch_zy_variant(const void* Kinv, const void* A, const void* g, const void* l,
                      const void* u, const void* rho, const void* x0, const void* z0,
                      const void* y0, const void* Hs, const void* lo, const void* uo,
                      const void* d, const void* e, void* xo, void* zo, void* yo,
                      void* pr, void* du, void* sv, int B, int n, int m, int iters,
                      T alpha, T oma, T w0, T omw0, void* stream) {
  const size_t smem = sizeof(T) * zy_smem_words(n, m, W > 0);
  if (int err = allow_shared_memory<admm_zy_kernel<T, W>>(smem)) return err;
  admm_zy_kernel<T, W><<<B, zy_threads(n, m), smem, (cudaStream_t)stream>>>(
      (const T*)Kinv, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
      (const T*)rho, (const T*)x0, (const T*)z0, (const T*)y0, (const T*)Hs,
      (const T*)lo, (const T*)uo, (const T*)d, (const T*)e,
      (T*)xo, (T*)zo, (T*)yo, (T*)pr, (T*)du, (T*)sv,
      n, m, iters, alpha, oma, w0, omw0);
  return (int)cudaGetLastError();
}

#else  // plain C++: one thread runs the blocks one after the other

template <typename T, int W>
int launch_zy_variant(const void* Kinv, const void* A, const void* g, const void* l,
                      const void* u, const void* rho, const void* x0, const void* z0,
                      const void* y0, const void* Hs, const void* lo, const void* uo,
                      const void* d, const void* e, void* xo, void* zo, void* yo,
                      void* pr, void* du, void* sv, int B, int n, int m, int iters,
                      T alpha, T oma, T w0, T omw0, void*) {
  std::vector<T> smem(zy_smem_words(n, m, W > 0));
  std::vector<ZyThread<T, W>> st(zy_threads(n, m));
  for (int b = 0; b < B; ++b)
    admm_zy_block<T, W>(
        (const T*)Kinv, (const T*)A, (const T*)g, (const T*)l, (const T*)u,
        (const T*)rho, (const T*)x0, (const T*)z0, (const T*)y0, (const T*)Hs,
        (const T*)lo, (const T*)uo, (const T*)d, (const T*)e,
        (T*)xo, (T*)zo, (T*)yo, (T*)pr, (T*)du, (T*)sv,
        b, n, m, iters, alpha, oma, w0, omw0, smem.data(), st.data());
  return 0;
}

#endif

// the instantiation by shape and type (zy_in_registers): registers, else the
// matrices in shared memory
template <typename T>
int launch_admm_zy(const void* Kinv, const void* A, const void* g, const void* l,
                   const void* u, const void* rho, const void* x0, const void* z0,
                   const void* y0, const void* Hs, const void* lo, const void* uo,
                   const void* d, const void* e, void* xo, void* zo, void* yo,
                   void* pr, void* du, void* sv, int B, int n, int m, int iters,
                   T alpha, T oma, T w0, T omw0, void* stream) {
  if constexpr (sizeof(T) == 4) {
    if (zy_in_registers(n, m, 4))
      return launch_zy_variant<T, ZY_MMAX>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo,
                                           uo, d, e, xo, zo, yo, pr, du, sv, B, n, m,
                                           iters, alpha, oma, w0, omw0, stream);
  }
  return launch_zy_variant<T, 0>(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d, e,
                                 xo, zo, yo, pr, du, sv, B, n, m, iters, alpha, oma,
                                 w0, omw0, stream);
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

// the wrapper's checks, for a shape and an element size in bytes: 1 where
// the matrices stay in registers, else 0; the block's threads; its shared
// memory in words
int qwbc_admm_zy_in_registers(int n, int m, int elem_bytes) {
  return qwbc::zy_in_registers(n, m, elem_bytes);
}

int qwbc_admm_zy_threads(int n, int m) { return qwbc::zy_threads(n, m); }

size_t qwbc_admm_zy_words(int n, int m, int elem_bytes) {
  return qwbc::zy_smem_words(n, m, qwbc::zy_in_registers(n, m, elem_bytes));
}

}  // extern "C"
