// Safeguarded warm Newton-Schulz inverse of a batch of SPD matrices, one
// block per matrix.
//
// Replaces the TPU kernel ops/pallas/ns_kernel.py::ns_inverse_warm_pallas
// (_ns_warm_kernel) of the JAX package.  That kernel keeps 128 matrices on
// the lane axis and, because its compiler contracts only the leading axis,
// tracks the transposed iterate beside the iterate; here one block owns one
// matrix and computes X (2I - A X) directly.  Semantics, as there:
//   * start from W unless ||I - A W||_inf < 1e3 fails (also for NaN), then
//     from the Jacobi-scaled X0 = (D A D) o (d d^T) / (||DAD||_inf ||DAD||_1),
//     D = diag(d), d = |diag A|^-1/2;
//   * `iters` steps X <- X (2I - A X);
//   * where max |X| < 1e30 fails (a blown-up or NaN iterate), return X0.
//
// Bound on this card: operations.  The function needs 2 * iters n*n
// products when the warm start is accepted (2 n^3 operations each: 0.59
// Mflop per matrix at n = 42 and two steps) against 21 KB read and written
// in float32.  What the design does about it:
//   * register tiles: each thread owns a 4 x 4 tile of a product over the
//     output padded to a multiple of 4 (44 x 44 at n = 42, 121 threads; 72 x
//     72 at n = 70, 324); a step k is one 16-byte load of the left
//     operand's four words (two in float64), one of the right operand's,
//     and 16 fused multiply-adds on accumulators in registers: the
//     outer-product form of the TPU kernel, on one thread's tile.  Tiles of
//     4 x 8 ran slower on an H100 at n = 42 and at n = 70 (fewer warps to
//     hide the loads' latency);
//   * both operands read along rows: A is stored transposed (A^T[k][i] =
//     A[i][k]) and X^T is kept beside X, written from the same registers,
//     so A X reads rows of A^T and X, and X R rows of X^T and R.  The k
//     loop runs exactly n steps (a padded step would add 0 * 0 and turn an
//     exact -0 sum into +0); the padding is in i and j only, its columns
//     zero at the start, and padded outputs are dropped or land in padding;
//   * one A W: the check's product M = A W stays in each thread's
//     registers; (I - M)^T is stored for the check's row sums, and where
//     the warm start is accepted (block-uniform) the first step's R is
//     2I - M from the same registers (the rounding of recomputing it);
//   * four n x ld buffers (A^T, X, X^T, R: 30 KB at n = 42 in float32); the
//     products are written in place from registers, A X into R in its own
//     stage, X R over X and X^T after a barrier.  ld is the padded width,
//     four words more where a quarter of it is even, so that the row sums'
//     and the guard's reads, a row or column a thread, meet no bank twice;
//   * A and W arrive by cp.async, W into both X and X^T; X0 is never
//     stored but where it is the start: its entries are recomputed from A.
// Barriers: three an iteration (R = 2I - A X; X R into registers; its
// store over X and X^T), where the design it replaced had two and an
// output-only buffer; five before the first (the loads, M and (I - M)^T,
// the row sums, their maxima, X0 where the warm start is rejected) and two
// after the last.
// Every output entry keeps the sum of the kernel this design replaced: one
// accumulator from +0 over k = 0 .. n-1 in rising order, one fused
// multiply-add a step (its compiler's contraction, written out with
// fmadd), so its outputs bit for bit.
//
// Written with the stage macros of common.cuh (the tiles' accumulators in
// a per-thread state struct, QWBC_STAGE), so the file also compiles as
// plain C++ (see common.cuh), where the tests check it.
#include "common.cuh"
#ifndef __CUDACC__
#include <vector>
#endif

namespace qwbc {

constexpr int NS_TILE = 4;   // a thread's tile: 4 x 4 entries of a product

// the products' padded width: n rounded up to the tile
__host__ __device__ inline int ns_warm_width(int n) { return (n + 3) / 4 * 4; }

// row stride of the four matrices: the width, four words more where a
// quarter of it is even, so that eight threads reading 16 bytes each from
// eight consecutive rows hit all 32 banks
__host__ __device__ inline int ns_warm_ld(int n) {
  const int w = ns_warm_width(n);
  return (w / 4) % 2 ? w : w + 4;
}

// the tiles (threads of the products) at order n
__host__ __device__ inline int ns_warm_tiles(int n) {
  const int t = ns_warm_width(n) / NS_TILE;
  return t * t;
}

__host__ __device__ inline size_t ns_warm_words(int n) {
  return 4 * (size_t)n * ns_warm_ld(n) + 4 * (size_t)n + 4;
}

template <typename T>
struct NsTile {
  T acc[NS_TILE][NS_TILE];
};

// four consecutive words at a 16-byte aligned shared-memory address, in
// one 16-byte load or store (two in float64)
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* v) {
#ifdef __CUDACC__
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const double2 f = reinterpret_cast<const double2*>(p)[0];
    const double2 h = reinterpret_cast<const double2*>(p)[1];
    v[0] = f.x; v[1] = f.y; v[2] = h.x; v[3] = h.y;
  }
#else
  for (int q = 0; q < 4; ++q) v[q] = p[q];
#endif
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T* v) {
#ifdef __CUDACC__
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
#else
  for (int q = 0; q < 4; ++q) p[q] = v[q];
#endif
}

// f(r, c, idx) for every entry idx = r * n + c of an n x n matrix, spread
// over the block as QWBC_FOR spreads idx (no division an entry on the card)
template <typename F>
__device__ __forceinline__ void for_entries(int n, F f) {
#ifdef __CUDACC__
  const int step = blockDim.x, dr = step / n, dc = step - dr * n;
  int r = threadIdx.x / n, c = threadIdx.x - r * n;
  for (int idx = threadIdx.x; idx < n * n; idx += step) {
    f(r, c, idx);
    r += dr;
    c += dc;
    if (c >= n) { c -= n; ++r; }
  }
#else
  QWBC_FOR(idx, n * n) {
    const int r = idx / n;
    f(r, idx - r * n, idx);
  }
#endif
}

// acc[r][c] = sum_k L[k][i0 + r] * R[k][j0 + c] over k = 0 .. n-1 in
// rising order, one accumulator from +0 and one fused multiply-add a step
template <typename T>
__device__ __forceinline__ void tile_product(const T* L, const T* R, int ld, int n,
                                             int i0, int j0,
                                             T (&acc)[NS_TILE][NS_TILE]) {
#pragma unroll
  for (int r = 0; r < NS_TILE; ++r)
#pragma unroll
    for (int c = 0; c < NS_TILE; ++c) acc[r][c] = T(0);
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    T a[NS_TILE], b[NS_TILE];
    load4(L + k * ld + i0, a);
    load4(R + k * ld + j0, b);
#pragma unroll
    for (int r = 0; r < NS_TILE; ++r)
#pragma unroll
      for (int c = 0; c < NS_TILE; ++c) acc[r][c] = fmadd(a[r], b[c], acc[r][c]);
  }
}

// the tile's rows below n into M, v(r, c) an entry
template <typename T, typename F>
__device__ __forceinline__ void store_rows(T* M, int ld, int n, int i0, int j0, F v) {
#pragma unroll
  for (int r = 0; r < NS_TILE; ++r) {
    if (i0 + r >= n) break;
    T w[NS_TILE];
#pragma unroll
    for (int c = 0; c < NS_TILE; ++c) w[c] = v(r, c);
    store4(M + (i0 + r) * ld + j0, w);
  }
}

// the tile transposed: its columns below n as rows of Mt, v(r, c) an entry
template <typename T, typename F>
__device__ __forceinline__ void store_cols(T* Mt, int ld, int n, int i0, int j0, F v) {
#pragma unroll
  for (int c = 0; c < NS_TILE; ++c) {
    if (j0 + c >= n) break;
    T w[NS_TILE];
#pragma unroll
    for (int r = 0; r < NS_TILE; ++r) w[r] = v(r, c);
    store4(Mt + (j0 + c) * ld + i0, w);
  }
}

// X0[i][j] from A^T, d and r1 * c1 (the un-iterated cold start)
template <typename T>
__device__ __forceinline__ T ns_x0(const T* At, int ld, const T* d, T rc, int i, int j) {
  const T dd = d[i] * d[j];
  return (At[j * ld + i] * dd) * dd / rc;
}

template <typename T>
__device__ void ns_warm_block(const T* __restrict__ A, const T* __restrict__ W,
                              T* __restrict__ X, int b, int n, int iters, T* smem,
                              NsTile<T>* st) {
  const int ld = ns_warm_ld(n), nt = ns_warm_tiles(n), tcols = ns_warm_width(n) / NS_TILE;
  T* At = smem;              // n * ld   A^T
  T* Xs = At + n * ld;       // n * ld   W, then the iterate X
  T* Xt = Xs + n * ld;       // n * ld   X^T
  T* Rs = Xt + n * ld;       // n * ld   (I - A W)^T, then 2I - A X
  T* d = Rs + n * ld;        // n        |diag A|^-1/2
  T* rs = d + n;             // n        row sums / row maxima
  T* cs = rs + n;            // n        column sums
  T* es = cs + n;            // n        row sums of |I - A W|
  T* sc = es + n;            // 4        r1 * c1, warm ok, max |X| ok
  const size_t off = (size_t)b * n * n;
  // a tile's first row and column
  const auto corner = [&](int t, int& i0, int& j0) {
    const int ti = t / tcols;
    i0 = ti * NS_TILE;
    j0 = (t - ti * tcols) * NS_TILE;
  };

  for_entries(n, [&](int r, int c, int idx) {
    async_copy(At + c * ld + r, A + off + idx);
    async_copy(Xs + r * ld + c, W + off + idx);
    async_copy(Xt + c * ld + r, W + off + idx);
  });
  async_commit();
  QWBC_FOR(i, n) {           // the padding columns
    for (int c = n; c < ld; ++c)
      At[i * ld + c] = Xs[i * ld + c] = Xt[i * ld + c] = Rs[i * ld + c] = T(0);
  }
  async_wait<0>();
  QWBC_SYNC();
  QWBC_FOR(i, n) d[i] = T(1) / sqrt(absv(At[i * ld + i]) + T(1e-30));
  QWBC_STAGE(st, nt, [&](NsTile<T>& s, int t) {        // M = A W; (I - M)^T
    if (t >= nt) return;
    int i0, j0;
    corner(t, i0, j0);
    tile_product(At, Xs, ld, n, i0, j0, s.acc);
    store_cols(Rs, ld, n, i0, j0, [&](int r, int c) {
      return (i0 + r == j0 + c ? T(1) : T(0)) - s.acc[r][c];
    });
  });
  // row i's sums, j rising: A's row i is column i of A^T, as (I - M)'s of
  // Rs (one word a thread side by side); A's column i is row i of A^T,
  // four words a load
  QWBC_FOR(i, n) {
    const T di = d[i];
    T r = T(0), c = T(0), e = T(0);
    for (int j = 0; j < n; ++j) {
      r += absv(At[j * ld + i] * (di * d[j]));
      e += absv(Rs[j * ld + i]);
    }
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      T a[4];
      load4(At + i * ld + j, a);
      for (int q = 0; q < 4; ++q) c += absv(a[q] * (d[j + q] * di));
    }
    for (; j < n; ++j) c += absv(At[i * ld + j] * (d[j] * di));
    rs[i] = r; cs[i] = c; es[i] = e;
  }
  QWBC_SYNC();
  if (lead_warp()) {         // maxima are exact in any order
    T r1 = T(0), c1 = T(0), err = T(0);
    QWBC_LANES(i, n) {
      r1 = nan_max(r1, rs[i]); c1 = nan_max(c1, cs[i]); err = nan_max(err, es[i]);
    }
    r1 = warp_max(r1); c1 = warp_max(c1); err = warp_max(err);
    if (lead_lane()) {
      sc[0] = r1 * c1;
      sc[1] = err < T(1e3) ? T(1) : T(0);      // false for NaN
    }
  }
  QWBC_SYNC();
  const bool warm = sc[1] != T(0);             // block-uniform
  if (!warm) {
    for_entries(n, [&](int r, int c, int) {
      Xs[r * ld + c] = Xt[c * ld + r] = ns_x0(At, ld, d, sc[0], r, c);
    });
    QWBC_SYNC();
  }
  for (int it = 0; it < iters; ++it) {
    QWBC_STAGE(st, nt, [&](NsTile<T>& s, int t) {      // R = 2I - A X
      if (t >= nt) return;
      int i0, j0;
      corner(t, i0, j0);
      if (it > 0 || !warm) tile_product(At, Xs, ld, n, i0, j0, s.acc);
      store_rows(Rs, ld, n, i0, j0, [&](int r, int c) {
        return (i0 + r == j0 + c ? T(2) : T(0)) - s.acc[r][c];
      });
    });
    QWBC_STAGE(st, nt, [&](NsTile<T>& s, int t) {      // X R
      if (t >= nt) return;
      int i0, j0;
      corner(t, i0, j0);
      tile_product(Xt, Rs, ld, n, i0, j0, s.acc);
    });
    QWBC_STAGE(st, nt, [&](NsTile<T>& s, int t) {      // X <- X R, and X^T
      if (t >= nt) return;
      int i0, j0;
      corner(t, i0, j0);
      const auto v = [&](int r, int c) { return s.acc[r][c]; };
      store_rows(Xs, ld, n, i0, j0, v);
      store_cols(Xt, ld, n, i0, j0, v);
    });
  }
  QWBC_FOR(i, n) {           // row i of X is column i of X^T
    T v = absv(Xt[i]);
    for (int j = 1; j < n; ++j) v = nan_max(v, absv(Xt[j * ld + i]));
    rs[i] = v;
  }
  QWBC_SYNC();
  if (lead_warp()) {
    T v = T(0);
    QWBC_LANES(i, n) v = nan_max(v, rs[i]);
    v = warp_max(v);
    if (lead_lane()) sc[2] = v < T(1e30) ? T(1) : T(0);   // false for inf and NaN
  }
  QWBC_SYNC();
  const bool ok = sc[2] != T(0);
  for_entries(n, [&](int r, int c, int idx) {
    X[off + idx] = ok ? Xs[r * ld + c] : ns_x0(At, ld, d, sc[0], r, c);
  });
}

#ifdef __CUDACC__

template <typename T>
__global__ void ns_warm_kernel(const T* __restrict__ A, const T* __restrict__ W,
                               T* __restrict__ X, int n, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  NsTile<T> st[1];
  ns_warm_block<T>(A, W, X, blockIdx.x, n, iters, reinterpret_cast<T*>(smem_raw), st);
}

template <typename T>
int launch_ns_warm(const void* A, const void* W, void* X, int B, int n, int iters,
                   void* stream) {
  const size_t smem = sizeof(T) * ns_warm_words(n);
  const int threads = (ns_warm_tiles(n) + 31) / 32 * 32;
  if (int err = allow_shared_memory<ns_warm_kernel<T>>(smem)) return err;
  ns_warm_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)W, (T*)X, n, iters);
  return (int)cudaGetLastError();
}

#else  // plain C++: one thread runs the blocks one after the other

template <typename T>
int launch_ns_warm(const void* A, const void* W, void* X, int B, int n, int iters,
                   void*) {
  std::vector<T> smem(ns_warm_words(n));
  std::vector<NsTile<T>> st(ns_warm_tiles(n));
  for (int b = 0; b < B; ++b)
    ns_warm_block<T>((const T*)A, (const T*)W, (T*)X, b, n, iters, smem.data(),
                     st.data());
  return 0;
}

#endif

}  // namespace qwbc

extern "C" {

int qwbc_ns_warm_f32(const void* A, const void* W, void* X, int B, int n, int iters,
                     void* stream) {
  return qwbc::launch_ns_warm<float>(A, W, X, B, n, iters, stream);
}

int qwbc_ns_warm_f64(const void* A, const void* W, void* X, int B, int n, int iters,
                     void* stream) {
  return qwbc::launch_ns_warm<double>(A, W, X, B, n, iters, stream);
}

}  // extern "C"
