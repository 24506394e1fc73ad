// The register design of the two ADMM kernels, constraint-space (admm_zy.cu,
// K1) and x-space (admm.cu, K5 and K6): the thread roles, the block's size
// and each thread's matrix words.
//
// Each iteration of either kernel is three chained matvecs over one
// scenario's A (m x n) and K^-1 (n x n): A^T ., K^-1 ., A .  One thread an
// output, in three roles (zy_who): a row of A, a column of A, a row of
// K^-1.  In float32 within ZY_NMAX variables and ZY_MMAX rows each thread
// holds its words in registers for the whole launch (ZyWords<T, W>, W > 0);
// above that, and in float64, the same stages read them from shared memory
// (ZyWords<T, 0>).  Both sum a dot product in one accumulator over
// j = 0, 1, ... in rising order.
#pragma once
#include "common.cuh"

namespace qwbc {

// the register instantiation (float32): at most ZY_NMAX variables and
// ZY_MMAX constraint rows, so the threads are at most ZY_THREADS (zy_threads)
constexpr int ZY_NMAX = 44;
constexpr int ZY_MMAX = 72;
constexpr int ZY_THREADS = 160;

__host__ __device__ inline int round32(int v) { return (v + 31) & ~31; }

// rows of A on threads [0, m), columns of A on [R, R + n) with R = m rounded
// up to a warp, rows of K^-1 on what is left: [m, R), then [R + n, ...)
__host__ __device__ inline int zy_threads(int n, int m) {
  const int R = round32(m);
  return round32(R + n > m + 2 * n ? R + n : m + 2 * n);
}

// float32 within the maxima keeps the matrices in registers; float64 does
// not: its words would take 144 of the 168 registers a thread has at two
// blocks an SM (a 5-warp block puts 3 of 10 warps on one register
// sub-partition), and that measured slower than shared memory
__host__ __device__ inline bool zy_in_registers(int n, int m, int elem_bytes) {
  return elem_bytes == 4 && n <= ZY_NMAX && m <= ZY_MMAX;
}

enum ZyRole { ZY_ROW, ZY_COL, ZY_KROW, ZY_IDLE };

struct ZyWho {
  int role, idx;   // the role and the row or column it owns
};

// worked out again in every stage (from the thread index and uniform
// values) rather than carried: it would take registers from the words
__host__ __device__ inline ZyWho zy_who(int tid, int n, int m) {
  const int R = round32(m);
  if (tid < m) return {ZY_ROW, tid};
  if (tid >= R && tid < R + n) return {ZY_COL, tid - R};
  const int k = tid < R ? tid - m : tid - m - n;
  return {k < n ? ZY_KROW : ZY_IDLE, k};
}

// a vector region's words: padded to eight, and in the register
// instantiation to the unrolled length of the products that read it
__host__ __device__ inline int zy_pad(int len, int unrolled) {
  return pad8(len > unrolled ? len : unrolled);
}

// Four consecutive words of a padded shared-memory vector (one 16-byte
// broadcast load serves every thread of the warp).  The load is volatile:
// ptxas then keeps the loads where the source puts them, ahead of the
// multiply-adds, where it otherwise moves each next to its first use and
// the chain waits for every load.
__device__ __forceinline__ void load4(const float* v, float* x) {
#ifdef __CUDACC__
  const unsigned a = (unsigned)__cvta_generic_to_shared(v);
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]) : "r"(a));
#else
  for (int u = 0; u < 4; ++u) x[u] = v[u];
#endif
}

// The matrix words of one thread, W > 0: in registers, zero past the
// thread's length.  dot<L>(v, len) is sum_j w[j] * v[j] over j = 0 .. L-1 in
// rising order in one accumulator; v is a shared-memory region of at least L
// words, zero past len.  The terms past len add fma(0, 0, acc) = acc
// exactly (acc is never -0: it starts at +0, and a sum that cancels to zero
// is +0), so the sum is the one over j < len, and the fully unrolled chain
// needs no guard: every load can be issued ahead of the multiply-adds.
template <typename T, int W>
struct ZyWords {
  static_assert(sizeof(T) == 4 && W % 4 == 0, "float32, whole 16-byte loads");
  T w[W];

  // a contiguous row of device memory, 8 bytes a load where aligned
  template <int L>
  __device__ __forceinline__ void load_row(const T* __restrict__ src, int len) {
#ifdef __CUDACC__
    if ((reinterpret_cast<size_t>(src) & 7) == 0) {
#pragma unroll
      for (int j = 0; j < L; j += 2) {
        if (j + 1 < len) {
          const float2 p = *reinterpret_cast<const float2*>(src + j);
          w[j] = p.x; w[j + 1] = p.y;
        } else {
          w[j] = j < len ? src[j] : T(0);
          w[j + 1] = T(0);
        }
      }
      return;
    }
#endif
#pragma unroll
    for (int j = 0; j < L; ++j) w[j] = j < len ? src[j] : T(0);
  }

  // a column: len words `stride` apart (consecutive threads read
  // consecutive addresses)
  template <int L>
  __device__ __forceinline__ void load_col(const T* __restrict__ src, int stride, int len) {
#pragma unroll
    for (int j = 0; j < L; ++j) w[j] = j < len ? src[(size_t)j * stride] : T(0);
  }

  // a row of shared memory (odd stride: a thread a row reads its own bank)
  template <int L>
  __device__ __forceinline__ void load_smem_row(const T* src, int len) {
#pragma unroll
    for (int j = 0; j < L; ++j) w[j] = j < len ? src[j] : T(0);
  }

  template <int L>
  __device__ __forceinline__ T dot(const T* v, int) const {
    static_assert(L % 4 == 0 && L <= W, "dot within the words");
    // G chunks of four loaded ahead of their multiply-adds
    constexpr int C = L / 4, G = 4;
    T acc = T(0);
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += G) {
      T x[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (c0 + g < C) load4(v + (c0 + g) * 4, x[g]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (c0 + g < C) {
#pragma unroll
          for (int u = 0; u < 4; ++u) acc = fmadd(w[(c0 + g) * 4 + u], x[g][u], acc);
        }
      }
    }
    return acc;
  }
};

// W = 0: the words in shared memory, `stride` apart
template <typename T>
struct ZyWords<T, 0> {
  const T* p = nullptr;
  int stride = 1;

  template <int L>
  __device__ __forceinline__ void load_smem_row(const T* src, int) {
    p = src;
    stride = 1;
  }

  template <int L>
  __device__ __forceinline__ T dot(const T* v, int len) const {
    T acc = T(0);
    for (int j = 0; j < len; ++j) acc = fmadd(p[j * stride], v[j], acc);
    return acc;
  }
};


}  // namespace qwbc
