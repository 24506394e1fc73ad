// The whole WBC setup of one control cycle in one launch, one block per
// scenario: contact bookkeeping, forward kinematics, Jacobian parts, the
// velocity-product recursion, the mass-matrix blocks, the closed-form inverse
// of the base block, the centroidal blocks, T and d(T^-1)/dt, the foot
// Jacobians, the finite differences, the desired wrench, the swing
// accelerations and the assembly of the 42 x 70 QP; in the fused variant
// also H, the Ruiz sweeps, the scaled problem, rho and the scaled,
// switch-masked warm start (prepare_tail.cuh, shared with prepare.cu).
//
// Replaces the TPU kernel ops/pallas/setup_kernel.py::setup_batched
// (_setup_call, kernel body _make_kernel) of the JAX package, its plain and
// its fused-prepare variant, with the finite differences (K3) or with
// exact_mode (K3x, the template parameter EXACT): there Tdot and Jdot are the
// analytic tangents of the same recursion along the state flow (Rdot =
// skew(omega) R, pdot = v, qdot), carried stage by stage beside the primal
// values in SetupTangents, the centroidal bias reads the fresh d(T^-1)/dt
// (formed before the bias, where the finite-difference variant reads the
// carried one), and nothing is gated on a contact switch or deriv_valid.
// That kernel keeps 128
// scenarios on the lane axis, one scenario per lane, with the robot model
// baked into the generated code.  Here one thread block owns one scenario,
// the model is data (a packed table of constants and the tree's topology in
// device memory, see ops/kernels/setup.py), so one binary serves any tree of
// 13 bodies and 4 feet, and sin, cos and the base's roll-pitch-yaw are taken
// in the kernel.
//
// Bound on this card: bytes.  A scenario reads about 1,000 words and writes
// about 5,200 (plain) or 10,700 (fused: the scaled H and A again) against a
// few tens of kflop (exact mode: about twice the kinematic and mass-block
// work, the same bytes).  The design keeps every intermediate in shared memory,
// assembles A and H there (H as its diagonal and its dense block), runs the
// Ruiz sweeps on them in place and writes each output once, coalesced.  The
// body is a chain of small dependent stages (3-, 6-, 12- and 18-wide
// contractions over the tree), so what sets the time is latency: each stage
// puts its independent items (bodies of one tree level, matrix entries,
// rows) in one list, the heavy ones first, spread over the block's threads,
// and ends in a barrier; a loop over the bodies a joint moves visits only
// those; values dead after the mass blocks share their words with what is
// formed later, so 9 blocks fit an SM in float32.  Nothing that crosses a
// barrier is held in a register, so the same source also runs as plain C++
// (common.cuh) where the arithmetic is checked without a GPU.
//
// Every output is the previous kernel's bit for bit: each sum keeps
// its order, and where nvcc would contract the same text differently in the
// new code, the old kernel's choice is written out with fmadd.
//
// Rows 0-17 of the QP are equalities because the SAME value is stored to l
// and u; each is computed once and stored twice, never recomputed per side
// (an FMA contraction could make the two differ by an ulp and rho would drop
// by rho_eq_scale).  One-sided bounds are +-1e20, never inf.
#include "prepare_tail.cuh"

namespace qwbc {

constexpr int NB = 13, NJ = 12, NL = 4, NV = 18, NQ = 42, MQ = 70;
constexpr int SN = NQ + 1;            // odd row stride of A in shared memory
constexpr int HB0 = NV, HNB = 3 * NL; // H: a diagonal and the contact forces' block
template <typename T>
using WbcH = BlockDiagH<T, HB0, HNB>;

// ---- the packed model + controller constants (ops/kernels/setup.py) ----
// per joint: M0, M1, M2 (joint rotation R_j (I + s K + (1-c) K^2) split by
// its coefficients, 9 each), the joint origin and R_j axis in the parent frame
constexpr int CJ_M0 = 0, CJ_M1 = 9, CJ_M2 = 18, CJ_P = 27, CJ_AX = 30, CJ_SIZE = 33;
// per body: mass, mass / total mass, centre of mass (3), inertia (9)
constexpr int CB_MASS = 0, CB_WM = 1, CB_COM = 2, CB_INERTIA = 5, CB_SIZE = 14;
constexpr int MC_JOINT = 0;
constexpr int MC_BODY = MC_JOINT + NJ * CJ_SIZE;
constexpr int MC_FOOT = MC_BODY + NB * CB_SIZE;          // per foot: position (3)
constexpr int MC_SCAL = MC_FOOT + NL * 3;
enum {
  SC_MTOT, SC_INV_M, SC_INV_M2, SC_MG, SC_DT, SC_INV_DT, SC_MU,
  SC_KP,                                                  // 6 values
  SC_KD = SC_KP + 6, SC_KI, SC_KP_SWING, SC_KD_SWING, SC_TAU_MAX,
  SC_SLACK_W, SC_INF, SC_COUNT
};
constexpr int MC_SIZE = MC_SCAL + SC_COUNT;
// topology: parent, depth and ancestor-joint mask of every body, the feet's
// bodies, the tree's depth
constexpr int TP_PARENT = 0, TP_DEPTH = NB, TP_ANC = 2 * NB, TP_FOOT = 3 * NB,
              TP_MAXDEPTH = 3 * NB + NL, TP_SIZE = 3 * NB + NL + 1;

// ---- the pointer table handed over by the wrapper, in this order ----
enum {
  // inputs of type T
  I_R0, I_P0, I_BV, I_Q, I_QD, I_RPOSE, I_RVEL, I_RACC, I_SPOS, I_SVEL, I_SACC,
  I_RCON, I_OLD_T, I_OLD_JST, I_OLD_JSW, I_TDINV, I_INTEG, I_PREVC,
  I_WX, I_WZ, I_WY, I_MC,
  // inputs of other types: bytes (bool) and int
  I_SWFLAG, I_DERIVV, I_REFNEW, I_TOPO,
  // outputs of type T
  O_A, O_G, O_L, O_U, O_H, O_HC, O_COM, O_POSE, O_FPOS, O_MCJJ, O_JSTJ,
  O_T, O_JST, O_JSW, O_TDINV, O_INTEG, O_PREVC,
  O_SH, O_SA, O_SG, O_SL, O_SU, O_RHO, O_WXS, O_WZS, O_WYS, O_D, O_E,
  // output bytes (bool): the switch flag, deriv_valid (always true)
  O_SWFLAG, O_DVALID,
  N_PTRS
};

struct SetupPtrs {
  void* p[N_PTRS];
};

// A block's shared memory.  Values of the kinematics and the dynamics that
// are dead once the mass blocks are formed share their words with what is
// formed from X on (and the Ruiz scalings of the tail): 21.4 KB in float32,
// 42.6 KB in float64.
template <typename T>
struct SetupShared {
  T A[MQ][SN];                       // the QP under assembly: A, then H
  T Hd[NQ], Hb[HNB][WbcH<T>::LDB];   //   as its diagonal and its block
  T g[NQ], l[MQ], u[MQ];
  T u18[NV];                         // [base twist; qd]
  T sq[NJ], cq[NJ], rpy[3];
  T rpose[6], rvel[6], racc[6], spos[12], svel[12], sacc[12], integ[6];
  T con[NL];                         // contacts in force this cycle
  T gate;                            // 0 where the finite differences are void
  int dropd;                         // contact switch: drop the warm duals
  int tp[TP_SIZE];                   // the topology table
  unsigned desc[NJ];                 // per joint: the bodies it moves (bit bb)
  T R[NB][9], p[NB][3], axw[NJ][3];
  T com[3], dcom[3], cvel[6];
  T hcor[NV], tdu[6];
  T Mbj[6][NJ], Mjj[NJ][NJ], Mb[6][6], Mbi[6][6];
  T X[6][NJ];
  union {
    struct {                         // dead after the mass blocks
      T cw[NB][3], r[NB][3];
      T w[NB][3], al[NB][3], ao[NB][3];   // velocity-product recursion
      T Iw[NB][9], F[NB][3], Nb[NB][3];
      T jq[NB][NJ][3], Iwa[NB][NJ][3];    // zero where joint j does not move body b
      T mr[3], rot[9];
    };
    struct {                         // first written after the mass blocks
      T X0[6][NJ], Xr[6][NJ], MbX[6][NJ];
      T Mcb[6][6], Ttop[6][NV], Td[6][NV], adjD[6][NV];
      T hMT[NV], hc[NV];
      T Jcf[NL][3][NV];              // centroidal foot Jacobians, unmasked
      T fpos[12], fvel[12], wdes[6];
      T d[2][NQ], e[2][MQ];          // Ruiz scalings, double-buffered
    };
  };
};

// exact mode only: the time derivatives along the state flow of the primal
// quantities of the same names in SetupShared (about 900 words more a block;
// the finite-difference variant does not allocate them)
template <typename T>
struct SetupTangents {
  T R[NB][9], p[NB][3], axw[NJ][3];
  T cw[NB][3], r[NB][3], Iw[NB][9];
  T com[3], dcom[3], mr[3], rot[9];
  T Mbj[6][NJ], Mb[6][6], X[6][NJ];
  T tdi[6][NV];                      // the fresh d(T^-1)/dt, top rows
  T Jf[NL][3][NV];                   // centroidal foot Jacobians, unmasked
};

// ---- the section probes (template parameter STOP; profiling only): the
// kernel stops after the named section of the JAX kernel's body
// (ops/pallas/setup_kernel.py, _make_kernel's `stop_after` cuts), at the
// stage boundary nearest that cut, and writes the sum of the section's live
// values (_checksum there) into com, three copies; every other output stays
// unwritten.  Sections in order; STOP_NONE is the whole kernel.
enum { STOP_NONE, STOP_INPUTS, STOP_FK, STOP_JAC, STOP_RECURSION, STOP_MASS,
       STOP_CENTROIDAL, STOP_FOOT, STOP_FD, N_STOPS };

// n values of a section: contiguous words, or rows of `cols` at stride ld
template <typename T>
struct Part {
  const T* p;
  int n, cols, ld;
  __device__ T at(int i) const { return cols ? p[(i / cols) * ld + i % cols] : p[i]; }
};

template <typename T>
__device__ __forceinline__ Part<T> part(const T* p, int n, int cols = 0, int ld = 0) {
  return Part<T>{p, n, cols, ld};
}

// n values formed on the fly, f(i)
template <typename F>
struct Formed {
  int n;
  F f;
  __device__ auto at(int i) const { return f(i); }
};

template <typename F>
__device__ __forceinline__ Formed<F> formed(int n, F f) {
  return Formed<F>{n, f};
}

// the first warp sums the parts (after a barrier), each lane every 32nd
// value of each part, then across the lanes; lane 0 writes com.  The host
// build sums in the same order, so both give the same bits.
template <typename T, typename... P>
__device__ void write_checksum(T* com, const P&... parts) {
#ifdef __CUDACC__
  if (!lead_warp()) return;
  T acc = T(0);
  auto add = [&](const auto& pt) { QWBC_LANES(i, pt.n) acc += pt.at(i); };
  (add(parts), ...);
  acc = warp_sum(acc);
  if (lead_lane()) com[0] = com[1] = com[2] = acc;
#else
  T lane[32] = {}, next[32];
  auto add = [&](const auto& pt) {
    for (int i = 0; i < pt.n; ++i) lane[i % 32] += pt.at(i);
  };
  (add(parts), ...);
  for (int o = 16; o > 0; o >>= 1) {
    for (int l = 0; l < 32; ++l) next[l] = lane[l] + lane[l ^ o];
    for (int l = 0; l < 32; ++l) lane[l] = next[l];
  }
  com[0] = com[1] = com[2] = lane[0];
#endif
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ T cross_k(const T* a, const T* b, int k) {
  const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
  return a[k1] * b[k2] - a[k2] * b[k1];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// row i of the 3x3 row-major M times v
template <typename T>
__device__ __forceinline__ T mv3_row(const T* M, int i, const T* v) {
  return M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void mm3(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l)
      C[3 * i + l] = A[3 * i] * B[l] + A[3 * i + 1] * B[3 + l] + A[3 * i + 2] * B[6 + l];
}

template <typename T>
__device__ __forceinline__ void skew3(const T* v, T* S) {
  S[0] = T(0); S[1] = -v[2]; S[2] = v[1];
  S[3] = v[2]; S[4] = T(0); S[5] = -v[0];
  S[6] = -v[1]; S[7] = v[0]; S[8] = T(0);
}

// closed-form 3x3 inverse: adjugate times 1 / det
template <typename T>
__device__ void inv3(const T* M, T* O) {
  const T a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5],
          g = M[6], h = M[7], i = M[8];
  const T co00 = e * i - f * h, co01 = c * h - b * i, co02 = b * f - c * e;
  const T co10 = f * g - d * i, co11 = a * i - c * g, co12 = c * d - a * f;
  const T co20 = d * h - e * g, co21 = b * g - a * h, co22 = a * e - b * d;
  const T inv_det = T(1) / (a * co00 + b * co10 + c * co20);
  O[0] = co00 * inv_det; O[1] = co01 * inv_det; O[2] = co02 * inv_det;
  O[3] = co10 * inv_det; O[4] = co11 * inv_det; O[5] = co12 * inv_det;
  O[6] = co20 * inv_det; O[7] = co21 * inv_det; O[8] = co22 * inv_det;
}

// -skew(v)[p][q]
template <typename T>
__device__ __forceinline__ T neg_skew(const T* v, int p, int q) {
  if (p == q) return T(0);
  const int k = 3 - p - q;
  return ((q - p + 3) % 3 == 1) ? v[k] : -v[k];
}

// (Y @ adj)[p][c] for one row Y of 6, adj = [[I, skew(d)], [0, I]]
template <typename T>
__device__ __forceinline__ T adj_right(const T* Y, const T* d, int c) {
  if (c < 3) return Y[c];
  if (c == 3) return Y[3] + Y[1] * d[2] - Y[2] * d[1];
  if (c == 4) return Y[4] - Y[0] * d[2] + Y[2] * d[0];
  return Y[5] + Y[0] * d[1] - Y[1] * d[0];
}

// column c of adj Tdot_top, adj = [[I, skew(dcom)], [0, I]], into S.adjD
template <typename T>
__device__ __forceinline__ void adj_tdot_col(SetupShared<T>& S, int c) {
  for (int p = 0; p < 6; ++p) S.adjD[p][c] = S.Td[p][c];
  const T bot[3] = {S.Td[3][c], S.Td[4][c], S.Td[5][c]};
  for (int p = 0; p < 3; ++p) S.adjD[p][c] += cross_k(S.dcom, bot, p);
}

// d(T^-1)/dt [p][c], p < 6: -[adj D1 adj | adj (D2 - D1 X)] from S.adjD
template <typename T>
__device__ __forceinline__ T tdinv_entry(const SetupShared<T>& S, int p, int c) {
  if (c < 6) return -adj_right(S.adjD[p], S.dcom, c);
  T acc = T(0);
  for (int k = 0; k < 6; ++k) acc += S.adjD[p][k] * S.X[k][c - 6];
  return -(S.adjD[p][c] - acc);
}

// G: the tangents (EXACT only; null otherwise); STOP: a section probe
template <typename T, bool EXACT, int STOP>
__device__ void setup_block(const SetupPtrs& a, int b, int refnew_stride,
                            int fused, int sweeps, T rho0, T rho_eq,
                            SetupShared<T>& S, SetupTangents<T>* G) {
  auto in = [&](int k) { return static_cast<const T*>(a.p[k]); };
  auto out = [&](int k) { return static_cast<T*>(a.p[k]); };
  auto flag = [&](int k) { return static_cast<const unsigned char*>(a.p[k]); };
  const T* mc = in(I_MC);
  const int* tp_in = static_cast<const int*>(a.p[I_TOPO]);
  // the topology from shared memory, after the first stage
  const int* parent = S.tp + TP_PARENT;
  const int* depth = S.tp + TP_DEPTH;
  const int* anc = S.tp + TP_ANC;
  const int* foot_body = S.tp + TP_FOOT;
  const T* sc = mc + MC_SCAL;
  const size_t sb = (size_t)b;
  auto cj = [&](int j) { return mc + MC_JOINT + j * CJ_SIZE; };
  auto cb = [&](int bb) { return mc + MC_BODY + bb * CB_SIZE; };
  auto moves = [&](int bb, int j) { return ((anc[bb] >> j) & 1) != 0; };
  constexpr bool full = STOP == STOP_NONE;   // a probe writes com alone
  T* const com_out = out(O_COM) + sb * 3;

  // ---- stage: load, sin/cos, roll-pitch-yaw, contact bookkeeping, the
  // topology and the joints' body masks; every item on a thread of its own ----
  zero_words(&S.A[0][0], MQ * SN);
  constexpr int IT_RPY = 1, IT_JOINT = IT_RPY + 3, IT_R0 = IT_JOINT + NJ,
                IT_BASE = IT_R0 + 9, IT_REF = IT_BASE + 3, IT_TOPO = IT_REF + 6,
                IT_DESC = IT_TOPO + TP_SIZE, IT_LOAD = IT_DESC + NJ;
  QWBC_FOR(it, IT_LOAD) {
    if (it == 0) {
      // the reference-update bookkeeping: a new reference publishes its
      // contacts and raises the switch flag if they changed; between
      // references both are held
      const bool is_new = flag(I_REFNEW)[sb * refnew_stride] != 0;
      bool changed = false;
      for (int f = 0; f < NL; ++f)
        changed = changed || (in(I_RCON)[sb * NL + f] != in(I_PREVC)[sb * NL + f]);
      const bool sw = is_new ? changed : (flag(I_SWFLAG)[sb] != 0);
      for (int f = 0; f < NL; ++f) {
        const T c = is_new ? in(I_RCON)[sb * NL + f] : in(I_PREVC)[sb * NL + f];
        S.con[f] = c;
        if (full) out(O_PREVC)[sb * NL + f] = c;
      }
      if (full) {
        static_cast<unsigned char*>(a.p[O_SWFLAG])[sb] = sw ? 1 : 0;
        static_cast<unsigned char*>(a.p[O_DVALID])[sb] = 1;
      }
      S.gate = (sw || flag(I_DERIVV)[sb] == 0) ? T(0) : T(1);
      S.dropd = sw ? 1 : 0;
    } else if (it < IT_JOINT) {
      const T* R = in(I_R0) + sb * 9;
      if (it == IT_RPY) S.rpy[0] = atan2(R[7], R[8]);
      else if (it == IT_RPY + 1) S.rpy[1] = atan2(-R[6], sqrt(R[7] * R[7] + R[8] * R[8]));
      else S.rpy[2] = atan2(R[3], R[0]);
    } else if (it < IT_R0) {
      const int i = it - IT_JOINT;
      const T q = in(I_Q)[sb * NJ + i];
      S.sq[i] = sin(q);
      S.cq[i] = cos(q);
      S.u18[6 + i] = in(I_QD)[sb * NJ + i];
      S.spos[i] = in(I_SPOS)[sb * 12 + i];
      S.svel[i] = in(I_SVEL)[sb * 12 + i];
      S.sacc[i] = in(I_SACC)[sb * 12 + i];
    } else if (it < IT_BASE) {
      S.R[0][it - IT_R0] = in(I_R0)[sb * 9 + it - IT_R0];
    } else if (it < IT_REF) {
      const int i = it - IT_BASE;
      S.p[0][i] = in(I_P0)[sb * 3 + i];
      S.w[0][i] = in(I_BV)[sb * 6 + 3 + i];
      S.al[0][i] = T(0);
      S.ao[0][i] = T(0);
    } else if (it < IT_TOPO) {
      const int i = it - IT_REF;
      S.u18[i] = in(I_BV)[sb * 6 + i];
      S.rpose[i] = in(I_RPOSE)[sb * 6 + i];
      S.rvel[i] = in(I_RVEL)[sb * 6 + i];
      S.racc[i] = in(I_RACC)[sb * 6 + i];
      S.integ[i] = in(I_INTEG)[sb * 6 + i];
    } else if (it < IT_DESC) {
      S.tp[it - IT_TOPO] = tp_in[it - IT_TOPO];
    } else {
      const int j = it - IT_DESC;
      unsigned m = 0;
      for (int bb = 1; bb < NB; ++bb) m |= (unsigned)((tp_in[TP_ANC + bb] >> j) & 1) << bb;
      S.desc[j] = m;
    }
  }
  if constexpr (EXACT) {   // the base's tangents: skew(omega) R0 and v
    QWBC_FOR(i, 9) {
      const int row = i / 3, col = i % 3;
      T om_sk[9];
      skew3(in(I_BV) + sb * 6 + 3, om_sk);
      const T* R = in(I_R0) + sb * 9;
      G->R[0][i] = om_sk[3 * row] * R[col] + om_sk[3 * row + 1] * R[3 + col]
                   + om_sk[3 * row + 2] * R[6 + col];
    }
    QWBC_FOR(i, 3) G->p[0][i] = in(I_BV)[sb * 6 + i];
  }
  QWBC_SYNC();
  if constexpr (STOP == STOP_INPUTS) {   // R0, p0, [v; qd], sin, cos, contacts, switch
    const T swf = S.dropd ? T(1) : T(0);
    return write_checksum(com_out, part(S.R[0], 9), part(S.p[0], 3), part(S.u18, NV),
                                   part(S.sq, NJ), part(S.cq, NJ), part(S.con, NL),
                                   part(&swf, 1));
  }

  // ---- stages: forward kinematics and the velocity-product recursion,
  // one tree level at a time (the bodies of a level are independent) ----
  for (int lev = 1; lev <= S.tp[TP_MAXDEPTH]; ++lev) {
    QWBC_FOR(bb, NB) {
      if (depth[bb] != lev) continue;
      const int j = bb - 1, pb = parent[bb];
      const T* c = cj(j);
      const T s = S.sq[j], c1 = T(1) - S.cq[j], qdj = S.u18[6 + j];
      T N[9];
      for (int k = 0; k < 9; ++k)
        N[k] = c[CJ_M0 + k] + s * c[CJ_M1 + k] + c1 * c[CJ_M2 + k];
      const T* Rp = S.R[pb];
      mm3(Rp, N, S.R[bb]);
      T rl[3], t1[3], t2[3];
      for (int i = 0; i < 3; ++i) {
        S.p[bb][i] = S.p[pb][i] + mv3_row(Rp, i, c + CJ_P);
        S.axw[j][i] = mv3_row(Rp, i, c + CJ_AX);
        rl[i] = S.p[bb][i] - S.p[pb][i];
      }
      cross3(S.al[pb], rl, t1);
      cross3(S.w[pb], rl, t2);
      T t3[3];
      cross3(S.w[pb], t2, t3);
      cross3(S.w[pb], S.axw[j], t2);
      for (int i = 0; i < 3; ++i) {
        S.ao[bb][i] = S.ao[pb][i] + t1[i] + t3[i];
        S.w[bb][i] = S.w[pb][i] + qdj * S.axw[j][i];
        S.al[bb][i] = S.al[pb][i] + qdj * t2[i];
      }
      if constexpr (EXACT) {
        // dR = dR_parent N + R_parent dN, dN = cos(q) qd M1 + sin(q) qd M2
        const T sd = S.cq[j] * qdj, cd = S.sq[j] * qdj;
        T dN[9], a1[9], a2[9];
        for (int k = 0; k < 9; ++k) dN[k] = sd * c[CJ_M1 + k] + cd * c[CJ_M2 + k];
        const T* dRp = G->R[pb];
        mm3(dRp, N, a1);
        mm3(Rp, dN, a2);
        for (int k = 0; k < 9; ++k) G->R[bb][k] = a1[k] + a2[k];
        for (int i = 0; i < 3; ++i) {
          G->p[bb][i] = G->p[pb][i] + mv3_row(dRp, i, c + CJ_P);
          G->axw[j][i] = mv3_row(dRp, i, c + CJ_AX);
        }
      }
    }
    QWBC_SYNC();
  }

  // ---- stage: body centres of mass, world inertias R I R^T ----
  QWBC_FOR(i, NB * 3) {
    const int bb = i / 3, k = i % 3;
    const T v = S.p[bb][k] + mv3_row(S.R[bb], k, cb(bb) + CB_COM);
    S.cw[bb][k] = v;
    S.r[bb][k] = v - S.p[0][k];
  }
  QWBC_FOR(i, NB * 9) {
    const int bb = i / 9, row = (i % 9) / 3, jr = i % 3;
    const T* I = cb(bb) + CB_INERTIA;
    const T* R = S.R[bb];
    T acc = T(0);
    for (int k = 0; k < 3; ++k) {
      const T a1 = R[3 * row] * I[k] + R[3 * row + 1] * I[3 + k] + R[3 * row + 2] * I[6 + k];
      acc += a1 * R[3 * jr + k];
    }
    S.Iw[bb][3 * row + jr] = acc;
  }
  if constexpr (EXACT) {
    QWBC_FOR(i, NB * 3) {
      const int bb = i / 3, k = i % 3;
      const T v = G->p[bb][k] + mv3_row(G->R[bb], k, cb(bb) + CB_COM);
      G->cw[bb][k] = v;
      G->r[bb][k] = v - G->p[0][k];
    }
    QWBC_FOR(i, NB * 9) {   // dR I R^T + R I dR^T
      const int bb = i / 9, row = (i % 9) / 3, jr = i % 3;
      const T* I = cb(bb) + CB_INERTIA;
      const T *R = S.R[bb], *dR = G->R[bb];
      T acc = T(0);
      for (int k = 0; k < 3; ++k) {
        const T a1 = R[3 * row] * I[k] + R[3 * row + 1] * I[3 + k] + R[3 * row + 2] * I[6 + k];
        const T d1 = dR[3 * row] * I[k] + dR[3 * row + 1] * I[3 + k] + dR[3 * row + 2] * I[6 + k];
        acc += d1 * R[3 * jr + k] + a1 * dR[3 * jr + k];
      }
      G->Iw[bb][3 * row + jr] = acc;
    }
  }
  QWBC_SYNC();
  if constexpr (STOP == STOP_FK) {   // R (bodies 1..), p, body centres of mass, axes
    return write_checksum(com_out, part(S.R[1], (NB - 1) * 9), part(S.p[0], NB * 3),
                                   part(S.cw[0], NB * 3), part(S.axw[0], NJ * 3));
  }

  // ---- stage: Jacobian parts, centre of mass ----
  QWBC_FOR(i, NB * NJ) {
    const int bb = i / NJ, j = i % NJ;
    T v[3] = {T(0), T(0), T(0)};
    if (moves(bb, j)) {
      const T dlt[3] = {S.cw[bb][0] - S.p[j + 1][0], S.cw[bb][1] - S.p[j + 1][1],
                        S.cw[bb][2] - S.p[j + 1][2]};
      cross3(S.axw[j], dlt, v);
    }
    for (int k = 0; k < 3; ++k) S.jq[bb][j][k] = v[k];
  }
  QWBC_FOR(k, 3) {
    T acc = S.cw[0][k] * cb(0)[CB_WM];
    for (int bb = 1; bb < NB; ++bb) acc += S.cw[bb][k] * cb(bb)[CB_WM];
    S.com[k] = acc;
    S.dcom[k] = acc - S.p[0][k];
    if (full) {
      out(O_COM)[sb * 3 + k] = acc;
      out(O_POSE)[sb * 6 + k] = acc;
      out(O_POSE)[sb * 6 + 3 + k] = S.rpy[k];
    }
  }
  if constexpr (EXACT) {
    QWBC_FOR(k, 3) {
      T acc = G->cw[0][k] * cb(0)[CB_WM];
      for (int bb = 1; bb < NB; ++bb) acc += G->cw[bb][k] * cb(bb)[CB_WM];
      G->com[k] = acc;
      G->dcom[k] = acc - G->p[0][k];
    }
  }
  QWBC_SYNC();

  // ---- stage: centre-of-mass velocity, body forces / moments, Iw axw;
  // the heavy items first, each on a thread of its own ----
  QWBC_FOR(it, 3 + NB + NB * NJ) {
    int i = it;
    if (i < 3) {
      const int k = i;
      const T* om = S.u18 + 3;
      T acc = T(0);
      for (int bb = 0; bb < NB; ++bb) {
        T vb = S.u18[k] + cross_k(om, S.r[bb], k);
        for (unsigned m = (unsigned)anc[bb]; m; m &= m - 1) {   // the joints moving bb
          const int j = lowest_bit(m);
          vb += S.u18[6 + j] * S.jq[bb][j][k];
        }
        acc += vb * cb(bb)[CB_WM];
      }
      S.cvel[k] = acc;
      S.cvel[3 + k] = om[k];
    } else if ((i -= 3) < NB) {
      const int bb = i;
      T dcb[3], t1[3], t2[3], t3[3], Iw_w[3];
      for (int k = 0; k < 3; ++k) dcb[k] = S.cw[bb][k] - S.p[bb][k];
      cross3(S.al[bb], dcb, t1);
      cross3(S.w[bb], dcb, t2);
      cross3(S.w[bb], t2, t3);
      for (int k = 0; k < 3; ++k) Iw_w[k] = mv3_row(S.Iw[bb], k, S.w[bb]);
      cross3(S.w[bb], Iw_w, t2);
      const T mass = cb(bb)[CB_MASS];
      for (int k = 0; k < 3; ++k) {
        S.F[bb][k] = (S.ao[bb][k] + t1[k] + t3[k]) * mass;
        S.Nb[bb][k] = mv3_row(S.Iw[bb], k, S.al[bb]) + t2[k];
      }
    } else {
      i -= NB;
      const int bb = i / NJ, j = i % NJ;
      const bool mv = moves(bb, j);
      for (int k = 0; k < 3; ++k)
        S.Iwa[bb][j][k] = mv ? mv3_row(S.Iw[bb], k, S.axw[j]) : T(0);
    }
  }
  QWBC_SYNC();
  if constexpr (STOP == STOP_JAC) {   // com velocity (6), com - p0, the Jacobian parts
    return write_checksum(com_out, part(S.cvel, 6), part(S.dcom, 3),
                                   part(S.jq[0][0], NB * NJ * 3));
  }

  // ---- stage: Coriolis bias, mass-matrix blocks, carried d(T^-1)/dt u
  // (exact mode: then the tangents of sum m r, the rotational block and
  // Mbj); the heavy items first.  A loop over the bodies a joint moves
  // visits them in rising order, as the loop over all bodies that skips the
  // rest ----
  constexpr int N_TDU = EXACT ? 0 : 6;
  QWBC_FOR(it, N_TDU + 9 + NV + 3 + 6 * NJ + NJ * NJ) {
    int i = it;
    if (i < N_TDU) {
      if constexpr (!EXACT) {  // the bias reads the CARRIED d(T^-1)/dt (one cycle stale)
        const T* row = in(I_TDINV) + sb * NV * NV + i * NV;
        T acc = T(0);
        for (int c = 0; c < NV; ++c) acc += row[c] * S.u18[c];
        S.tdu[i] = acc;
      }
    } else if ((i -= N_TDU) < 9) {   // sum m (|r|^2 I - r r^T) + sum Iw
      const int row = i / 3, col = i % 3;
      T acc = T(0), dg = T(0);
      for (int bb = 0; bb < NB; ++bb) {
        const T mass = cb(bb)[CB_MASS];
        acc += S.Iw[bb][i] - S.r[bb][row] * S.r[bb][col] * mass;
        dg += dot3(S.r[bb], S.r[bb]) * mass;
      }
      S.rot[i] = (row == col) ? acc + dg : acc;
    } else if ((i -= 9) < NV) {
      T acc = T(0);
      if (i < 3) {
        for (int bb = 0; bb < NB; ++bb) acc += S.F[bb][i];
      } else if (i < 6) {
        for (int bb = 0; bb < NB; ++bb)
          acc += cross_k(S.r[bb], S.F[bb], i - 3) + S.Nb[bb][i - 3];
      } else {
        const int j = i - 6;
        for (unsigned m = S.desc[j]; m; m &= m - 1) {
          const int bb = lowest_bit(m);
          acc += dot3(S.jq[bb][j], S.F[bb]) + dot3(S.axw[j], S.Nb[bb]);
        }
      }
      S.hcor[i] = acc;
    } else if ((i -= NV) < 3) {
      const int k = i;
      T acc = T(0);
      for (int bb = 0; bb < NB; ++bb) acc += S.r[bb][k] * cb(bb)[CB_MASS];
      S.mr[k] = acc;
    } else if ((i -= 3) < 6 * NJ) {
      const int row = i / NJ, j = i % NJ;
      T acc = T(0);
      for (unsigned m = S.desc[j]; m; m &= m - 1) {
        const int bb = lowest_bit(m);
        const T mass = cb(bb)[CB_MASS];
        // one rounding, as the previous kernel's compiler fused it (nvcc
        // would multiply apart here, behind a select of the two branches)
        if (row < 3)
          acc = fmadd(S.jq[bb][j][row], mass, acc);
        else
          acc += cross_k(S.r[bb], S.jq[bb][j], row - 3) * mass + S.Iwa[bb][j][row - 3];
      }
      S.Mbj[row][j] = acc;
    } else {
      i -= 6 * NJ;
      const int j = i / NJ, k = i % NJ;
      T acc = T(0);
      for (unsigned m = S.desc[j] & S.desc[k]; m; m &= m - 1) {
        const int bb = lowest_bit(m);
        acc += dot3(S.jq[bb][j], S.jq[bb][k]) * cb(bb)[CB_MASS]
               + dot3(S.axw[j], S.Iwa[bb][k]);
      }
      S.Mjj[j][k] = acc;
    }
  }
  if constexpr (EXACT) {   // the tangents of sum m r, the rotational block and Mbj
    QWBC_FOR(k, 3) {
      T acc = T(0);
      for (int bb = 0; bb < NB; ++bb) acc += G->r[bb][k] * cb(bb)[CB_MASS];
      G->mr[k] = acc;
    }
    QWBC_FOR(i, 9) {
      const int row = i / 3, col = i % 3;
      T acc = T(0), dg = T(0);
      for (int bb = 0; bb < NB; ++bb) {
        const T mass = cb(bb)[CB_MASS];
        acc += G->Iw[bb][i]
               - (G->r[bb][row] * S.r[bb][col] + S.r[bb][row] * G->r[bb][col]) * mass;
        dg += T(2) * dot3(S.r[bb], G->r[bb]) * mass;
      }
      G->rot[i] = (row == col) ? acc + dg : acc;
    }
    QWBC_FOR(i, 6 * NJ) {
      const int row = i / NJ, j = i % NJ;
      T acc = T(0);
      for (int bb = 1; bb < NB; ++bb) {
        if (!moves(bb, j)) continue;
        const T mass = cb(bb)[CB_MASS];
        // d/dt jq = daxw x (cw - o_j) + axw x (dcw - do_j)
        const T dl[3] = {S.cw[bb][0] - S.p[j + 1][0], S.cw[bb][1] - S.p[j + 1][1],
                         S.cw[bb][2] - S.p[j + 1][2]};
        const T tdl[3] = {G->cw[bb][0] - G->p[j + 1][0], G->cw[bb][1] - G->p[j + 1][1],
                          G->cw[bb][2] - G->p[j + 1][2]};
        T tjq[3];
        for (int k = 0; k < 3; ++k)
          tjq[k] = cross_k(G->axw[j], dl, k) + cross_k(S.axw[j], tdl, k);
        if (row < 3) {
          acc += tjq[row] * mass;
        } else {
          const int k = row - 3;
          const T tiwa = mv3_row(G->Iw[bb], k, S.axw[j]) + mv3_row(S.Iw[bb], k, G->axw[j]);
          acc += (cross_k(G->r[bb], S.jq[bb][j], k) + cross_k(S.r[bb], tjq, k)) * mass + tiwa;
        }
      }
      G->Mbj[row][j] = acc;
    }
  }
  QWBC_SYNC();
  if constexpr (STOP == STOP_RECURSION) {   // the Coriolis bias, world inertias
    return write_checksum(com_out, part(S.hcor, NV), part(S.Iw[0], NB * 9));
  }

  // ---- stage: Mb and its inverse by the 3x3 Schur complement of m I ----
  QWBC_FOR(one, 1) {
    const T m_tot = sc[SC_MTOT], inv_m = sc[SC_INV_M];
    T sk[9], skT[9], S3[9], S3i[9], WS[9], TL[9], t[9];
    skew3(S.mr, sk);
    for (int i = 0; i < 3; ++i)
      for (int l = 0; l < 3; ++l) skT[3 * i + l] = sk[3 * l + i];
    for (int i = 0; i < 3; ++i)
      for (int l = 0; l < 3; ++l) {
        S.Mb[i][l] = (i == l) ? m_tot : T(0);
        S.Mb[i][3 + l] = -sk[3 * i + l];
        S.Mb[3 + i][l] = sk[3 * i + l];
        S.Mb[3 + i][3 + l] = S.rot[3 * i + l];
      }
    mm3(sk, sk, t);
    for (int k = 0; k < 9; ++k) S3[k] = S.rot[k] + t[k] * inv_m;
    inv3(S3, S3i);
    mm3(sk, S3i, t);
    for (int k = 0; k < 9; ++k) WS[k] = t[k] * (-inv_m);
    mm3(WS, skT, t);
    for (int k = 0; k < 9; ++k) TL[k] = t[k] * (-inv_m);
    for (int k = 0; k < 3; ++k) TL[4 * k] += m_tot * sc[SC_INV_M2];
    for (int i = 0; i < 3; ++i)
      for (int l = 0; l < 3; ++l) {
        S.Mbi[i][l] = TL[3 * i + l];
        S.Mbi[i][3 + l] = -WS[3 * i + l];
        S.Mbi[3 + i][l] = -WS[3 * l + i];
        S.Mbi[3 + i][3 + l] = S3i[3 * i + l];
      }
  }
  if constexpr (EXACT) {
    QWBC_FOR(i, 36) {     // dMb = [[0, -skew(dmr)], [skew(dmr), drot]]
      const int p = i / 6, l = i % 6;
      T v;
      if (p < 3)
        v = (l < 3) ? T(0) : neg_skew(G->mr, p, l - 3);
      else
        v = (l < 3) ? -neg_skew(G->mr, p - 3, l) : G->rot[3 * (p - 3) + l - 3];
      G->Mb[p][l] = v;
    }
  }
  QWBC_SYNC();

  // ---- stages: X = Mb^-1 Mbj with one refinement pass ----
  QWBC_FOR(i, 6 * NJ) {
    const int p = i / NJ, j = i % NJ;
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc += S.Mbi[p][k] * S.Mbj[k][j];
    S.X0[p][j] = acc;
  }
  QWBC_SYNC();
  QWBC_FOR(i, 6 * NJ) {
    const int p = i / NJ, j = i % NJ;
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc += S.Mb[p][k] * S.X0[k][j];
    S.Xr[p][j] = S.Mbj[p][j] - acc;
  }
  QWBC_SYNC();
  QWBC_FOR(i, 6 * NJ) {
    const int p = i / NJ, j = i % NJ;
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc += S.Mbi[p][k] * S.Xr[k][j];
    S.X[p][j] = S.X0[p][j] + acc;
  }
  QWBC_SYNC();
  if constexpr (STOP == STOP_MASS) {   // X, Mjj, Mb^-1, Mbj
    return write_checksum(com_out, part(S.X[0], 6 * NJ), part(S.Mjj[0], NJ * NJ),
                                   part(S.Mbi[0], 36), part(S.Mbj[0], 6 * NJ));
  }

  if constexpr (EXACT) {
    // ---- stages: the exact d(T^-1)/dt and the bias term it feeds, before
    // the bias is formed: dX = Mb^-1 (dMbj - dMb X), then Tdot's top rows
    // d/dt [adj^-1 | adj^-1 X] ----
    QWBC_FOR(i, 6 * NJ) {
      const int p = i / NJ, j = i % NJ;
      T acc = T(0);
      for (int k = 0; k < 6; ++k) {
        T r = G->Mbj[k][j];
        for (int l = 0; l < 6; ++l) r -= G->Mb[k][l] * S.X[l][j];
        acc += S.Mbi[p][k] * r;
      }
      G->X[p][j] = acc;
    }
    QWBC_SYNC();
    QWBC_FOR(i, 6 * NV) {
      const int p = i / NV, c = i % NV;
      T v = T(0);
      if (c < 6) {
        if (p < 3 && c >= 3) v = neg_skew(G->dcom, p, c - 3);
      } else {
        const int j = c - 6;
        v = G->X[p][j];
        if (p < 3) {
          const T xb[3] = {S.X[3][j], S.X[4][j], S.X[5][j]};
          const T txb[3] = {G->X[3][j], G->X[4][j], G->X[5][j]};
          v -= cross_k(G->dcom, xb, p) + cross_k(S.dcom, txb, p);
        }
      }
      S.Td[p][c] = v;
    }
    QWBC_SYNC();
    QWBC_FOR(c, NV) adj_tdot_col(S, c);
    QWBC_SYNC();
    QWBC_FOR(i, 6 * NV) G->tdi[i / NV][i % NV] = tdinv_entry(S, i / NV, i % NV);
    QWBC_SYNC();
    QWBC_FOR(i, 6) {      // the bias reads the FRESH d(T^-1)/dt
      T acc = T(0);
      for (int c = 0; c < NV; ++c) acc += G->tdi[i][c] * S.u18[c];
      S.tdu[i] = acc;
    }
    QWBC_SYNC();
  }

  // ---- stage: Mb X, centroidal base block, T top rows, bias before the
  // projection, foot kinematics and centroidal foot Jacobians, the heavy
  // items first; exact mode: then the foot Jacobians' tangents ----
  QWBC_FOR(it, NL * NV + NV + 36 + 6 * NJ + 6 * NV) {
    int i = it;
    if (i < NL * NV) {
      const int f = i / NV, c = i % NV, fb = foot_body[f];
      const T* fp = mc + MC_FOOT + 3 * f;
      T pf[3];
      for (int k = 0; k < 3; ++k) pf[k] = S.p[fb][k] + mv3_row(S.R[fb], k, fp);
      if (c < 3) {
        // foot position and velocity ride on the first three items
        const T rel[3] = {pf[0] - S.p[0][0], pf[1] - S.p[0][1], pf[2] - S.p[0][2]};
        T vf = S.u18[c] + cross_k(S.u18 + 3, rel, c);
        for (unsigned m = (unsigned)anc[fb]; m; m &= m - 1) {   // the joints moving fb
          const int j = lowest_bit(m);
          const T dl[3] = {pf[0] - S.p[j + 1][0], pf[1] - S.p[j + 1][1],
                           pf[2] - S.p[j + 1][2]};
          vf += S.u18[6 + j] * cross_k(S.axw[j], dl, c);
        }
        S.fpos[3 * f + c] = pf[c];
        S.fvel[3 * f + c] = vf;
        if (full) out(O_FPOS)[sb * 12 + 3 * f + c] = pf[c];
        for (int k = 0; k < 3; ++k) S.Jcf[f][k][c] = (k == c) ? T(1) : T(0);
      } else if (c < 6) {   // -skew(p_f - com), column c - 3
        const T rc[3] = {pf[0] - S.com[0], pf[1] - S.com[1], pf[2] - S.com[2]};
        for (int k = 0; k < 3; ++k) S.Jcf[f][k][c] = neg_skew(rc, k, c - 3);
      } else {              // joint part: jq_f - [I | -skew(p_f - p_0)] X
        const int j = c - 6;
        const T rel[3] = {pf[0] - S.p[0][0], pf[1] - S.p[0][1], pf[2] - S.p[0][2]};
        const T xb[3] = {S.X[3][j], S.X[4][j], S.X[5][j]};
        T col[3];
        for (int k = 0; k < 3; ++k) col[k] = -(S.X[k][j] - cross_k(rel, xb, k));
        if (moves(fb, j)) {
          const T dl[3] = {pf[0] - S.p[j + 1][0], pf[1] - S.p[j + 1][1],
                           pf[2] - S.p[j + 1][2]};
          for (int k = 0; k < 3; ++k) col[k] += cross_k(S.axw[j], dl, k);
        }
        for (int k = 0; k < 3; ++k) S.Jcf[f][k][c] = col[k];
      }
    } else if ((i -= NL * NV) < NV) {
      // h_cor + M (d(T^-1)/dt u)
      T acc = T(0);
      if (i < 6)
        for (int k = 0; k < 6; ++k) acc += S.Mb[i][k] * S.tdu[k];
      else
        for (int k = 0; k < 6; ++k) acc += S.Mbj[k][i - 6] * S.tdu[k];
      S.hMT[i] = S.hcor[i] + acc;
    } else if ((i -= NV) < 36) {
      // Mc_base = adj^T (Mb adj), adj = [[I, skew(dcom)], [0, I]]
      const int p = i / 6, c = i % 6;
      T v = adj_right(S.Mb[p], S.dcom, c);
      if (p >= 3) {
        const T top[3] = {adj_right(S.Mb[0], S.dcom, c), adj_right(S.Mb[1], S.dcom, c),
                          adj_right(S.Mb[2], S.dcom, c)};
        v -= cross_k(S.dcom, top, p - 3);
      }
      S.Mcb[p][c] = v;
    } else if ((i -= 36) < 6 * NJ) {
      const int p = i / NJ, j = i % NJ;
      T acc = T(0);
      for (int k = 0; k < 6; ++k) acc += S.Mb[p][k] * S.X[k][j];
      S.MbX[p][j] = acc;
    } else {
      i -= 6 * NJ;
      // T top rows = [adj^-1 | adj^-1 X]
      const int p = i / NV, c = i % NV;
      T v;
      if (c < 6) {
        v = (c == p) ? T(1) : T(0);
        if (p < 3 && c >= 3) v = neg_skew(S.dcom, p, c - 3);
      } else {
        const int j = c - 6;
        v = S.X[p][j];
        if (p < 3) {
          const T xb[3] = {S.X[3][j], S.X[4][j], S.X[5][j]};
          v -= cross_k(S.dcom, xb, p);
        }
      }
      S.Ttop[p][c] = v;
    }
  }
  if constexpr (EXACT) {  // the foot Jacobians' tangents, term by term
    QWBC_FOR(i, NL * NV) {
      const int f = i / NV, c = i % NV, fb = foot_body[f];
      const T* fp = mc + MC_FOOT + 3 * f;
      T pf[3], tpf[3], col[3];
      for (int k = 0; k < 3; ++k) {
        pf[k] = S.p[fb][k] + mv3_row(S.R[fb], k, fp);
        tpf[k] = G->p[fb][k] + mv3_row(G->R[fb], k, fp);
      }
      if (c < 3) {
        for (int k = 0; k < 3; ++k) col[k] = T(0);
      } else if (c < 6) {   // d/dt -skew(p_f - com)
        const T trc[3] = {tpf[0] - G->com[0], tpf[1] - G->com[1], tpf[2] - G->com[2]};
        for (int k = 0; k < 3; ++k) col[k] = neg_skew(trc, k, c - 3);
      } else {
        const int j = c - 6;
        const T rel[3] = {pf[0] - S.p[0][0], pf[1] - S.p[0][1], pf[2] - S.p[0][2]};
        const T trel[3] = {tpf[0] - G->p[0][0], tpf[1] - G->p[0][1], tpf[2] - G->p[0][2]};
        const T xb[3] = {S.X[3][j], S.X[4][j], S.X[5][j]};
        const T txb[3] = {G->X[3][j], G->X[4][j], G->X[5][j]};
        for (int k = 0; k < 3; ++k)
          col[k] = -(G->X[k][j] - cross_k(trel, xb, k) - cross_k(rel, txb, k));
        if (moves(fb, j)) {
          const T dl[3] = {pf[0] - S.p[j + 1][0], pf[1] - S.p[j + 1][1],
                           pf[2] - S.p[j + 1][2]};
          const T tdl[3] = {tpf[0] - G->p[j + 1][0], tpf[1] - G->p[j + 1][1],
                            tpf[2] - G->p[j + 1][2]};
          for (int k = 0; k < 3; ++k)
            col[k] += cross_k(G->axw[j], dl, k) + cross_k(S.axw[j], tdl, k);
        }
      }
      for (int k = 0; k < 3; ++k) G->Jf[f][k][c] = col[k];
    }
  }
  QWBC_SYNC();

  // ---- stage: centroidal joint block, centroidal bias, finite differences
  // of T and of the masked foot Jacobians with their rows of A, l, u, the
  // desired wrench ----
  // the items of a section before those of the next, so that a probe runs
  // a prefix: h_c and Mc_jj (centroidal), T and the J rows (foot)
  constexpr int N_CENTROIDAL = NV + NJ * NJ, N_FOOT = N_CENTROIDAL + NV * NV + 2 * 12;
  constexpr int N_ITEMS = STOP == STOP_CENTROIDAL ? N_CENTROIDAL
                          : STOP == STOP_FOOT     ? N_FOOT
                                                  : N_FOOT + 6;
  QWBC_FOR(it, N_ITEMS) {
    int i = it;
    if (i < NV) {
      T v = S.hMT[i];
      if (i >= 3 && i < 6) {
        v -= cross_k(S.dcom, S.hMT, i - 3);
      } else if (i >= 6) {
        T acc = T(0);
        for (int k = 0; k < 6; ++k) acc += S.X[k][i - 6] * S.hMT[k];
        v -= acc;
      }
      S.hc[i] = v;
      if (full) out(O_HC)[sb * NV + i] = v;
    } else if ((i -= NV) < NJ * NJ) {
      const int r = i / NJ, j = i % NJ;
      T s1 = T(0), s2 = T(0), s3 = T(0);
      for (int k = 0; k < 6; ++k) {
        s1 += S.Mbj[k][r] * S.X[k][j];
        s2 += S.X[k][r] * S.Mbj[k][j];
        s3 += S.X[k][r] * S.MbX[k][j];
      }
      const T v = S.Mjj[r][j] - s1 - s2 + s3;
      S.A[34 + r][6 + j] = v;
      if (full) out(O_MCJJ)[sb * NJ * NJ + i] = v;
    } else if ((i -= NJ * NJ) < NV * NV) {
      // the new T (bottom rows [0 I]) and its difference
      const int p = i / NV, c = i % NV;
      T v = (p == c) ? T(1) : T(0);
      if (p < 6) {
        v = S.Ttop[p][c];
        if constexpr (!EXACT)
          S.Td[p][c] = S.gate * (v - in(I_OLD_T)[sb * NV * NV + i]) * sc[SC_INV_DT];
      }
      if (full) out(O_T)[sb * NV * NV + i] = v;
    } else if ((i -= NV * NV) < 2 * 12) {
      // one row of J_st (kind 0) or J_sw (kind 1): mask, store, difference
      // against the carried row, and the row's right-hand side
      const int kind = i / 12, row = i % 12, f = row / 3, k = row % 3;
      const T scale = kind == 0 ? S.con[f] : T(1) - S.con[f];
      const T* old = in(kind == 0 ? I_OLD_JST : I_OLD_JSW) + sb * 12 * NV + row * NV;
      T* keep = out(kind == 0 ? O_JST : O_JSW) + sb * 12 * NV + row * NV;
      T acc = T(0);
      for (int c = 0; c < NV; ++c) {
        const T v = S.Jcf[f][k][c] * scale;
        if (full) keep[c] = v;
        if (kind == 0) {
          S.A[6 + row][c] = v;
        } else {
          S.A[46 + row][c] = v;
          S.A[58 + row][c] = v;
        }
        T jd;
        if constexpr (EXACT)
          jd = G->Jf[f][k][c] * scale;      // contacts held within the linearization
        else
          jd = S.gate * (v - old[c]) * sc[SC_INV_DT];
        acc += jd * (c < 6 ? S.cvel[c] : S.u18[c]);
      }
      if (kind == 0) {
        const T rhs = -acc;                 // one value, stored to both sides
        S.l[6 + row] = rhs;
        S.u[6 + row] = rhs;
      } else {
        T a_cmd = S.sacc[row] + sc[SC_KD_SWING] * (S.svel[row] - S.fvel[row])
                  + sc[SC_KP_SWING] * (S.spos[row] - S.fpos[row]);
        a_cmd = a_cmd * (T(1) - S.con[f]);
        const T rhs = a_cmd - acc;
        S.u[46 + row] = rhs;
        S.l[46 + row] = -sc[SC_INF];
        S.l[58 + row] = rhs;
        S.u[58 + row] = sc[SC_INF];
      }
    } else {
      i -= 2 * 12;
      const T pose = (i < 3) ? S.com[i] : S.rpy[i - 3];
      const T err = pose - S.rpose[i];
      T acc = T(0);
      for (int k = 0; k < 6; ++k) acc += S.Mcb[i][k] * S.racc[k];
      const T grav = (i == 2) ? sc[SC_MG] : T(0);
      S.wdes[i] = -sc[SC_KP + i] * err - sc[SC_KD] * (S.cvel[i] - S.rvel[i])
                  - sc[SC_KI] * S.integ[i] + grav + acc;
      if (full) out(O_INTEG)[sb * 6 + i] = S.integ[i] + err * sc[SC_DT];
      const T eq = -grav;                   // one value, stored to both sides
      S.l[i] = eq;
      S.u[i] = eq;
    }
  }
  if constexpr (STOP == STOP_CENTROIDAL) {   // h_c, Mc_jj, Mc_base
    QWBC_SYNC();
    return write_checksum(com_out, part(S.hc, NV), part(&S.A[34][6], NJ * NJ, NJ, SN),
                                   part(S.Mcb[0], 36));
  }
  // the masked foot Jacobians, the foot positions and velocities
  if constexpr (STOP == STOP_FOOT) {
    QWBC_SYNC();
    return write_checksum(com_out, part(S.A[6], 12 * NV, NV, SN),
                                   part(S.A[46], 12 * NV, NV, SN), part(S.fpos, 12),
                                   part(S.fvel, 12));
  }
  QWBC_SYNC();

  // ---- stage: the rest of A, H, g, l, u; d(T^-1)/dt, first half ----
  QWBC_FOR(i, 36) S.A[i / 6][i % 6] = S.Mcb[i / 6][i % 6];
  QWBC_FOR(i, 6 * 12) {   // -J_st,com^T
    const int p = i / 12, r = i % 12;
    S.A[p][18 + r] = -S.A[6 + r][p];
  }
  QWBC_FOR(i, 12 * 12) {  // -J_st,j^T, and J_st,j for the torque map
    const int p = i / 12, r = i % 12;
    S.A[34 + p][18 + r] = -S.A[6 + r][6 + p];
    if (full) out(O_JSTJ)[sb * 144 + i] = S.A[6 + p][6 + r];
  }
  QWBC_FOR(i, 16) {       // friction pyramid, contact-masked
    const int f = i / 4, k = i % 4;
    const T c = S.con[f], mu = sc[SC_MU];
    T* row = &S.A[18 + i][18 + 3 * f];
    row[0] = (k == 0) ? c : (k == 1) ? -c : T(0);
    row[1] = (k == 2) ? c : (k == 3) ? -c : T(0);
    row[2] = -mu * c;
    S.u[18 + i] = T(0);
    S.l[18 + i] = -sc[SC_INF];
  }
  QWBC_FOR(i, 12) {
    S.A[46 + i][30 + i] = T(-1);
    S.A[58 + i][30 + i] = T(1);
    S.u[34 + i] = sc[SC_TAU_MAX] - S.hc[6 + i];
    S.l[34 + i] = -sc[SC_TAU_MAX] - S.hc[6 + i];
  }
  QWBC_FOR(i, 12 * 12) {  // H block = J_st,com J_st,com^T + I
    const int p = i / 12, r = i % 12;
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc += S.A[6 + p][k] * S.A[6 + r][k];
    S.Hb[p][r] = (p == r) ? acc + T(1) : acc;
  }
  QWBC_FOR(i, NQ) {
    T gv = T(0);
    if (i >= 18 && i < 30) {
      for (int k = 0; k < 6; ++k) gv += S.A[6 + i - 18][k] * S.wdes[k];
      gv = -gv;
    } else {
      S.Hd[i] = (i < 18) ? T(1) : sc[SC_SLACK_W];
    }
    S.g[i] = gv;
  }
  if constexpr (!EXACT) {
    QWBC_FOR(c, NV) adj_tdot_col(S, c);   // adj applied to the columns of dT/dt
  }
  QWBC_SYNC();
  if constexpr (STOP == STOP_FD) {   // the new d(T^-1)/dt, Jdot (stance, swing), T top rows
    auto tdi = [&](int i) {
      if constexpr (EXACT) return G->tdi[i / NV][i % NV];
      else return tdinv_entry(S, i / NV, i % NV);
    };
    auto jd = [&](int i) {   // as the J rows formed it: row r = i / NV of J_st, then J_sw
      const int r = i / NV, c = i % NV, kind = r / 12, row = r % 12;
      const int f = row / 3, k = row % 3;
      const T scale = kind == 0 ? S.con[f] : T(1) - S.con[f];
      if constexpr (EXACT) {
        return G->Jf[f][k][c] * scale;
      } else {
        const T old = in(kind == 0 ? I_OLD_JST : I_OLD_JSW)[sb * 12 * NV + row * NV + c];
        return S.gate * (S.Jcf[f][k][c] * scale - old) * sc[SC_INV_DT];
      }
    };
    return write_checksum(com_out, formed(6 * NV, tdi), formed(24 * NV, jd),
                          part(S.Ttop[0], 6 * NV));
  }

  // ---- stage: d(T^-1)/dt = -[adj D1 adj | adj (D2 - D1 X)], the unscaled
  // problem to device memory ----
  QWBC_FOR(i, NV * NV) {
    const int p = i / NV, c = i % NV;
    T v = T(0);
    if (p < 6) {
      if constexpr (EXACT)
        v = G->tdi[p][c];
      else
        v = tdinv_entry(S, p, c);
    }
    out(O_TDINV)[sb * NV * NV + i] = v;
  }
  QWBC_FOR(i, MQ * NQ) out(O_A)[sb * MQ * NQ + i] = S.A[i / NQ][i % NQ];
  const WbcH<T> H{S.Hd, &S.Hb[0][0]};
  QWBC_FOR(i, NQ * NQ) out(O_H)[sb * NQ * NQ + i] = H.at(i / NQ, i % NQ);
  QWBC_FOR(i, NQ) out(O_G)[sb * NQ + i] = S.g[i];
  QWBC_FOR(i, MQ) {
    out(O_L)[sb * MQ + i] = S.l[i];
    out(O_U)[sb * MQ + i] = S.u[i];
  }

  // ---- the fused prepare tail, on the A and H just assembled ----
  if (fused)
    prepare_tail(H, &S.A[0][0], SN, S.d[0], S.e[0], S.d[1], S.e[1],
                 S.g, S.l, S.u, in(I_WX) + sb * NQ, in(I_WZ) + sb * MQ,
                 in(I_WY) + sb * MQ, S.dropd != 0,
                 out(O_SH) + sb * NQ * NQ, out(O_SA) + sb * MQ * NQ,
                 out(O_SG) + sb * NQ, out(O_SL) + sb * MQ, out(O_SU) + sb * MQ,
                 out(O_RHO) + sb * MQ, out(O_WXS) + sb * NQ, out(O_WZS) + sb * MQ,
                 out(O_WYS) + sb * MQ, out(O_D) + sb * NQ, out(O_E) + sb * MQ,
                 NQ, MQ, sweeps, rho0, rho_eq);
}

// The probes (STOP > 0) are float32 only.  The nvcc build compiles this
// file twice: without QWBC_SETUP_SECTIONS the whole kernels and
// qwbc_setup_f32/f64, with it the sixteen probe kernels and
// qwbc_setup_sections_f32 alone (a second object, built beside the others);
// the host build compiles both halves in one.
#if defined(__CUDACC__) && defined(QWBC_SETUP_SECTIONS)
#define QWBC_SETUP_WHOLE 0
#define QWBC_SETUP_PROBES 1
#elif defined(__CUDACC__)
#define QWBC_SETUP_WHOLE 1
#define QWBC_SETUP_PROBES 0
#else
#define QWBC_SETUP_WHOLE 1
#define QWBC_SETUP_PROBES 1
#endif

struct SetupArgs {
  int B, refnew_stride, fused, sweeps;
};

#ifdef __CUDACC__

// shared memory a block: SetupShared, then in exact mode SetupTangents
// (float32: 21.4 + 3.6 KB; float64: 42.6 + 7.1 KB, above the 48 KB default)
template <typename T, bool EXACT>
constexpr size_t setup_smem() {
  return sizeof(SetupShared<T>) + (EXACT ? sizeof(SetupTangents<T>) : 0);
}

template <typename T, bool EXACT, int STOP>
__global__ void setup_kernel(SetupPtrs a, int refnew_stride, int fused,
                             int sweeps, T rho0, T rho_eq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SetupTangents<T>* G = EXACT ? reinterpret_cast<SetupTangents<T>*>(
                                    smem_raw + sizeof(SetupShared<T>))
                              : nullptr;
  setup_block<T, EXACT, STOP>(a, blockIdx.x, refnew_stride, fused, sweeps, rho0, rho_eq,
                              *reinterpret_cast<SetupShared<T>*>(smem_raw), G);
}

template <typename T, bool EXACT, int STOP>
int launch_setup_variant(const SetupPtrs& a, const SetupArgs& s, T rho0, T rho_eq,
                         void* stream) {
  constexpr size_t smem = setup_smem<T, EXACT>();
  if (int err = allow_shared_memory<setup_kernel<T, EXACT, STOP>>(smem)) return err;
  setup_kernel<T, EXACT, STOP><<<s.B, 128, smem, (cudaStream_t)stream>>>(
      a, s.refnew_stride, s.fused, s.sweeps, rho0, rho_eq);
  return (int)cudaGetLastError();
}

#else  // plain C++: one thread runs the blocks one after the other

template <typename T, bool EXACT, int STOP>
int launch_setup_variant(const SetupPtrs& a, const SetupArgs& s, T rho0, T rho_eq,
                         void*) {
  SetupShared<T>* S = new SetupShared<T>;
  SetupTangents<T>* G = EXACT ? new SetupTangents<T> : nullptr;
  for (int b = 0; b < s.B; ++b)
    setup_block<T, EXACT, STOP>(a, b, s.refnew_stride, s.fused, s.sweeps, rho0, rho_eq,
                                *S, G);
  delete G;
  delete S;
  return 0;
}

#endif

inline int invalid_value() {
#ifdef __CUDACC__
  return (int)cudaErrorInvalidValue;
#else
  return 1;
#endif
}

template <typename T>
int setup_table(const void* const* ptrs, int n_ptrs, int mc_len, int topo_len,
                SetupPtrs& a) {
  if (n_ptrs != N_PTRS || mc_len != MC_SIZE || topo_len != TP_SIZE) return invalid_value();
  for (int k = 0; k < N_PTRS; ++k) a.p[k] = const_cast<void*>(ptrs[k]);
  return 0;
}

#if QWBC_SETUP_PROBES
template <bool EXACT, int STOP = STOP_INPUTS>
int launch_probe(const SetupPtrs& a, const SetupArgs& s, int stop, void* stream) {
  if constexpr (STOP < N_STOPS) {
    if (stop == STOP)
      return launch_setup_variant<float, EXACT, STOP>(a, s, 0.0f, 0.0f, stream);
    return launch_probe<EXACT, STOP + 1>(a, s, stop, stream);
  } else {
    return invalid_value();
  }
}
#endif

#if QWBC_SETUP_WHOLE
template <typename T>
int launch_setup(const void* const* ptrs, int n_ptrs, int mc_len, int topo_len, int B,
                 int refnew_stride, int exact, int fused, int sweeps, T rho0, T rho_eq,
                 void* stream) {
  SetupPtrs a;
  if (int err = setup_table<T>(ptrs, n_ptrs, mc_len, topo_len, a)) return err;
  const SetupArgs s{B, refnew_stride, fused, sweeps};
  return exact ? launch_setup_variant<T, true, STOP_NONE>(a, s, rho0, rho_eq, stream)
               : launch_setup_variant<T, false, STOP_NONE>(a, s, rho0, rho_eq, stream);
}
#endif

}  // namespace qwbc

extern "C" {

#if QWBC_SETUP_PROBES
// a section probe (stop_after 1..8, the STOP_* order), float32: the kernel
// up to that section, com the checksum; rho and the prepare tail unused
int qwbc_setup_sections_f32(const void* const* ptrs, int n_ptrs, int mc_len, int topo_len,
                            int B, int refnew_stride, int exact, int stop_after,
                            void* stream) {
  qwbc::SetupPtrs a;
  if (int err = qwbc::setup_table<float>(ptrs, n_ptrs, mc_len, topo_len, a)) return err;
  const qwbc::SetupArgs s{B, refnew_stride, 0, 0};
  return exact ? qwbc::launch_probe<true>(a, s, stop_after, stream)
               : qwbc::launch_probe<false>(a, s, stop_after, stream);
}
#endif

#if QWBC_SETUP_WHOLE
#ifndef __CUDACC__
int qwbc_host_reverse = 0;
#endif

int qwbc_setup_f32(const void* const* ptrs, int n_ptrs, int mc_len, int topo_len,
                   int B, int refnew_stride, int exact, int fused, int sweeps,
                   float rho0, float rho_eq, void* stream) {
  return qwbc::launch_setup<float>(ptrs, n_ptrs, mc_len, topo_len, B, refnew_stride, exact,
                                   fused, sweeps, rho0, rho_eq, stream);
}

int qwbc_setup_f64(const void* const* ptrs, int n_ptrs, int mc_len, int topo_len,
                   int B, int refnew_stride, int exact, int fused, int sweeps,
                   double rho0, double rho_eq, void* stream) {
  return qwbc::launch_setup<double>(ptrs, n_ptrs, mc_len, topo_len, B, refnew_stride, exact,
                                    fused, sweeps, rho0, rho_eq, stream);
}
#endif

}  // extern "C"
