// Gauss-Newton assembly of the augmented-Lagrangian stage model, hand-written
// for Hopper (sm_90a).
//
// Replaces the JAX package's hand-written batch rule _gn_assemble_vmap
// (robot_mpcs_tpu/solver/al_ilqr.py:228, the vmap rule of gn_assemble,
// :224-299) fused with the per-row coefficients it is fed (_coefs, :174,
// through _expansion_coefs, :301). Per (lane, stage) of the split expansion:
//
//   per row: residual rows  g = 2 w r,              h = 2 w
//            barrier rows   g = -w / b^2,           h = max(2 w / b^3, 0)
//                           (b = max(b, 1e-3); both 0 where b <= 1e-3)
//            constraint rows act = max(lam - mu c, 0), g = -act, h = mu [act > 0]
//                           (c the row plus C_OFF, the stage-0 pin, and for a
//                           q-family row with a slack column, plus s = W[0])
//   g = S^T g_aff + Jq^T g_q (+ the q constraint rows' sum at the slack column)
//   H = S^T diag(h_aff) S + Jq^T diag(h_q) Jq (+ the slack column's cross terms)
//
// written as the five Riccati blocks lx (nx), lw (nw), lxx (nx x nx), lxw
// (nx x nw), lww (nw x nw), with no (M, nv, nv) tensor between. Only the
// upper triangle j >= i is computed and it is mirrored, so H is exactly
// symmetric, as the JAX rule does (:280). The affine rows' Jacobian S_aff is
// a build-time constant with one or two non-zeros a row: the wrapper
// (ops/gn_assemble.py) re-indexes its non-zeros (the JAX rule's _S_nz, :200)
// by the output entry they feed, a CSR table per gradient entry (S[r, i]) and
// per upper entry of H (S[r, i] S[r, j]), so an entry's affine part is a
// loop over its own few rows instead of an (n_arows x nv^2) product.
//
// What bounds it on an H100: bytes. A (lane, stage) reads its q rows, their
// Jacobian, its affine rows, the four weight vectors and its multipliers
// (239 floats at the panda) and writes nv + nx^2 + nx nw + nw^2 floats (364);
// at B = 4096, N = 20 that is 198 MB, 59 us at 3.35 TB/s, against ~2,100
// flops an item (0.17 GFLOP, 2.5 us at the fp32 rate).
//
// The design: a team of T = 32 threads (a warp) per (lane, stage), 128 / T
// items per block. A thread per item cannot hold the nv (nv + 1) / 2
// accumulators (231 at the panda, 496 at the mobile panda). The team
//   1. copies the item's q Jacobian into shared memory (consecutive threads
//      on consecutive floats) and computes the per-row coefficients, rows
//      t, t + T, ..., into shared memory;
//   2. computes the nv gradient entries and the upper triangle of H,
//      entries t, t + T, ... of nv + nv (nv + 1) / 2, each an affine part
//      (its CSR rows), a q-family part (a dot over the q rows, for i, j <
//      n_q) and the slack column's terms, summed in the JAX rule's order,
//      and writes each H entry to both of its places in shared memory;
//   3. writes the five blocks out, consecutive threads on consecutive floats.
// Members synchronise with __syncwarp only. No atomics and no cross-lane
// reduction: each item's result does not depend on its neighbours.
//
// One shape per library: ops/_build.py compiles this file for the segment
// sizes of a problem (-DGN_QR, _QB, _QC, _AR, _AB, _AC, _NQ, _NX, _NW, _NS)
// and the team size (-DGN_T) at first use.

#include "riccati_common.cuh"

#if !defined(GN_QR) || !defined(GN_QB) || !defined(GN_QC) || !defined(GN_AR) || !defined(GN_AB) || \
    !defined(GN_AC) || !defined(GN_NQ) || !defined(GN_NX) || !defined(GN_NW) || !defined(GN_NS) ||   \
    !defined(GN_T)
#error "compile with the shape defines that ops/_build.py passes"
#endif

namespace {

using namespace riccati;

constexpr float kBarrierEps = 1e-3f;  // models/components.py BARRIER_EPS

// Per-item shared memory, in floats: the q Jacobian (RQ x NQ), the
// coefficients g_q, h_q (RQ each), g_a, h_a (RA each), the gradient (NV) and
// H (NV rows of stride HS).
template <int RQ, int RA, int NQ, int NV>
struct GnLayout {
  static constexpr int HS = odd(NV);
  static constexpr int JQ = 0, GQ = JQ + RQ * NQ, HQ = GQ + RQ, GA = HQ + RQ, HA = GA + RA, G = HA + RA,
                       H = G + NV, FLOATS = H + NV * HS;
};

constexpr int QR = GN_QR, QB = GN_QB, QC = GN_QC, AR = GN_AR, AB = GN_AB, AC = GN_AC;
constexpr int NQ = GN_NQ, NX = GN_NX, NW = GN_NW, NS = GN_NS, T = GN_T;
constexpr int RQ = QR + QB + QC, RA = AR + AB + AC, NV = NX + NW, NCON = QC + AC;
using Lay = GnLayout<RQ, RA, NQ, NV>;

struct Rows {
  const float *vq, *Jq, *va, *wrq, *wbq, *wra, *wba, *lam, *mu, *coff, *W;
};
struct Tables {
  const int *grad_ptr, *grad_row;
  const float* grad_coef;
  const int *pair_ptr, *pair_row;
  const float* pair_coef;
};
struct Blocks {
  float *lx, *lw, *lxx, *lxw, *lww;
};

// (g, h) of one row: residual, barrier or constraint (c already shifted)
__device__ __forceinline__ void residual(float w, float r, float& g, float& h) {
  g = 2.f * w * r;
  h = 2.f * w;
}
__device__ __forceinline__ void barrier(float w, float b, float& g, float& h) {
  const bool live = b > kBarrierEps;
  const float bs = fmaxf(b, kBarrierEps);
  g = live ? -w / (bs * bs) : 0.f;
  h = live ? fmaxf(2.f * w / (bs * bs * bs), 0.f) : 0.f;
}
__device__ __forceinline__ void constraint(float lam, float mu, float c, float& g, float& h) {
  const float act = fmaxf(lam - mu * c, 0.f);
  g = -act;
  h = act > 0.f ? mu : 0.f;
}

__global__ void __launch_bounds__(kBlockThreads) gn_assemble_kernel(Rows in, Tables tab, Blocks out, int M,
                                                                     int N) {
  extern __shared__ float smem[];  // the block's items, Lay::FLOATS floats each
  const int items = blockDim.x / T;
  const int t = threadIdx.x % T;
  const int m = blockIdx.x * items + threadIdx.x / T;
  if (m >= M) return;  // a whole team (one warp) past the batch
  float* sm = smem + (threadIdx.x / T) * Lay::FLOATS;
  float* JQ = sm + Lay::JQ;
  float* GQ = sm + Lay::GQ;
  float* HQ = sm + Lay::HQ;
  float* GA = sm + Lay::GA;
  float* HA = sm + Lay::HA;
  float* G = sm + Lay::G;
  float* H = sm + Lay::H;
  const int b = m / N, k = m % N;
  const long long mm = m;

  // 1. the q Jacobian, and the coefficients of rows t, t + T, ...
  for (int e = t; e < RQ * NQ; e += T) JQ[e] = in.Jq[mm * RQ * NQ + e];
  const float mu = in.mu[b];
  const float s = NS ? in.W[mm * NW] : 0.f;  // the slack column of W
  for (int r = t; r < RQ + RA; r += T) {
    float g, h;
    if (r < RQ) {
      const float v = in.vq[mm * RQ + r];
      if (r < QR) {
        residual(in.wrq[mm * QR + r], v, g, h);
      } else if (r < QR + QB) {
        barrier(in.wbq[mm * QB + r - QR], v, g, h);
      } else {
        const int c = r - QR - QB;
        const float shifted = NS ? v + s : v;
        constraint(in.lam[mm * NCON + c], mu, shifted + in.coff[k * NCON + c], g, h);
      }
      GQ[r] = g;
      HQ[r] = h;
    } else {
      const int a = r - RQ;
      const float v = in.va[mm * RA + a];
      if (a < AR) {
        residual(in.wra[mm * AR + a], v, g, h);
      } else if (a < AR + AB) {
        barrier(in.wba[mm * AB + a - AR], v, g, h);
      } else {
        const int c = QC + a - AR - AB;
        constraint(in.lam[mm * NCON + c], mu, v + in.coff[k * NCON + c], g, h);
      }
      GA[a] = g;
      HA[a] = h;
    }
  }
  __syncwarp();

  // 2. the gradient and H's upper triangle, entries t, t + T, ...: the
  //    affine rows (CSR), then the q rows, then the slack column's terms
  constexpr int NE = NV + NV * (NV + 1) / 2;
  for (int e = t; e < NE; e += T) {
    if (e < NV) {
      const int i = e;
      float acc = 0.f;
      for (int p = tab.grad_ptr[i]; p < tab.grad_ptr[i + 1]; ++p) acc = acc + tab.grad_coef[p] * GA[tab.grad_row[p]];
      if (i < NQ) {
#pragma unroll 4
        for (int r = 0; r < RQ; ++r) acc = acc + JQ[r * NQ + i] * GQ[r];
      }
      if (NS && QC && i == NX) {
        for (int r = QR + QB; r < RQ; ++r) acc = acc + GQ[r];
      }
      G[i] = acc;
    } else {
      int i, j;
      upper_entry<NV>(e - NV, i, j);
      float acc = 0.f;
      const int u = e - NV;
      for (int p = tab.pair_ptr[u]; p < tab.pair_ptr[u + 1]; ++p) acc = acc + tab.pair_coef[p] * HA[tab.pair_row[p]];
      if (j < NQ) {
#pragma unroll 4
        for (int r = 0; r < RQ; ++r) acc = acc + HQ[r] * JQ[r * NQ + i] * JQ[r * NQ + j];
      }
      if (NS && QC && j == NX) {
        if (i < NQ) {
          for (int r = QR + QB; r < RQ; ++r) acc = acc + HQ[r] * JQ[r * NQ + i];
        } else if (i == NX) {
          for (int r = QR + QB; r < RQ; ++r) acc = acc + HQ[r];
        }
      }
      H[i * Lay::HS + j] = acc;
      H[j * Lay::HS + i] = acc;
    }
  }
  __syncwarp();

  // 3. the five blocks, consecutive threads on consecutive floats
  for (int e = t; e < NX; e += T) out.lx[mm * NX + e] = G[e];
  for (int e = t; e < NW; e += T) out.lw[mm * NW + e] = G[NX + e];
  for (int e = t; e < NX * NX; e += T) out.lxx[mm * NX * NX + e] = H[(e / NX) * Lay::HS + e % NX];
  for (int e = t; e < NX * NW; e += T) out.lxw[mm * NX * NW + e] = H[(e / NW) * Lay::HS + NX + e % NW];
  for (int e = t; e < NW * NW; e += T) out.lww[mm * NW * NW + e] = H[(NX + e / NW) * Lay::HS + NX + e % NW];
}

int launch(const Rows& in, const Tables& tab, const Blocks& out, int M, int N, cudaStream_t stream) {
  static const int limit = dynamic_shared_limit(gn_assemble_kernel);
  constexpr size_t item_bytes = Lay::FLOATS * sizeof(float);
  const int items = lanes_per_block(T, item_bytes, 0, limit);
  if (items == 0) return kNoRoom;
  gn_assemble_kernel<<<ceil_div(M, items), items * T, items * item_bytes, stream>>>(in, tab, out, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Per (lane, stage) m = b N + k,
// contiguous f32: vq (M, RQ), Jq (M, RQ, NQ), va (M, RA), the weights wrq
// (M, QR), wbq (M, QB), wra (M, AR), wba (M, AB), lam (M, QC + AC); mu (B,),
// c_off (N, QC + AC), W (M, NW) (its column 0 read where NS = 1). The tables:
// grad_ptr (NV + 1), grad_row / grad_coef; pair_ptr (NV (NV + 1) / 2 + 1),
// pair_row / pair_coef (ops/gn_assemble.py). Outputs lx (M, NX), lw (M, NW),
// lxx (M, NX, NX), lxw (M, NX, NW), lww (M, NW, NW). Returns
// cudaGetLastError() after the launch; kNoInstantiation for segment sizes
// other than this library's; kNoRoom where one item's workspace does not fit.
extern "C" int gn_assemble_launch(const float* vq, const float* Jq, const float* va, const float* wrq,
                                  const float* wbq, const float* wra, const float* wba, const float* lam,
                                  const float* mu, const float* c_off, const float* W, const int* grad_ptr,
                                  const int* grad_row, const float* grad_coef, const int* pair_ptr,
                                  const int* pair_row, const float* pair_coef, float* lx, float* lw,
                                  float* lxx, float* lxw, float* lww, int B, int N, int qr, int qb, int qc,
                                  int ar, int ab, int ac, int nq, int nx, int nw, int ns,
                                  cudaStream_t stream) {
  if (qr != QR || qb != QB || qc != QC || ar != AR || ab != AB || ac != AC || nq != NQ || nx != NX ||
      nw != NW || ns != NS)
    return kNoInstantiation;
  if (B == 0 || N == 0) return 0;
  const Rows in{vq, Jq, va, wrq, wbq, wra, wba, lam, mu, c_off, W};
  const Tables tab{grad_ptr, grad_row, grad_coef, pair_ptr, pair_row, pair_coef};
  const Blocks out{lx, lw, lxx, lxw, lww};
  return launch(in, tab, out, B * N, N, stream);
}

// Bytes of shared memory one item takes (ops/_build.py computes the same
// before it builds a library, and the tests hold the two equal)
extern "C" int gn_assemble_lane_bytes() { return Lay::FLOATS * sizeof(float); }
