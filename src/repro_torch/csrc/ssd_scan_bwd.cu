// Mamba2 SSD chunk scan backward, CUDA for sm_90a: dx, d(dt), dA, dB and
// dC of the scan ssd_scan.cu computes, from a zero state.
//
// Replaces no Pallas kernel: the reference trains through ref.ssd
// (repro/kernels/ops.py sends ssd to it) and XLA derives the gradient
// under jax.checkpoint (repro/models/ssm.py).  The port's SSD on the card
// is the hand-written scan, which autograd cannot see through, so its
// gradient is this kernel (kernels/ssd_scan.py::SSDScan).
//
// The forward, for a chunk of T positions with a = dt A, a_cum its running
// sum inside the chunk, L[s][t] = exp(a_cum[s] - a_cum[t]) (t <= s), G[s][t]
// = C[s].B[t] and xd = x dt:
//   y[s]  = sum_{t<=s} G[s][t] L[s][t] xd[t] + exp(a_cum[s]) S_in C[s]
//   S_out = exp(a_cum[T-1]) S_in + sum_t exp(a_cum[T-1] - a_cum[t]) xd[t] B[t]^T
// Its gradient, chunk by chunk in reverse, carrying dS = d(S_out):
//   dW[s][t] = dy[s].xd[t]; dG[s][t] = dW L (summed over heads: B and C
//   are one group); M = dW G L, whose row sums minus column sums are
//   d(a_cum) of the diagonal block; dxd[t] = sum_{s>=t} G L dy[s];
//   the state terms: dxd[t] += dec[t] dS B[t] (dec = exp(a_cum[T-1] -
//   a_cum[t])), dB[t] += dec[t] dS^T xd[t], d(a_cum[t]) -= xd[t].(that
//   term), and a_cum[T-1] gets their sum plus exp(a_cum[T-1]) <dS, S_in>;
//   with the entering state S_in: dC[s] += exp(a_cum[s]) S_in^T dy[s],
//   d(a_cum[s]) += C[s].(that term), and dS_in = exp(a_cum[T-1]) dS +
//   sum_s exp(a_cum[s]) dy[s] C[s]^T.  Then d(a) is the reverse running
//   sum of d(a_cum), d(dt) = A d(a) + dxd.x, dx = dxd dt, dA = sum d(a) dt.
// a_cum is summed in float64 from the exact products dt A and each
// exponent (a difference of two such sums) rounded once to f32, as in the
// forward; the reverse sum of d(a_cum) is also taken in float64.
//
// A chunk longer than MAX_PIECE is walked in the forward's pieces (at most
// 64 positions, the same recurrence cut finer), and the forward saves the
// state entering every piece but the first (its optional ``states``
// output), so this kernel never recomputes a state.
//
// Bound on the H100: at mamba2-1.3b's SFT shape (x (64, 57, 64, 64) bf16,
// n 128, one chunk of 57) the gradient needs ~1.7 GFLOP of f32 arithmetic
// per (row, head) products dW and dxd (2 x T^2 p / 2 each) plus, once per
// row, the scores and dC, dB (3 x T^2 n / 2 x 2), and moves ~95 MB (x, dy,
// dx in bf16, the rest f32): ~38 us by f32 operations (67 TFLOP/s), ~28 us
// by bytes (3.35 TB/s).  No TF32: held to a float64 witness at 2e-5.
// On an H100 SXM at 700 W it takes ~0.67 ms there (~23x the bound) and
// ~1.03 ms at zamba2-7b's shape (112 heads, n 64): a first design, set by
// each block's chain of barriers and shared loads, not by either bound.
//
// Design, simple first (f32 FMAs out of shared memory, no tensor cores):
//   - one block of 512 threads (16 warps hide more of the latencies than
//     8, ~1.35x) per (row, group of GROUP = 4 heads): the
//     block stages B and C of a piece once, computes the causal scores G
//     once for the group, and sums dG over the group's heads in shared
//     memory, so dC = dG B and dB = dG^T C are one product per group;
//   - per head: x dt and dy staged in shared memory, dW and then G L, dG
//     and the row / column partial sums of M in 4 x 4 register tiles; dxd
//     with its state term in 4 x 4 tiles, kept in shared memory until dx
//     is written from it (in registers it pushed 512 threads past their
//     128 registers); d(dt) reduced in a fixed order;
//   - dB and dC partials per (row, group) and dA partials per (row, head)
//     go to scratch, and a second launch of this source sums them over the
//     groups and over the rows in a fixed order: no float atomics, so two
//     calls give the same bits;
//   - the state gradient dS of each head is carried between pieces in a
//     (b, h, p, n) f32 scratch, which holds the final state's gradient on
//     entry; a call with one piece and no final-state gradient has no
//     state term and skips it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_ssd_bwd {

constexpr int THREADS = 512;        // 16 warps to hide the tiles' latencies
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;            // heads a block
constexpr int MAX_CHUNK = 128;
constexpr int MAX_PIECE = 64;       // positions of a chunk walked at once
constexpr int ROT_MASK = 7;         // k-quad rotations of mm4k (see there)
constexpr size_t MAX_SMEM = 232448; // 227 KB of dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

// dtype codes shared with the Python wrapper
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

struct BwdParams {
  const void* x;        // (b, l, h, p), strided, last dim contiguous
  const float* dt;      // (b, l, h), strided
  const void* A;        // (h,), contiguous
  const float* B;       // (b, l, n), strided, last dim contiguous
  const float* C;       // (b, l, n), strided, last dim contiguous
  const void* dy;       // (b, l, h, p), contiguous, x's type
  const float* states;  // (b, pieces - 1, h, p, n): state entering piece q + 1
  float* dS;            // (b, h, p, n) scratch, or null without state terms
  void* dx;             // (b, l, h, p), contiguous, x's type
  float* ddt;           // (b, l, h), contiguous
  float* dBp;           // (b, groups, l, n) partials
  float* dCp;           // (b, groups, l, n) partials
  float* dAp;           // (b, h) partials
  int a_bf16, has_state;
  int H, L, P, N, T;
  int TP, NPC;          // piece length, pieces a chunk
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl;
  // derived on the host (set_layout)
  int T4, P4, N4;       // piece, p and n rounded up to 4
  int R, JQ, CQ, PW;    // tiles a piece side, p quads, n quads, part width
  int pieces, groups;
  int o_c, o_g, o_dg, o_wk, o_mr, o_mc, o_xd, o_dy, o_dx, o_part, o_vec,
      o_acum, o_so;     // offsets in floats
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX> __device__ __forceinline__ TX from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][0..3] += a[i] * (b.x, b.y, b.z, b.w)
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float (&a)[4],
                                       const float4 b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
  }
}

// acc[i][j] += sum_{k < K4} a[i lda + k] b[j ldb + k], four k at a time
// (16-byte loads; K4, lda and ldb multiples of 4, zero-padded), the k
// quads in order from quad rot mod K4 / 4 round to it.  Neighbouring
// threads take neighbouring b tiles, whose rows lie a multiple of 32
// floats apart at the model's widths: rotated by (their tile index &
// ROT_MASK), the 8 threads of a 16-byte load phase read 8 different bank
// groups, where in order they would all read the same one.
__device__ __forceinline__ void mm4k(float (&acc)[4][4], const float* a,
                                     int lda, const float* b, int ldb, int K4,
                                     int rot) {
  const int nq = K4 / 4;
  int q = rot % nq;
  for (int c = 0; c < nq; ++c, q = q + 1 == nq ? 0 : q + 1) {
    const int k = 4 * q;
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + i * lda + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv = ld4(b + j * ldb + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float r = fmaf(av[i].x, bv.x, acc[i][j]);
        r = fmaf(av[i].y, bv.y, r);
        r = fmaf(av[i].z, bv.z, r);
        acc[i][j] = fmaf(av[i].w, bv.w, r);
      }
    }
  }
}

// inclusive prefix sums in float64 of the values v[m] at positions
// lane + 32 m (m < 4) of a warp: up to 128 values
__device__ __forceinline__ void warp_scan4(double (&v)[4], int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const double o = __shfl_up_sync(FULL, v[m], off);
      if (lane >= off) v[m] += o;
    }
  }
  double carry = 0.0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const double tot = __shfl_sync(FULL, v[m], 31);
    v[m] += carry;
    carry += tot;
  }
}

// the sum of every thread's v in a fixed order (a butterfly in each warp,
// then the warps in order), returned to every thread; red holds WARPS floats
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();   // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__host__ __device__ __forceinline__ int pieces_of(int T) {
  return (T + MAX_PIECE - 1) / MAX_PIECE;
}
__host__ __device__ __forceinline__ int piece_len(int T) {
  const int n = pieces_of(T);
  return (T + n - 1) / n;
}

// Sizes and shared-memory offsets, and the floats of dynamic shared memory
// a block takes (the Python wrapper's bwd_smem_bytes mirrors them): B and
// C rows of a piece (T4 x N4 each), the scores G, the group's dG and a
// head's weights G L (T4 x T4 each), the row and column partial sums of M
// (T4 x R each), x dt, dy and dxd (T4 x P4 each), a partial-sum table
// (T4 x PW), seven vectors of T4 and WARPS floats, a_cum in float64, and
// with state terms the head's dS (P4 x N4).
inline size_t set_layout(BwdParams& p) {
  p.T4 = round4(p.TP);
  p.P4 = round4(p.P);
  p.N4 = round4(p.N);
  p.R = p.T4 / 4;
  p.JQ = p.P4 / 4;
  p.CQ = p.N4 / 4;
  p.PW = p.JQ > p.CQ ? p.JQ : p.CQ;
  p.pieces = (p.L / p.T) * p.NPC;
  p.groups = (p.H + GROUP - 1) / GROUP;
  const int T4 = p.T4;
  p.o_c = T4 * p.N4;
  p.o_g = p.o_c + T4 * p.N4;
  p.o_dg = p.o_g + T4 * T4;
  p.o_wk = p.o_dg + T4 * T4;
  p.o_mr = p.o_wk + T4 * T4;
  p.o_mc = p.o_mr + T4 * p.R;
  p.o_xd = p.o_mc + T4 * p.R;
  p.o_dy = p.o_xd + T4 * p.P4;
  p.o_dx = p.o_dy + T4 * p.P4;
  p.o_part = p.o_dx + T4 * p.P4;
  p.o_vec = p.o_part + T4 * p.PW;
  p.o_acum = p.o_vec + 7 * T4 + WARPS;   // even: 8-byte aligned doubles
  p.o_so = p.o_acum + 2 * T4;
  return size_t(p.o_so) + (p.has_state ? size_t(p.P4) * p.N4 : 0);
}

template <typename TX>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int T4 = p.T4, P4 = p.P4, N4 = p.N4, R = p.R, JQ = p.JQ, CQ = p.CQ,
            PW = p.PW;
  float* Bs = smem;                  // (T4, N4) B rows of the piece
  float* Cs = smem + p.o_c;          // (T4, N4) C rows
  float* G = smem + p.o_g;           // (T4, T4) G[s][t], 0 for t > s
  float* dG = smem + p.o_dg;         // (T4, T4) the group's dG[s][t]
  float* Wk = smem + p.o_wk;         // (T4, T4) a head's G L
  float* Mr = smem + p.o_mr;         // (T4, R) M's row sums by tile
  float* Mc = smem + p.o_mc;         // (T4, R) M's column sums by tile
  float* Xd = smem + p.o_xd;         // (T4, P4) x dt
  float* dY = smem + p.o_dy;         // (T4, P4) dy
  float* DX = smem + p.o_dx;         // (T4, P4) dxd
  float* part = smem + p.o_part;     // (T4, PW) partial sums by quad
  float* dts = smem + p.o_vec;       // dt
  float* eac = dts + T4;             // exp(a_cum)
  float* dec = eac + T4;             // exp(a_cum[T-1] - a_cum)
  float* dac = dec + T4;             // d(a_cum), then d(a)
  float* qsum = dac + T4;            // xd.(the state's dxd term)
  float* offs = qsum + T4;           // C.(the entering state's dC term)
  float* dAs = offs + T4;            // the group's dA (GROUP <= T4)
  float* red = dAs + T4;             // WARPS floats
  double* acum = reinterpret_cast<double*>(smem + p.o_acum);  // (T4)
  float* So = smem + p.o_so;         // (P4, N4) the head's dS

  const int bi = blockIdx.x / p.groups;
  const int grp = blockIdx.x - bi * p.groups, h0 = grp * GROUP;
  const int nh = min(GROUP, p.H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long rowx = static_cast<long long>(bi) * p.L * p.H * p.P;
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  const TX* xg = static_cast<const TX*>(p.x) + bi * p.x_sb;
  const float* dtg = p.dt + bi * p.dt_sb;
  const TX* dyg = static_cast<const TX*>(p.dy) + rowx;
  TX* dxg = static_cast<TX*>(p.dx) + rowx;
  float* dBg = p.dBp + (static_cast<long long>(bi) * p.groups + grp) * p.L * p.N;
  float* dCg = p.dCp + (static_cast<long long>(bi) * p.groups + grp) * p.L * p.N;
  const bool add = p.has_state;      // partials zeroed by the wrapper: add
  if (tid < GROUP) dAs[tid] = 0.f;

  for (int q = p.pieces - 1; q >= 0; --q) {
    const int c = q / p.NPC, r = q - c * p.NPC;
    const int t0 = c * p.T + r * p.TP;
    const int tl = min(p.TP, p.T - r * p.TP);
    const int Rl = (tl + 3) / 4;     // tile rows holding a position
    __syncthreads();                 // the previous piece is done
    for (int e = tid; e < T4 * N4; e += THREADS) {
      const int t = e / N4, k = e - t * N4;
      const bool ok = t < tl && k < p.N;
      Bs[e] = ok ? Bg[(t0 + t) * p.b_sl + k] : 0.f;
      Cs[e] = ok ? Cg[(t0 + t) * p.c_sl + k] : 0.f;
    }
    for (int e = tid; e < T4 * T4; e += THREADS) dG[e] = 0.f;
    __syncthreads();
    // the causal scores, once for the group
    for (int e = tid; e < R * R; e += THREADS) {
      const int sq = e / R, tq = e - sq * R;
      float acc[4][4] = {};
      if (tq <= sq && sq < Rl)
        mm4k(acc, Cs + 4 * sq * N4, N4, Bs + 4 * tq * N4, N4, N4,
             tq & ROT_MASK);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          G[(4 * sq + i) * T4 + 4 * tq + j] =
              4 * tq + j <= 4 * sq + i ? acc[i][j] : 0.f;
    }

    for (int g = 0; g < nh; ++g) {
      const int hi = h0 + g;
      const float Af =
          p.a_bf16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.A)[hi])
              : static_cast<const float*>(p.A)[hi];
      __syncthreads();   // G written; the previous head is done
      // stage dt, x dt, dy (zero past tl and p), the head's dS; a_cum
      if (tid < T4)
        dts[tid] = tid < tl ? dtg[(t0 + tid) * p.dt_sl + hi * p.dt_sh] : 0.f;
      for (int e = tid; e < T4 * P4; e += THREADS) {
        const int t = e / P4, j = e - t * P4;
        const bool ok = t < tl && j < p.P;
        Xd[e] = ok ? to_f32(xg[(t0 + t) * p.x_sl + hi * p.x_sh + j]) *
                         dtg[(t0 + t) * p.dt_sl + hi * p.dt_sh]
                   : 0.f;
        dY[e] = ok ? to_f32(dyg[(static_cast<long long>(t0 + t) * p.H + hi) *
                                    p.P + j])
                   : 0.f;
      }
      float* dSh = nullptr;
      if (p.has_state) {
        dSh = p.dS + (static_cast<long long>(bi) * p.H + hi) * p.P * p.N;
        for (int e = tid; e < P4 * N4; e += THREADS) {
          const int j = e / N4, k = e - j * N4;
          So[e] = j < p.P && k < p.N ? dSh[j * p.N + k] : 0.f;
        }
      }
      if (warp == WARPS - 1) {
        double v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int t = lane + 32 * m;
          v[m] = t < tl ? static_cast<double>(
                              dtg[(t0 + t) * p.dt_sl + hi * p.dt_sh]) *
                              static_cast<double>(Af)
                        : 0.0;
        }
        warp_scan4(v, lane);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (lane + 32 * m < T4) acum[lane + 32 * m] = v[m];
      }
      __syncthreads();
      const double atot = acum[tl - 1];
      if (tid < T4) {
        eac[tid] = tid < tl ? expf(static_cast<float>(acum[tid])) : 0.f;
        dec[tid] = tid < tl ? expf(static_cast<float>(atot - acum[tid])) : 0.f;
      }

      // dW = dy xd^T on the causal tiles; the weights G L; dG += dW L; the
      // row and column sums of M = dW G L by tile
      for (int e = tid; e < R * R; e += THREADS) {
        const int sq = e / R, tq = e - sq * R;
        const bool live = tq <= sq && sq < Rl;
        float acc[4][4] = {};
        if (live)
          mm4k(acc, dY + 4 * sq * P4, P4, Xd + 4 * tq * P4, P4, P4,
               tq & ROT_MASK);
        float rs[4] = {}, cs[4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = 4 * sq + i, t = 4 * tq + j;
            float w = 0.f;
            if (live && t <= s && s < tl) {
              const float l = expf(static_cast<float>(acum[s] - acum[t]));
              w = G[s * T4 + t] * l;
              dG[s * T4 + t] += acc[i][j] * l;
              const float m = acc[i][j] * w;
              rs[i] += m;
              cs[j] += m;
            }
            Wk[s * T4 + t] = w;
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Mr[(4 * sq + i) * R + tq] = rs[i];
          Mc[(4 * tq + i) * R + sq] = cs[i];
        }
      }
      __syncthreads();

      // dxd = (G L)^T dy, + the state's dec dS B with its partial
      // xd.(that) by p quad; d(a_cum) of the diagonal block
      for (int e = tid; e < R * JQ; e += THREADS) {
        const int tq = e / JQ, jq = e - tq * JQ;
        if (tq >= Rl) continue;
        float dxr[4][4] = {};
        for (int s = 4 * tq; s < tl; ++s) {
          const float4 w = ld4(Wk + s * T4 + 4 * tq);
          const float wa[4] = {w.x, w.y, w.z, w.w};
          outer4(dxr, wa, ld4(dY + s * P4 + 4 * jq));
        }
        if (p.has_state) {
          float st[4][4] = {};
          mm4k(st, Bs + 4 * tq * N4, N4, So + 4 * jq * N4, N4, N4,
               jq & ROT_MASK);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = 4 * tq + i;
            const float d = dec[t];
            float qp = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float v = st[i][j] * d;
              dxr[i][j] += v;
              qp = fmaf(Xd[t * P4 + 4 * jq + j], v, qp);
            }
            part[t * PW + jq] = qp;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(DX + (4 * tq + i) * P4 + 4 * jq) =
              make_float4(dxr[i][0], dxr[i][1], dxr[i][2], dxr[i][3]);
      }
      if (tid < tl) {
        float d = 0.f;
        for (int k = 0; k < R; ++k) d += Mr[tid * R + k];
        for (int k = 0; k < R; ++k) d -= Mc[tid * R + k];
        dac[tid] = d;
      }
      __syncthreads();

      if (p.has_state) {
        // dB += dec dS^T xd (to the partials, in place); the q sums
        if (tid < tl) {
          float s = 0.f;
          for (int k = 0; k < JQ; ++k) s += part[tid * PW + k];
          qsum[tid] = s;
        }
        for (int e = tid; e < R * CQ; e += THREADS) {
          const int tq = e / CQ, kq = e - tq * CQ;
          if (tq >= Rl) continue;
          float acc[4][4] = {};
          for (int j = 0; j < p.P; ++j) {
            const float a[4] = {Xd[(4 * tq) * P4 + j],
                                Xd[(4 * tq + 1) * P4 + j],
                                Xd[(4 * tq + 2) * P4 + j],
                                Xd[(4 * tq + 3) * P4 + j]};
            outer4(acc, a, ld4(So + j * N4 + 4 * kq));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = 4 * tq + i;
            if (t >= tl) break;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = 4 * kq + j;
              if (k < p.N) dBg[(t0 + t) * p.N + k] += acc[i][j] * dec[t];
            }
          }
        }
        __syncthreads();   // part is read above, written below
        float sdot = 0.f;
        if (q > 0) {
          const float* Sin =
              p.states +
              ((static_cast<long long>(bi) * (p.pieces - 1) + (q - 1)) * p.H +
               hi) * p.P * p.N;
          // dC += exp(a_cum) S_in^T dy (in place), its C.(that) by n quad
          for (int e = tid; e < R * CQ; e += THREADS) {
            const int sq = e / CQ, kq = e - sq * CQ;
            if (sq >= Rl) continue;
            float acc[4][4] = {};
            for (int j = 0; j < p.P; ++j) {
              const float a[4] = {dY[(4 * sq) * P4 + j],
                                  dY[(4 * sq + 1) * P4 + j],
                                  dY[(4 * sq + 2) * P4 + j],
                                  dY[(4 * sq + 3) * P4 + j]};
              float bv[4];
#pragma unroll
              for (int w = 0; w < 4; ++w)
                bv[w] = 4 * kq + w < p.N ? __ldg(Sin + j * p.N + 4 * kq + w)
                                         : 0.f;
              outer4(acc, a, make_float4(bv[0], bv[1], bv[2], bv[3]));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int s = 4 * sq + i;
              float po = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int k = 4 * kq + j;
                const float v = acc[i][j] * eac[s];
                if (s < tl && k < p.N) {
                  dCg[(t0 + s) * p.N + k] += v;
                  po = fmaf(Cs[s * N4 + k], v, po);
                }
              }
              part[s * PW + kq] = po;
            }
          }
          // dS_in = exp(a_cum[T-1]) dS + sum_s exp(a_cum[s]) dy[s] C[s]^T,
          // written over the head's dS; <dS, S_in>
          const float etot = expf(static_cast<float>(atot));
          float dot = 0.f;
          for (int e = tid; e < JQ * CQ; e += THREADS) {
            const int jq = e / CQ, kq = e - jq * CQ;
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 v = ld4(So + (4 * jq + i) * N4 + 4 * kq);
              acc[i][0] = etot * v.x;
              acc[i][1] = etot * v.y;
              acc[i][2] = etot * v.z;
              acc[i][3] = etot * v.w;
            }
            for (int s = 0; s < tl; ++s) {
              const float4 d = ld4(dY + s * P4 + 4 * jq);
              const float es = eac[s];
              const float a[4] = {d.x * es, d.y * es, d.z * es, d.w * es};
              outer4(acc, a, ld4(Cs + s * N4 + 4 * kq));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int jj = 4 * jq + i, k = 4 * kq + j;
                if (jj < p.P && k < p.N) {
                  dot = fmaf(So[jj * N4 + k], __ldg(Sin + jj * p.N + k), dot);
                  dSh[jj * p.N + k] = acc[i][j];
                }
              }
          }
          sdot = block_sum(dot, red) * etot;
          if (tid < tl) {
            float s = 0.f;
            for (int k = 0; k < CQ; ++k) s += part[tid * PW + k];
            offs[tid] = s;
          }
        } else if (tid < tl) {
          offs[tid] = 0.f;
        }
        __syncthreads();
        if (tid < tl) {
          float d = dac[tid] + offs[tid] - qsum[tid];
          if (tid == tl - 1) {
            float s = 0.f;
            for (int t = 0; t < tl; ++t) s += qsum[t];
            d += s + sdot;
          }
          dac[tid] = d;
        }
      }
      __syncthreads();

      // d(a) = the reverse running sum of d(a_cum), in float64; dA
      if (warp == WARPS - 1) {
        double v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = lane + 32 * m;
          v[m] = i < tl ? static_cast<double>(dac[tl - 1 - i]) : 0.0;
        }
        warp_scan4(v, lane);
        float da_dt = 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = lane + 32 * m;
          if (i < tl) {
            const float da = static_cast<float>(v[m]);
            dac[tl - 1 - i] = da;
            da_dt = fmaf(da, dts[tl - 1 - i], da_dt);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          da_dt += __shfl_xor_sync(FULL, da_dt, o);
        if (lane == 0) dAs[g] += da_dt;
      }
      // dx = dxd dt; dxd.x by p quad
      for (int e = tid; e < R * JQ; e += THREADS) {
        const int tq = e / JQ, jq = e - tq * JQ;
        if (tq >= Rl) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * tq + i;
          if (t >= tl) break;
          const float d = dts[t];
          const float4 v = ld4(DX + t * P4 + 4 * jq);
          const float dxv[4] = {v.x, v.y, v.z, v.w};
          float xs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = 4 * jq + j;
            if (jj < p.P) {
              xs = fmaf(dxv[j],
                        to_f32(xg[(t0 + t) * p.x_sl + hi * p.x_sh + jj]), xs);
              dxg[(static_cast<long long>(t0 + t) * p.H + hi) * p.P + jj] =
                  from_f32<TX>(dxv[j] * d);
            }
          }
          part[t * PW + jq] = xs;
        }
      }
      __syncthreads();
      if (tid < tl) {
        float s = 0.f;
        for (int k = 0; k < JQ; ++k) s += part[tid * PW + k];
        p.ddt[(static_cast<long long>(bi) * p.L + t0 + tid) * p.H + hi] =
            fmaf(Af, dac[tid], s);
      }
    }
    __syncthreads();

    // the group's dC = dG B and dB = dG^T C, to the partials
    for (int e = tid; e < R * CQ; e += THREADS) {
      const int sq = e / CQ, kq = e - sq * CQ;
      if (sq >= Rl) continue;
      float acc[4][4] = {};
      for (int t = 0; t < min(4 * sq + 4, tl); ++t) {
        const float a[4] = {dG[(4 * sq) * T4 + t], dG[(4 * sq + 1) * T4 + t],
                            dG[(4 * sq + 2) * T4 + t],
                            dG[(4 * sq + 3) * T4 + t]};
        outer4(acc, a, ld4(Bs + t * N4 + 4 * kq));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * sq + i;
        if (s >= tl) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * kq + j;
          if (k >= p.N) continue;
          float* o = dCg + (t0 + s) * p.N + k;
          *o = add ? *o + acc[i][j] : acc[i][j];
        }
      }
    }
    for (int e = tid; e < R * CQ; e += THREADS) {
      const int tq = e / CQ, kq = e - tq * CQ;
      if (tq >= Rl) continue;
      float acc[4][4] = {};
      for (int s = 4 * tq; s < tl; ++s) {
        const float4 w = ld4(dG + s * T4 + 4 * tq);
        const float a[4] = {w.x, w.y, w.z, w.w};
        outer4(acc, a, ld4(Cs + s * N4 + 4 * kq));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        if (t >= tl) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * kq + j;
          if (k >= p.N) continue;
          float* o = dBg + (t0 + t) * p.N + k;
          *o = add ? *o + acc[i][j] : acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  if (tid < nh) p.dAp[static_cast<long long>(bi) * p.H + h0 + tid] = dAs[tid];
}

// The second launch: dB and dC summed over the head groups, dA over the
// rows, each in order; dA written in A's type.
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce(
    const float* dBp, const float* dCp, const float* dAp, float* dB,
    float* dC, void* dA, int a_bf16, int b, int groups, int L, int N, int H) {
  const long long per = static_cast<long long>(L) * N;
  const long long total = b * per;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < 2 * total + H; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (e < 2 * total) {
      const bool is_c = e >= total;
      const long long f = is_c ? e - total : e;
      const long long bi = f / per, r = f - bi * per;
      const float* src = (is_c ? dCp : dBp) + bi * groups * per + r;
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += src[g * per];
      (is_c ? dC : dB)[f] = s;
    } else {
      const int hh = static_cast<int>(e - 2 * total);
      float s = 0.f;
      for (int bi = 0; bi < b; ++bi) s += dAp[static_cast<long long>(bi) * H + hh];
      if (a_bf16)
        static_cast<__nv_bfloat16*>(dA)[hh] = __float2bfloat16(s);
      else
        static_cast<float*>(dA)[hh] = s;
    }
  }
}

// The opt-in above 48 KB is made once per instantiation, device and size,
// at the first launch, so a CUDA graph that captures later launches records
// no attribute call.
template <typename TX>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const BwdParams& p) {
  constexpr int MAX_DEVICES = 64;
  static size_t opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > opted_in[dev])) {
    e = cudaFuncSetAttribute(ssd_bwd_kernel<TX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted_in[dev] = smem;
  }
  ssd_bwd_kernel<TX><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro_ssd_bwd

// dx, ddt, dA, dB, dC of the SSD scan for the upstream gradient dy (and the
// final state's gradient, already in the dS scratch where has_state).
// Scratch: dS (b, h, p, n), with has_state; dBp, dCp (b, groups, l, n),
// zeroed with has_state; dAp (b, h).  Two launches on ``stream``.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* dy, const void* states, void* dS, void* dx, void* ddt,
    void* dBp, void* dCp, void* dAp, void* dB, void* dC, void* dA,
    int x_dtype, int a_dtype, int b, int l, int h, int p, int n, int chunk,
    int has_state, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, void* stream) {
  using namespace repro_ssd_bwd;
  if (b <= 0 || l <= 0 || h <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      l % chunk != 0 || p <= 0 || n <= 0 ||
      (a_dtype != DTYPE_F32 && a_dtype != DTYPE_BF16) ||
      (x_dtype != DTYPE_F32 && x_dtype != DTYPE_BF16) ||
      (has_state && dS == nullptr))
    return cudaErrorInvalidValue;
  BwdParams prm{};
  prm.x = x;
  prm.dt = static_cast<const float*>(dt);
  prm.A = A;
  prm.B = static_cast<const float*>(B);
  prm.C = static_cast<const float*>(C);
  prm.dy = dy;
  prm.states = static_cast<const float*>(states);
  prm.dS = static_cast<float*>(dS);
  prm.dx = dx;
  prm.ddt = static_cast<float*>(ddt);
  prm.dBp = static_cast<float*>(dBp);
  prm.dCp = static_cast<float*>(dCp);
  prm.dAp = static_cast<float*>(dAp);
  prm.a_bf16 = a_dtype == DTYPE_BF16;
  prm.has_state = has_state;
  prm.H = h;
  prm.L = l;
  prm.P = p;
  prm.N = n;
  prm.T = chunk;
  prm.TP = piece_len(chunk);
  prm.NPC = pieces_of(chunk);
  prm.x_sb = x_sb;
  prm.x_sl = x_sl;
  prm.x_sh = x_sh;
  prm.dt_sb = dt_sb;
  prm.dt_sl = dt_sl;
  prm.dt_sh = dt_sh;
  prm.b_sb = b_sb;
  prm.b_sl = b_sl;
  prm.c_sb = c_sb;
  prm.c_sl = c_sl;
  const size_t smem = set_layout(prm) * sizeof(float);
  if (smem > MAX_SMEM || (prm.pieces > 1 && states == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = b * prm.groups;
  cudaError_t e = x_dtype == DTYPE_BF16
                      ? launch<__nv_bfloat16>(blocks, smem, s, prm)
                      : launch<float>(blocks, smem, s, prm);
  if (e != cudaSuccess) return e;
  const long long work = 2LL * b * l * n + h;
  const int rblocks =
      static_cast<int>(min(static_cast<long long>(132 * 8),
                           (work + THREADS - 1) / THREADS));
  ssd_bwd_reduce<<<rblocks, THREADS, 0, s>>>(
      prm.dBp, prm.dCp, prm.dAp, static_cast<float*>(dB),
      static_cast<float*>(dC), dA, prm.a_bf16, b, prm.groups, l, n, h);
  return cudaGetLastError();
}
