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
//   dC = dG B, dB = dG^T C; the state terms: dxd[t] += dec[t] dS B[t] (dec
//   = exp(a_cum[T-1] - a_cum[t])), dB[t] += dec[t] dS^T xd[t], d(a_cum[t])
//   -= xd[t].(that term), and a_cum[T-1] gets their sum plus exp(a_cum[T-1])
//   <dS, S_in>; with the entering state S_in: dC[s] += exp(a_cum[s]) S_in^T
//   dy[s], d(a_cum[s]) += C[s].(that term), and dS_in = exp(a_cum[T-1]) dS
//   + sum_s exp(a_cum[s]) dy[s] C[s]^T.  Then d(a) is the reverse running
//   sum of d(a_cum), d(dt) = A d(a) + dxd.x, dx = dxd dt, dA = sum d(a) dt.
// a_cum is summed in float64 from the exact products dt A and, in the FMA
// body, each exponent (a difference of two such sums) rounded once to f32,
// as in the forward (the bf16 body's weights: below); the reverse sum of
// d(a_cum) is also taken in float64.
//
// A chunk longer than MAX_PIECE is walked in the forward's pieces (at most
// 64 positions, the same recurrence cut finer), and the forward saves the
// state entering every piece but the first (its optional ``states``
// output), so this kernel never recomputes a state.
//
// Bound on the H100: at mamba2-1.3b's SFT shape (x (64, 57, 64, 64) bf16,
// n 128, one chunk of 57) the gradient moves ~99 MB (x, dy, dx in bf16,
// the rest f32): ~30 us at 3.35 TB/s.  Its ~1.8 GFLOP are far below the
// tensor cores' rate and below the f32 rate too (~27 us at 67 TFLOP/s), so
// the bound is bytes.  The first design (f32 FMA tiles, one 512-thread
// block an SM) took ~0.66 ms there, set by each block's chains of shared
// loads, FMAs and ~10 barriers a head, and wrote ~60 MB of dB / dC
// partials.  This design takes ~0.124 ms there on an H100 SXM at 700 W
// (~4.2x the bound) and ~0.193 ms at zamba2-7b's shape (112 heads, n 64;
// bound 0.049 ms): the tensor-core body ~82 % of it, latency-bound at 12
// warps an SM (no single phase dominates), the reduce ~13 %.
//
// Which body a dtype takes:
//   - bfloat16 x (the model's training type): the tensor-core body,
//     ssd_bwd_mma_kernel, in three launches;
//   - float32 x (the parity configs and checks, held to a float64 witness
//     at 2e-5, not timed): the FMA body ssd_bwd_fma_kernel, f32 FMA tiles
//     out of shared memory (the first design), then the same reduce.
//
// The bf16 design (mma.sync.m16n8k16, f32 accumulation, mma_bf16.cuh):
//   - launch 1 (ssd_bwd_scores): the causal scores once per (row, piece),
//     16 x 16 tiles (t <= s) of G^T[t][s] = B[t].C[s] in three products of
//     the f32 values split in bf16 hi + lo (lo hi + hi lo + hi hi, ~2^-16
//     relative), B and C staged by 16-byte cp.async, written in the mma
//     accumulator's layout for the next launch's warps to read in place;
//   - launch 2 (ssd_bwd_mma_kernel): one block of 4 warps per (row, group
//     of HEADS heads), three blocks an SM (<= 168 registers, ~66 KB of
//     shared memory: 12 warps an SM; the first design ran 16 in one block,
//     each a long chain).  The heads go in rounds of LANES: warp (lane
//     of heads, t-pair) owns the 16-row t tiles tp and NT-1-tp of its head
//     (5 s tiles each at T 57 padded to 64, balanced).  x and dy of a round
//     are staged in bf16 by 16-byte cp.async (rows padded by 8 so ldmatrix
//     hits no bank twice; element by element where a row is not 16-byte
//     aligned, p 12), while the block computes a_cum (float64, one warp a
//     head, all the block's heads at once).  One buffer: the other two
//     blocks of the SM hide the copies, and a second buffer (36 KB a
//     round at the SFT shapes) would cost the SM its third block; two
//     double-buffered blocks an SM measured slower than three.
//     Per t tile the warp forms dW^T = x dy^T exactly (bf16 operands, f32
//     sums) and scales row t by dt[t] after the product; L (exp2 of the
//     difference of a_cum log2(e) rounded to f32: a float64 difference and
//     expf there cost 15 % of the kernel), G^T L, M and dG follow on the
//     accumulator fragments in registers; the weights G L, split hi + lo,
//     stay in registers as the A operand of dxd = (G L)^T dy (two
//     products, dy exact), taken in JC-column passes; dx = dxd dt and dxd.x
//     come straight from those accumulators.  dG of a head lane is summed
//     in shared memory by the warp that owns the tile, over the lane's
//     heads in order; M's row sums by quad shuffles, its column sums per t
//     tile to shared memory.  After the last round, one warp a head runs
//     the float64 reverse scan, d(dt) and dA, and the block writes the
//     group's dG (its lanes in order) for the third launch: ~13 MB at
//     mamba2's shape where the first design wrote 60 MB of dB and dC
//     partials.  Barriers: five a block of 4 heads at the SFT shapes;
//   - the state terms (a chunk walked in pieces, or a final-state
//     gradient; not on the SFT shapes' path) are a second instantiation of
//     the same body (STATE, two blocks an SM): on tensor cores too, from
//     f32 operands split hi + lo read through L1: dec dS B into dxd before
//     the diagonal products, dB's and dC's terms per (t tile, KC state
//     columns) summed over the round's heads into per-(row, group) partials
//     (read-modify-write in round order), then dS_in and <dS, S_in> after
//     a barrier;
//   - launch 3 (ssd_bwd_reduce, shared with the FMA body): per (row,
//     piece, KC columns of n) dG summed over the groups in order, then dC =
//     dG B and dB = dG^T C on f32 FMAs (four columns a thread) with the
//     state partials; dA summed over the rows, a warp a head.  No float
//     atomics anywhere: two calls give the same bits.
// The state gradient dS of each head is carried between pieces in a (b, h,
// p, n) f32 scratch, which holds the final state's gradient on entry; a
// call with one piece and no final-state gradient has no state term.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace repro_ssd_bwd {

constexpr int HEADS = 4;            // heads a block, both bodies
constexpr int THREADS = 512;        // FMA body: 16 warps hide its latencies
constexpr int WARPS = THREADS / 32;
constexpr int MMA_THREADS = 128;    // tensor-core body: 4 warps
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int LANES = 2;            // heads the tensor-core body works on at once
constexpr int MMA_BLOCKS = 3;       // its blocks an SM: <= 168 registers
                                    // (2 with state terms)
constexpr double LOG2E = 1.4426950408889634;
constexpr int JC = 32;              // dxd columns a warp holds at once
constexpr int KC = 32;              // state columns of a state-term unit
                                    // and of a reduce block
constexpr int SCORE_THREADS = 256;
constexpr int RED_THREADS = 256;
constexpr int MAX_CHUNK = 128;
constexpr int MAX_PIECE = 64;       // positions of a chunk walked at once
constexpr int ROT_MASK = 7;         // k-quad rotations of mm4k (see there)
constexpr size_t MAX_SMEM = 232448; // 227 KB of dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

static_assert(HEADS % LANES == 0 || HEADS < LANES, "rounds of LANES heads");
static_assert(MMA_WARPS == 2 * LANES, "a warp per (head lane, t-pair)");

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
  float* Gp;            // (b, pieces, NTILES, 256) scores, bf16 body only
  float* dGp;           // (b, groups, pieces, NTILES, 256) dG partials
  float* dBs;           // (b, groups, l, n) state partials, or null
  float* dCs;           // (b, groups, l, n) state partials, or null
  float* dAp;           // (b, h) partials
  int a_bf16, has_state;
  int H, L, P, N, T;
  int TP, NPC;          // piece length, pieces a chunk
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl;
  // derived on the host
  int pieces, groups;
  int T16, NT, NTILES;  // piece rounded up to 16, its t tiles, causal tiles
  // the FMA body (set_layout)
  int T4, P4, N4;       // piece, p and n rounded up to 4
  int R, JQ, CQ, PW;    // tiles a piece side, p quads, n quads, part width
  int o_c, o_g, o_dg, o_wk, o_mr, o_mc, o_xd, o_dy, o_dx, o_part, o_vec,
      o_acum, o_so;     // offsets in floats
  // the tensor-core body (set_layout_mma)
  int P16, N16, PS, NKC, SU;        // p, n rounded up to 16; x / dy row
                                    // stride; state column chunks; dS units
                                    // a head
  int x_vec, dy_vec, dx_pair;       // 16-byte x / dy rows; bf16x2 dx stores
  int bc_vec;                       // 16-byte B and C rows
  int m_xs, m_dy, m_dg, m_acum, m_acl, m_dts, m_mrow, m_dd, m_mcol, m_dA,
      m_qs, m_offp, m_sdp;          // offsets in bytes
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
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
// lane + 32 m (m < M) of a warp: up to 32 M values
template <int M>
__device__ __forceinline__ void warp_scan(double (&v)[M], int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const double o = __shfl_up_sync(FULL, v[m], off);
      if (lane >= off) v[m] += o;
    }
  }
  double carry = 0.0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const double tot = __shfl_sync(FULL, v[m], 31);
    v[m] += carry;
    carry += tot;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the sum of every thread's v in a fixed order (a butterfly in each warp,
// then the warps in order), returned to every thread; red holds WARPS floats
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
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

// first position and length of piece q of the sequence
__device__ __forceinline__ void piece_span(const BwdParams& p, int q, int& t0,
                                           int& tl) {
  const int c = q / p.NPC, r = q - c * p.NPC;
  t0 = c * p.T + r * p.TP;
  tl = min(p.TP, p.T - r * p.TP);
}

// The causal 16 x 16 tiles of a piece (t tile ti, s tile sj >= ti) in row
// order, each stored as 256 floats in the m16n8 accumulator layout: lane
// l's eight values (n8 half h, element i) at l * 8 + 4 h + i hold (t, s) =
// (16 ti + l / 4 + 8 (i / 2), 16 sj + 8 h + 2 (l % 4) + i % 2).
__host__ __device__ __forceinline__ int tile_of(int ti, int sj, int NT) {
  return ti * NT - ti * (ti - 1) / 2 + (sj - ti);
}
__device__ __forceinline__ void tile_rc(int u, int NT, int& ti, int& sj) {
  ti = 0;
  while (u >= NT - ti) {
    u -= NT - ti;
    ++ti;
  }
  sj = ti + u;
}
__device__ __forceinline__ void frag_pos(int e, int NT, int& t, int& s) {
  int ti, sj;
  tile_rc(e >> 8, NT, ti, sj);
  const int l = (e >> 3) & 31, h = (e >> 2) & 1, i = e & 3;
  t = 16 * ti + (l >> 2) + 8 * (i >> 1);
  s = 16 * sj + 8 * h + 2 * (l & 3) + (i & 1);
}

// ---------------------------------------------------------------------------
// f32 pairs split into bf16 hi + lo, and fragments of f32 matrices
// ---------------------------------------------------------------------------
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = repro::pack_bf16x2(a - f.x, b - f.y);
}

// d += a b for f32 a and b split in hi + lo: lo hi + hi lo + hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  repro::mma_bf16(d, al, bh[0], bh[1]);
  repro::mma_bf16(d, ah, bl[0], bl[1]);
  repro::mma_bf16(d, ah, bh[0], bh[1]);
}

// d += a b for exact bf16 a and f32 b split in hi + lo
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  repro::mma_bf16(d, a, bl[0], bl[1]);
  repro::mma_bf16(d, a, bh[0], bh[1]);
}

// the A fragment (rows r0..r0+15, k k0..k0+15) of an f32 matrix at(row, k)
template <typename F>
__device__ __forceinline__ void a_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       F at, int r0, int k0, int lane) {
  const int r = r0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  split2(at(r, k), at(r, k + 1), hi[0], lo[0]);
  split2(at(r + 8, k), at(r + 8, k + 1), hi[1], lo[1]);
  split2(at(r, k + 8), at(r, k + 9), hi[2], lo[2]);
  split2(at(r + 8, k + 8), at(r + 8, k + 9), hi[3], lo[3]);
}

// the B fragment (k k0..k0+15, n n0..n0+7) of an f32 matrix at(k, n)
template <typename F>
__device__ __forceinline__ void b_frag(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       F at, int k0, int n0, int lane) {
  const int k = k0 + 2 * (lane & 3), n = n0 + (lane >> 2);
  split2(at(k, n), at(k + 1, n), hi[0], lo[0]);
  split2(at(k + 8, n), at(k + 9, n), hi[1], lo[1]);
}

// the A fragment of a bf16 tile in shared memory, rows r0.., k k0..
__device__ __forceinline__ void a_rows(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld, int r0,
                                       int k0, int lane) {
  repro::ldmatrix_x4(a, s + (r0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}

// ---------------------------------------------------------------------------
// The FMA body (float32 x)
// ---------------------------------------------------------------------------
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
  return (size_t(p.o_so) + (p.has_state ? size_t(p.P4) * p.N4 : 0)) *
         sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_fma_kernel(const BwdParams p) {
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
  float* dAs = offs + T4;            // the group's dA (HEADS <= T4)
  float* red = dAs + T4;             // WARPS floats
  double* acum = reinterpret_cast<double*>(smem + p.o_acum);  // (T4)
  float* So = smem + p.o_so;         // (P4, N4) the head's dS

  const int bi = blockIdx.x / p.groups;
  const int grp = blockIdx.x - bi * p.groups, h0 = grp * HEADS;
  const int nh = min(HEADS, p.H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long rowx = static_cast<long long>(bi) * p.L * p.H * p.P;
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  const float* xg = static_cast<const float*>(p.x) + bi * p.x_sb;
  const float* dtg = p.dt + bi * p.dt_sb;
  const float* dyg = static_cast<const float*>(p.dy) + rowx;
  float* dxg = static_cast<float*>(p.dx) + rowx;
  const long long prt = (static_cast<long long>(bi) * p.groups + grp) * p.L * p.N;
  float* dBg = p.dBs + prt;          // state partials, zeroed by the wrapper
  float* dCg = p.dCs + prt;
  if (tid < HEADS) dAs[tid] = 0.f;

  for (int q = p.pieces - 1; q >= 0; --q) {
    int t0, tl;
    piece_span(p, q, t0, tl);
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
        Xd[e] = ok ? xg[(t0 + t) * p.x_sl + hi * p.x_sh + j] *
                         dtg[(t0 + t) * p.dt_sl + hi * p.dt_sh]
                   : 0.f;
        dY[e] = ok ? dyg[(static_cast<long long>(t0 + t) * p.H + hi) * p.P + j]
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
        warp_scan<4>(v, lane);
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
        warp_scan<4>(v, lane);
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
        da_dt = warp_sum(da_dt);
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
              xs = fmaf(dxv[j], xg[(t0 + t) * p.x_sl + hi * p.x_sh + jj], xs);
              dxg[(static_cast<long long>(t0 + t) * p.H + hi) * p.P + jj] =
                  dxv[j] * d;
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

    // the group's dG, in the tile layout the reduce launch reads
    float* dst = p.dGp + ((static_cast<long long>(bi) * p.groups + grp) *
                              p.pieces + q) * p.NTILES * 256;
    for (int e = tid; e < p.NTILES * 256; e += THREADS) {
      int t, s;
      frag_pos(e, p.NT, t, s);
      dst[e] = t <= s && s < tl ? dG[s * T4 + t] : 0.f;
    }
  }
  __syncthreads();
  if (tid < nh) p.dAp[static_cast<long long>(bi) * p.H + h0 + tid] = dAs[tid];
}

// ---------------------------------------------------------------------------
// The tensor-core body (bfloat16 x)
// ---------------------------------------------------------------------------
// Launch 1: the scores G^T[t][s] = B[t].C[s] of every causal tile of a
// (row, piece), in three products of the split f32 values, 0 for t > s and
// past the piece.  B and C rows staged in shared memory SCORE_KC columns
// at a time (f32, rows padded by 8 floats); a warp holds at most two tiles.
constexpr int SCORE_KC = 128;
inline size_t scores_smem(const BwdParams& p) {
  return size_t(2) * p.T16 * (SCORE_KC + 8) * sizeof(float);
}

__global__ void __launch_bounds__(SCORE_THREADS)
    ssd_bwd_scores(const BwdParams p) {
  constexpr int SW = SCORE_THREADS / 32, LD = SCORE_KC + 8;
  static_assert(2 * SW >= 10, "a warp holds at most two of the <= 10 tiles");
  extern __shared__ __align__(16) float sc[];
  float* Bs = sc;
  float* Cs = sc + p.T16 * LD;
  const int bi = blockIdx.x / p.pieces, q = blockIdx.x - bi * p.pieces;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t0, tl;
  piece_span(p, q, t0, tl);
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  float c[2][2][4] = {};
  for (int k0 = 0; k0 < p.N16; k0 += SCORE_KC) {
    const int kw = min(SCORE_KC, p.N16 - k0);
    __syncthreads();   // the previous columns are read
    if (p.bc_vec) {    // 16-byte rows: every copy in flight at once
      const int kq = kw / 4;
      for (int e = tid; e < p.T16 * kq; e += SCORE_THREADS) {
        const int t = e / kq, k = 4 * (e - t * kq);
        const bool ok = t < tl && k0 + k < p.N;
        repro::cp_async16(Bs + t * LD + k,
                          ok ? Bg + (t0 + t) * p.b_sl + k0 + k : Bg, ok);
        repro::cp_async16(Cs + t * LD + k,
                          ok ? Cg + (t0 + t) * p.c_sl + k0 + k : Cg, ok);
      }
      repro::cp_async_commit();
      repro::cp_async_wait<0>();
    } else {
      for (int e = tid; e < p.T16 * kw; e += SCORE_THREADS) {
        const int t = e / kw, k = e - t * kw;
        const bool ok = t < tl && k0 + k < p.N;
        Bs[t * LD + k] = ok ? __ldg(Bg + (t0 + t) * p.b_sl + k0 + k) : 0.f;
        Cs[t * LD + k] = ok ? __ldg(Cg + (t0 + t) * p.c_sl + k0 + k) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int u = warp + SW * w;
      if (u >= p.NTILES) break;
      int ti, sj;
      tile_rc(u, p.NT, ti, sj);
      for (int kk = 0; kk < kw; kk += 16) {
        uint32_t ah[4], al[4];
        a_frag(ah, al, [&](int t, int k) { return Bs[t * LD + k]; }, 16 * ti,
               kk, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bh[2], bl[2];
          b_frag(bh, bl, [&](int k, int s) { return Cs[s * LD + k]; }, kk,
                 16 * sj + 8 * h, lane);
          mma3(c[w][h], ah, al, bh, bl);
        }
      }
    }
  }
  float* dst = p.Gp + (static_cast<long long>(bi) * p.pieces + q) * p.NTILES * 256;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int u = warp + SW * w;
    if (u >= p.NTILES) break;
    int ti, sj;
    tile_rc(u, p.NT, ti, sj);
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 16 * ti + (lane >> 2) + 8 * (i >> 1);
        const int s = 16 * sj + 8 * h + 2 * (lane & 3) + (i & 1);
        v[4 * h + i] = t <= s && s < tl ? c[w][h][i] : 0.f;
      }
    float* o = dst + u * 256 + lane * 8;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Launch 2's shared memory (the Python wrapper's bwd_smem_bytes mirrors
// it), in bytes: x and dy of LANES heads (T16 rows of PS = P16 + 8 bf16
// each), one buffer; each lane's dG (NTILES tiles of 256 floats);
// a_cum (float64), a_cum log2(e) (f32, for the weights L), dt, the row sums
// of M, dxd.x (T16 each a head), the
// column sums of M by t tile (NT x T16 a head), dA (a float a head); with
// state terms the q sums (T16), C.(the entering state's dC term) by state
// column chunk (NKC x T16) a head and <dS, S_in> by unit (SU a head).
inline size_t set_layout_mma(BwdParams& p) {
  p.P16 = round16(p.P);
  p.N16 = round16(p.N);
  p.PS = p.P16 + 8;
  p.NKC = (p.N16 + KC - 1) / KC;
  p.SU = (p.P16 / 16) * p.NKC;
  auto a16 = [](size_t v) { return (v + 15) & ~size_t(15); };
  const size_t xy = a16(size_t(LANES) * p.T16 * p.PS * 2);
  const size_t vec = a16(size_t(HEADS) * p.T16 * 4);
  size_t o = 0;
  p.m_xs = int(o);   o += xy;
  p.m_dy = int(o);   o += xy;
  p.m_dg = int(o);   o += a16(size_t(LANES) * p.NTILES * 256 * 4);
  p.m_acum = int(o); o += a16(size_t(HEADS) * p.T16 * 8);
  p.m_acl = int(o);  o += vec;
  p.m_dts = int(o);  o += vec;
  p.m_mrow = int(o); o += vec;
  p.m_dd = int(o);   o += vec;
  p.m_mcol = int(o); o += a16(size_t(HEADS) * p.NT * p.T16 * 4);
  p.m_dA = int(o);   o += a16(size_t(HEADS) * 4);
  p.m_qs = p.m_offp = p.m_sdp = int(o);
  if (p.has_state) {
    p.m_qs = int(o);   o += vec;
    p.m_offp = int(o); o += a16(size_t(HEADS) * p.NKC * p.T16 * 4);
    p.m_sdp = int(o);  o += a16(size_t(HEADS) * p.SU * 4);
  }
  return o;
}

template <bool STATE>
__global__ void __launch_bounds__(MMA_THREADS, STATE ? 2 : MMA_BLOCKS)
    ssd_bwd_mma_kernel(const BwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char sb[];
  const int T16 = p.T16, NT = p.NT, NTILES = p.NTILES, PS = p.PS;
  bf16* xs = reinterpret_cast<bf16*>(sb + p.m_xs);      // [LANES][T16][PS]
  bf16* dys = reinterpret_cast<bf16*>(sb + p.m_dy);     // the same
  float* dgb = reinterpret_cast<float*>(sb + p.m_dg);   // [LANES][NTILES][256]
  double* acum = reinterpret_cast<double*>(sb + p.m_acum);  // [HEADS][T16]
  float* acl = reinterpret_cast<float*>(sb + p.m_acl);      // a_cum log2(e)
  float* dts = reinterpret_cast<float*>(sb + p.m_dts);      // [HEADS][T16]
  float* mrow = reinterpret_cast<float*>(sb + p.m_mrow);    // then d(a_cum)
  float* ddv = reinterpret_cast<float*>(sb + p.m_dd);       // dxd.x
  float* mcol = reinterpret_cast<float*>(sb + p.m_mcol);    // [HEADS][NT][T16]
  float* dAs = reinterpret_cast<float*>(sb + p.m_dA);       // [HEADS]
  float* qsv = reinterpret_cast<float*>(sb + p.m_qs);       // [HEADS][T16]
  float* offp = reinterpret_cast<float*>(sb + p.m_offp);    // [HEADS][NKC][T16]
  float* sdp = reinterpret_cast<float*>(sb + p.m_sdp);      // [HEADS][SU]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x / p.groups;
  const int grp = blockIdx.x - bi * p.groups, h0 = grp * HEADS;
  const int nh = min(HEADS, p.H - h0);
  const int rounds = (nh + LANES - 1) / LANES;
  const int stages = p.pieces * rounds;
  const bf16* xg = static_cast<const bf16*>(p.x) + bi * p.x_sb;
  const float* dtg = p.dt + bi * p.dt_sb;
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  const long long rowx = static_cast<long long>(bi) * p.L * p.H * p.P;
  const bf16* dyg = static_cast<const bf16*>(p.dy) + rowx;
  bf16* dxg = static_cast<bf16*>(p.dx) + rowx;
  const long long prt = (static_cast<long long>(bi) * p.groups + grp) * p.L * p.N;
  auto A_of = [&](int hi) {
    return p.a_bf16 ? __bfloat162float(static_cast<const bf16*>(p.A)[hi])
                    : static_cast<const float*>(p.A)[hi];
  };
  auto states_of = [&](int q, int hi) {
    return p.states +
           ((static_cast<long long>(bi) * (p.pieces - 1) + (q - 1)) * p.H + hi) *
               p.P * p.N;
  };
  if (tid < HEADS) dAs[tid] = 0.f;

  // x and dy of stage k (piece pieces-1 - k / rounds, round k % rounds),
  // zero past the piece and p: 16-byte cp.async where the rows allow
  auto stage = [&](int k) {
    const int q = p.pieces - 1 - k / rounds, r = k % rounds;
    int t0, tl;
    piece_span(p, q, t0, tl);
    const int cpr = p.P16 / 8;
    const int per = LANES * T16 * cpr;
    for (int e = tid; e < 2 * per; e += MMA_THREADS) {
      const bool is_dy = e >= per;
      const int f = is_dy ? e - per : e;
      const int hl = f / (T16 * cpr), rem = f - hl * T16 * cpr;
      const int t = rem / cpr, j0 = 8 * (rem - t * cpr);
      const int g = r * LANES + hl;
      if (g >= nh) continue;
      bf16* dst = (is_dy ? dys : xs) + (hl * T16 + t) * PS + j0;
      if (t >= tl || j0 >= p.P) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const bf16* src =
          is_dy ? dyg + (static_cast<long long>(t0 + t) * p.H + h0 + g) * p.P + j0
                : xg + static_cast<long long>(t0 + t) * p.x_sl +
                      static_cast<long long>(h0 + g) * p.x_sh + j0;
      if (is_dy ? p.dy_vec : p.x_vec) {
        repro::cp_async16(dst, src, true);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = j0 + i < p.P ? src[i] : __float2bfloat16(0.f);
      }
    }
    repro::cp_async_commit();
  };

  stage(0);
  for (int k = 0; k < stages; ++k) {
    const int q = p.pieces - 1 - k / rounds, r = k % rounds;
    int t0, tl;
    piece_span(p, q, t0, tl);
    if (r == 0) {
      // the piece: dG lanes zeroed, dt and a_cum of every head of the block
      // (after the barrier that ended the previous piece's last round)
      for (int e = tid; e < LANES * NTILES * 64; e += MMA_THREADS)
        reinterpret_cast<float4*>(dgb)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = warp; g < nh; g += MMA_WARPS) {
        const float Af = A_of(h0 + g);
        double v[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t = lane + 32 * m;
          const float d =
              t < tl ? dtg[(t0 + t) * p.dt_sl + (h0 + g) * p.dt_sh] : 0.f;
          if (t < T16) dts[g * T16 + t] = d;
          v[m] = static_cast<double>(d) * static_cast<double>(Af);
        }
        warp_scan<2>(v, lane);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t = lane + 32 * m;
          if (t >= T16) continue;
          acum[g * T16 + t] = t < tl ? v[m] : 0.0;
          acl[g * T16 + t] = t < tl ? static_cast<float>(v[m] * LOG2E) : 0.f;
        }
      }
    }
    repro::cp_async_wait<0>();
    __syncthreads();     // stage k, the piece's vectors and dG lanes ready
    const float* Gq = p.Gp + (static_cast<long long>(bi) * p.pieces + q) * NTILES * 256;

    // -- the diagonal block: warp (head lane hl, t-pair tp)
    {
      const int hl = warp >> 1, tp = warp & 1, g = r * LANES + hl;
      if (g < nh) {
        const int hi = h0 + g;
        const bf16* X = xs + hl * T16 * PS;
        const bf16* DY = dys + hl * T16 * PS;
        const double* ac = acum + g * T16;
        const float* dtv = dts + g * T16;
        float* dG = dgb + hl * NTILES * 256;
        const float* dSh =
            STATE ? p.dS + (static_cast<long long>(bi) * p.H + hi) * p.P * p.N
                        : nullptr;
        for (int pass = 0; pass < 2; ++pass) {
          const int ti = pass == 0 ? tp : NT - 1 - tp;
          if (pass == 0 ? 2 * tp > NT - 1 : ti <= tp) break;
          const int r0 = 16 * ti + (lane >> 2), r1 = r0 + 8;
          const double a0 = ac[r0], a1 = ac[r1];
          const float* al = acl + g * T16;
          const float l0 = al[r0], l1 = al[r1];
          const float d0 = dtv[r0], d1 = dtv[r1];
          uint32_t wh[4][4], wl[4][4];   // G L of each s tile, hi and lo
          float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
          for (int sj = 0; sj < 4; ++sj) {
            if (sj < ti || sj >= NT) continue;
            // the score tile, loaded ahead of its products
            const float* gp = Gq + tile_of(ti, sj, NT) * 256 + lane * 8;
            const float4 g0 = __ldg(reinterpret_cast<const float4*>(gp));
            const float4 g1 = __ldg(reinterpret_cast<const float4*>(gp + 4));
            // dW^T[t][s] / dt[t] = x[t].dy[s]
            float c[2][4] = {};
            for (int kk = 0; kk < p.P16; kk += 16) {
              uint32_t a[4], b[4];
              a_rows(a, X, PS, 16 * ti, kk, lane);
              const int mi = lane >> 3;
              repro::ldmatrix_x4(
                  b, DY + (16 * sj + (lane & 7) + 8 * (mi >> 1)) * PS + kk +
                         8 * (mi & 1));
              repro::mma_bf16(c[0], a, b[0], b[1]);
              repro::mma_bf16(c[1], a, b[2], b[3]);
            }
            const int u = tile_of(ti, sj, NT);
            float* D = dG + u * 256 + lane * 8;
            const float4 e0 = ld4(D), e1 = ld4(D + 4);
            const float gv[2][4] = {{g0.x, g0.y, g0.z, g0.w},
                                    {g1.x, g1.y, g1.z, g1.w}};
            float dg[2][4] = {{e0.x, e0.y, e0.z, e0.w}, {e1.x, e1.y, e1.z, e1.w}};
            float w[2][4], cs[2][2] = {};
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const bool lo_row = i < 2;
                const int t = lo_row ? r0 : r1;
                const int s = 16 * sj + 8 * h + 2 * (lane & 3) + (i & 1);
                const float l =
                    t <= s && s < tl ? exp2f(al[s] - (lo_row ? l0 : l1)) : 0.f;
                const float dw = c[h][i] * (lo_row ? d0 : d1);
                const float wk = gv[h][i] * l;
                dg[h][i] = fmaf(dw, l, dg[h][i]);
                const float m = dw * wk;
                if (lo_row) rs0 += m; else rs1 += m;
                cs[h][i & 1] += m;
                w[h][i] = wk;
              }
            *reinterpret_cast<float4*>(D) =
                make_float4(dg[0][0], dg[0][1], dg[0][2], dg[0][3]);
            *reinterpret_cast<float4*>(D + 4) =
                make_float4(dg[1][0], dg[1][1], dg[1][2], dg[1][3]);
            // M's column sums of this tile (over its 16 t rows)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int b2 = 0; b2 < 2; ++b2) {
                float v = cs[h][b2];
                v += __shfl_xor_sync(FULL, v, 4);
                v += __shfl_xor_sync(FULL, v, 8);
                v += __shfl_xor_sync(FULL, v, 16);
                if (lane < 4)
                  mcol[(g * NT + ti) * T16 + 16 * sj + 8 * h + 2 * lane + b2] = v;
              }
            split2(w[0][0], w[0][1], wh[sj][0], wl[sj][0]);
            split2(w[0][2], w[0][3], wh[sj][1], wl[sj][1]);
            split2(w[1][0], w[1][1], wh[sj][2], wl[sj][2]);
            split2(w[1][2], w[1][3], wh[sj][3], wl[sj][3]);
          }
          rs0 += __shfl_xor_sync(FULL, rs0, 1);
          rs0 += __shfl_xor_sync(FULL, rs0, 2);
          rs1 += __shfl_xor_sync(FULL, rs1, 1);
          rs1 += __shfl_xor_sync(FULL, rs1, 2);
          if ((lane & 3) == 0) {
            mrow[g * T16 + r0] = rs0;
            mrow[g * T16 + r1] = rs1;
          }

          // dxd = (G L)^T dy (+ the state's dec dS B), 64 columns a pass
          float dec0 = 0.f, dec1 = 0.f;
          if (STATE) {
            const double atot = ac[tl - 1];
            dec0 = r0 < tl ? expf(static_cast<float>(atot - a0)) : 0.f;
            dec1 = r1 < tl ? expf(static_cast<float>(atot - a1)) : 0.f;
          }
          float dd0 = 0.f, dd1 = 0.f, qs0 = 0.f, qs1 = 0.f;
          for (int jc = 0; jc < p.P16; jc += JC) {
            const int jn = min(JC, p.P16 - jc) >> 3;   // n8 tiles, even
            float acc[JC / 8][4] = {};
            if (STATE) {
              for (int kk = 0; kk < p.N16; kk += 16) {
                uint32_t ah[4], al[4];
                a_frag(ah, al, [&](int t, int kx) {
                  return t < tl && kx < p.N
                             ? __ldg(Bg + static_cast<long long>(t0 + t) * p.b_sl + kx)
                             : 0.f;
                }, 16 * ti, kk, lane);
#pragma unroll
                for (int jj = 0; jj < JC / 8; ++jj) {
                  if (jj >= jn) break;
                  uint32_t bh[2], bl[2];
                  b_frag(bh, bl, [&](int kx, int j) {
                    return j < p.P && kx < p.N
                               ? dSh[static_cast<long long>(j) * p.N + kx]
                               : 0.f;
                  }, kk, jc + 8 * jj, lane);
                  mma3(acc[jj], ah, al, bh, bl);
                }
              }
#pragma unroll
              for (int jj = 0; jj < JC / 8; ++jj) {
                if (jj >= jn) break;
                const int j = jc + 8 * jj + 2 * (lane & 3);
                const float2 x0 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(X + r0 * PS + j));
                const float2 x1 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(X + r1 * PS + j));
                acc[jj][0] *= dec0;
                acc[jj][1] *= dec0;
                acc[jj][2] *= dec1;
                acc[jj][3] *= dec1;
                qs0 = fmaf(x0.x * d0, acc[jj][0], qs0);
                qs0 = fmaf(x0.y * d0, acc[jj][1], qs0);
                qs1 = fmaf(x1.x * d1, acc[jj][2], qs1);
                qs1 = fmaf(x1.y * d1, acc[jj][3], qs1);
              }
            }
#pragma unroll
            for (int sj = 0; sj < 4; ++sj) {
              if (sj < ti || sj >= NT) continue;
#pragma unroll
              for (int jj = 0; jj < JC / 8; jj += 2) {
                if (jj >= jn) break;
                uint32_t b[4];
                const int mi = lane >> 3;
                repro::ldmatrix_x4_trans(
                    b, DY + (16 * sj + (lane & 7) + 8 * (mi & 1)) * PS + jc +
                           8 * jj + 8 * (mi >> 1));
                repro::mma_bf16(acc[jj], wl[sj], b[0], b[1]);
                repro::mma_bf16(acc[jj], wh[sj], b[0], b[1]);
                repro::mma_bf16(acc[jj + 1], wl[sj], b[2], b[3]);
                repro::mma_bf16(acc[jj + 1], wh[sj], b[2], b[3]);
              }
            }
            // dx = dxd dt; dxd.x
#pragma unroll
            for (int jj = 0; jj < JC / 8; ++jj) {
              if (jj >= jn) break;
              const int j = jc + 8 * jj + 2 * (lane & 3);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int t = hh ? r1 : r0;
                const float2 xv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(X + t * PS + j));
                const float v0 = acc[jj][2 * hh], v1 = acc[jj][2 * hh + 1];
                float& dd = hh ? dd1 : dd0;
                dd = fmaf(v0, xv.x, dd);
                dd = fmaf(v1, xv.y, dd);
                if (t < tl && j < p.P) {
                  const float dtt = hh ? d1 : d0;
                  bf16* o = dxg + (static_cast<long long>(t0 + t) * p.H + hi) * p.P + j;
                  if (p.dx_pair) {
                    *reinterpret_cast<__nv_bfloat162*>(o) =
                        __floats2bfloat162_rn(v0 * dtt, v1 * dtt);
                  } else {
                    o[0] = __float2bfloat16(v0 * dtt);
                    if (j + 1 < p.P) o[1] = __float2bfloat16(v1 * dtt);
                  }
                }
              }
            }
          }
          dd0 += __shfl_xor_sync(FULL, dd0, 1);
          dd0 += __shfl_xor_sync(FULL, dd0, 2);
          dd1 += __shfl_xor_sync(FULL, dd1, 1);
          dd1 += __shfl_xor_sync(FULL, dd1, 2);
          qs0 += __shfl_xor_sync(FULL, qs0, 1);
          qs0 += __shfl_xor_sync(FULL, qs0, 2);
          qs1 += __shfl_xor_sync(FULL, qs1, 1);
          qs1 += __shfl_xor_sync(FULL, qs1, 2);
          if ((lane & 3) == 0) {
            ddv[g * T16 + r0] = dd0;
            ddv[g * T16 + r1] = dd1;
            if (STATE) {
              qsv[g * T16 + r0] = qs0;
              qsv[g * T16 + r1] = qs1;
            }
          }
        }
      }
    }

    if (STATE) {
      // dB += dec dt (x dS^T), the round's heads summed in order, per
      // (t tile, 32 state columns); into the group's partials
      for (int u = warp; u < NT * p.NKC; u += MMA_WARPS) {
        const int ti = u / p.NKC, kc = u - ti * p.NKC;
        const int r0 = 16 * ti + (lane >> 2), r1 = r0 + 8;
        float acc[4][4] = {};
        for (int hl = 0; hl < LANES; ++hl) {
          const int g = r * LANES + hl;
          if (g >= nh) break;
          const int hi = h0 + g;
          const bf16* X = xs + hl * T16 * PS;
          const float* dSh = p.dS + (static_cast<long long>(bi) * p.H + hi) * p.P * p.N;
          const double* ac = acum + g * T16;
          const double atot = ac[tl - 1];
          const float s0 = r0 < tl ? expf(static_cast<float>(atot - ac[r0])) *
                                         dts[g * T16 + r0]
                                   : 0.f;
          const float s1 = r1 < tl ? expf(static_cast<float>(atot - ac[r1])) *
                                         dts[g * T16 + r1]
                                   : 0.f;
          float tmp[4][4] = {};
          for (int kk = 0; kk < p.P16; kk += 16) {
            uint32_t a[4];
            a_rows(a, X, PS, 16 * ti, kk, lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              uint32_t bh[2], bl[2];
              b_frag(bh, bl, [&](int j, int kx) {
                return j < p.P && kx < p.N
                           ? dSh[static_cast<long long>(j) * p.N + kx]
                           : 0.f;
              }, kk, kc * KC + 8 * nt, lane);
              mma2(tmp[nt], a, bh, bl);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[nt][i] = fmaf(tmp[nt][i], i < 2 ? s0 : s1, acc[nt][i]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = i < 2 ? r0 : r1;
            const int kx = kc * KC + 8 * nt + 2 * (lane & 3) + (i & 1);
            if (t < tl && kx < p.N)
              p.dBs[prt + static_cast<long long>(t0 + t) * p.N + kx] += acc[nt][i];
          }
      }
      if (q > 0) {
        // dC += exp(a_cum) (dy S_in), heads in order, and each head's
        // C.(its term) by state column chunk
        for (int u = warp; u < NT * p.NKC; u += MMA_WARPS) {
          const int si = u / p.NKC, kc = u - si * p.NKC;
          const int r0 = 16 * si + (lane >> 2), r1 = r0 + 8;
          float acc[4][4] = {};
          for (int hl = 0; hl < LANES; ++hl) {
            const int g = r * LANES + hl;
            if (g >= nh) break;
            const int hi = h0 + g;
            const bf16* DY = dys + hl * T16 * PS;
            const float* Sin = states_of(q, hi);
            const double* ac = acum + g * T16;
            const float e0 = r0 < tl ? expf(static_cast<float>(ac[r0])) : 0.f;
            const float e1 = r1 < tl ? expf(static_cast<float>(ac[r1])) : 0.f;
            float tmp[4][4] = {};
            for (int kk = 0; kk < p.P16; kk += 16) {
              uint32_t a[4];
              a_rows(a, DY, PS, 16 * si, kk, lane);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                uint32_t bh[2], bl[2];
                b_frag(bh, bl, [&](int j, int kx) {
                  return j < p.P && kx < p.N
                             ? __ldg(Sin + static_cast<long long>(j) * p.N + kx)
                             : 0.f;
                }, kk, kc * KC + 8 * nt, lane);
                mma2(tmp[nt], a, bh, bl);
              }
            }
            float o0 = 0.f, o1 = 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int t = i < 2 ? r0 : r1;
                const int kx = kc * KC + 8 * nt + 2 * (lane & 3) + (i & 1);
                const float v = tmp[nt][i] * (i < 2 ? e0 : e1);
                acc[nt][i] += v;
                const float cv =
                    t < tl && kx < p.N
                        ? __ldg(Cg + static_cast<long long>(t0 + t) * p.c_sl + kx)
                        : 0.f;
                if (i < 2) o0 = fmaf(cv, v, o0); else o1 = fmaf(cv, v, o1);
              }
            o0 += __shfl_xor_sync(FULL, o0, 1);
            o0 += __shfl_xor_sync(FULL, o0, 2);
            o1 += __shfl_xor_sync(FULL, o1, 1);
            o1 += __shfl_xor_sync(FULL, o1, 2);
            if ((lane & 3) == 0) {
              offp[(g * p.NKC + kc) * T16 + r0] = o0;
              offp[(g * p.NKC + kc) * T16 + r1] = o1;
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int t = i < 2 ? r0 : r1;
              const int kx = kc * KC + 8 * nt + 2 * (lane & 3) + (i & 1);
              if (t < tl && kx < p.N)
                p.dCs[prt + static_cast<long long>(t0 + t) * p.N + kx] += acc[nt][i];
            }
        }
        __syncthreads();   // every read of the round's dS is done
        // dS_in = exp(a_cum[T-1]) dS + dy^T (exp(a_cum) C), over the head's
        // dS, per (head, 16 rows of p, 32 state columns); <dS, S_in>
        const int JT = p.P16 / 16;
        for (int u = warp; u < LANES * JT * p.NKC; u += MMA_WARPS) {
          const int hl = u / (JT * p.NKC), rem = u - hl * JT * p.NKC;
          const int jt = rem / p.NKC, kc = rem - jt * p.NKC;
          const int g = r * LANES + hl;
          if (g >= nh) continue;
          const int hi = h0 + g;
          const bf16* DY = dys + hl * T16 * PS;
          float* dSh = p.dS + (static_cast<long long>(bi) * p.H + hi) * p.P * p.N;
          const float* Sin = states_of(q, hi);
          const double* ac = acum + g * T16;
          const float etot = expf(static_cast<float>(ac[tl - 1]));
          float tmp[4][4] = {};
          for (int ss = 0; ss < T16; ss += 16) {
            uint32_t a[4];
            const int mi = lane >> 3;
            repro::ldmatrix_x4_trans(
                a, DY + (ss + (lane & 7) + 8 * (mi >> 1)) * PS + 16 * jt +
                       8 * (mi & 1));
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              uint32_t bh[2], bl[2];
              b_frag(bh, bl, [&](int s, int kx) {
                return s < tl && kx < p.N
                           ? expf(static_cast<float>(ac[s])) *
                                 __ldg(Cg + static_cast<long long>(t0 + s) * p.c_sl + kx)
                           : 0.f;
              }, ss, kc * KC + 8 * nt, lane);
              mma2(tmp[nt], a, bh, bl);
            }
          }
          float sd = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 16 * jt + (lane >> 2) + 8 * (i >> 1);
              const int kx = kc * KC + 8 * nt + 2 * (lane & 3) + (i & 1);
              if (j < p.P && kx < p.N) {
                const long long o = static_cast<long long>(j) * p.N + kx;
                const float old = dSh[o];
                sd = fmaf(old, __ldg(Sin + o), sd);
                dSh[o] = fmaf(etot, old, tmp[nt][i]);
              }
            }
          sd = warp_sum(sd);
          if (lane == 0) sdp[g * p.SU + rem] = sd;
        }
      }
    }

    if (r == rounds - 1) {
      __syncthreads();   // every warp's tiles, sums and state terms are in
      // the group's dG (the lanes in order), for the reduce launch
      float4* dst = reinterpret_cast<float4*>(
          p.dGp + ((static_cast<long long>(bi) * p.groups + grp) * p.pieces + q) *
                      NTILES * 256);
      const float4* src = reinterpret_cast<const float4*>(dgb);
      for (int e = tid; e < NTILES * 64; e += MMA_THREADS) {
        float4 v = src[e];
#pragma unroll
        for (int hl = 1; hl < LANES; ++hl) {
          const float4 o = src[hl * NTILES * 64 + e];
          v.x += o.x;
          v.y += o.y;
          v.z += o.z;
          v.w += o.w;
        }
        dst[e] = v;
      }
      // d(a_cum), its reverse running sum in float64, d(dt), dA: a warp a head
      for (int g = warp; g < nh; g += MMA_WARPS) {
        const int hi = h0 + g;
        const double* ac = acum + g * T16;
        const float* dtv = dts + g * T16;
        float* dac = mrow + g * T16;
        float qtot = 0.f, sdot = 0.f;
        if (STATE) {
          float v = 0.f;
          for (int t = lane; t < tl; t += 32) v += qsv[g * T16 + t];
          qtot = warp_sum(v);
          if (q > 0) {
            v = 0.f;
            for (int u = lane; u < p.SU; u += 32) v += sdp[g * p.SU + u];
            sdot = warp_sum(v) * expf(static_cast<float>(ac[tl - 1]));
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t = lane + 32 * m;
          if (t >= tl) continue;
          float d = -dac[t];
          for (int ti = 0; ti <= (t >> 4); ++ti) d += mcol[(g * NT + ti) * T16 + t];
          if (STATE) {
            float o = 0.f;
            if (q > 0)
              for (int kc = 0; kc < p.NKC; ++kc) o += offp[(g * p.NKC + kc) * T16 + t];
            d += o - qsv[g * T16 + t];
            if (t == tl - 1) d += qtot + sdot;
          }
          dac[t] = d;
        }
        __syncwarp();
        double v[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int i = lane + 32 * m;
          v[m] = i < tl ? static_cast<double>(dac[tl - 1 - i]) : 0.0;
        }
        warp_scan<2>(v, lane);
        const float Af = A_of(hi);
        float da_dt = 0.f;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int i = lane + 32 * m;
          if (i >= tl) continue;
          const int t = tl - 1 - i;
          const float da = static_cast<float>(v[m]);
          p.ddt[(static_cast<long long>(bi) * p.L + t0 + t) * p.H + hi] =
              fmaf(Af, da, ddv[g * T16 + t]);
          da_dt = fmaf(da, dtv[t], da_dt);
        }
        da_dt = warp_sum(da_dt);
        if (lane == 0) dAs[g] += da_dt;
      }
    }
    if (k + 1 < stages) {
      __syncthreads();   // the buffer's readers are done
      stage(k + 1);
    }
  }
  __syncthreads();
  if (tid < nh) p.dAp[static_cast<long long>(bi) * p.H + h0 + tid] = dAs[tid];
}

// ---------------------------------------------------------------------------
// The reduce launch, both bodies
// ---------------------------------------------------------------------------
// Per (row, piece, KC columns of n): dG summed over the head groups in
// order (16-byte loads, eight groups in flight), then dC[s] = sum_{t<=s}
// dG[s][t] B[t] and dB[t] = sum_{s>=t} dG[s][t] C[s] in order, after the
// state partials summed over the groups; a thread forms four neighbouring
// columns at once (four independent FMA chains).  B and C are staged by
// 16-byte cp.async where their rows allow, all in flight at once.  The
// first blocks also sum dA over the rows, a warp a head, written in A's
// type.  (One block a (row, piece) for every column, which reads the dG
// partials once, not n / KC times, took longer on the H100: 64 blocks.)
constexpr int LDK = KC + 4;         // B, C rows of the reduce: float4 rows
constexpr int RG = 8;               // groups' dG loads in flight
inline size_t reduce_smem(const BwdParams& p) {
  return (size_t(p.T16) * (p.T16 + 1) + 2 * size_t(p.T16) * LDK) *
         sizeof(float);
}

__device__ void reduce_piece(const BwdParams& p, float* dB, float* dC,
                             int blk, int nch, float* rs) {
  const int T16 = p.T16, LDG = T16 + 1;
  float* Bc = rs;                    // (T16, LDK) B rows, KC columns
  float* Cc = Bc + T16 * LDK;
  float* dGs = Cc + T16 * LDK;       // (T16, T16 + 1) dG[s][t]
  const int ch = blk % nch, rest = blk / nch;
  const int q = rest % p.pieces, bi = rest / p.pieces;
  const int tid = threadIdx.x;
  int t0, tl;
  piece_span(p, q, t0, tl);
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  if (p.bc_vec) {
    for (int e = tid; e < T16 * (KC / 4); e += RED_THREADS) {
      const int t = e / (KC / 4), k = 4 * (e - t * (KC / 4)), kx = ch * KC + k;
      const bool ok = t < tl && kx < p.N;
      repro::cp_async16(Bc + t * LDK + k, ok ? Bg + (t0 + t) * p.b_sl + kx : Bg, ok);
      repro::cp_async16(Cc + t * LDK + k, ok ? Cg + (t0 + t) * p.c_sl + kx : Cg, ok);
    }
    repro::cp_async_commit();
  } else {
#pragma unroll 4
    for (int e = tid; e < T16 * KC; e += RED_THREADS) {
      const int t = e / KC, k = e - t * KC, kx = ch * KC + k;
      const bool ok = t < tl && kx < p.N;
      Bc[t * LDK + k] = ok ? Bg[(t0 + t) * p.b_sl + kx] : 0.f;
      Cc[t * LDK + k] = ok ? Cg[(t0 + t) * p.c_sl + kx] : 0.f;
    }
  }
  const long long gs4 = static_cast<long long>(p.pieces) * p.NTILES * 64;
  const float4* src = reinterpret_cast<const float4*>(p.dGp) +
                      static_cast<long long>(bi) * p.groups * gs4 +
                      static_cast<long long>(q) * p.NTILES * 64;
  for (int e4 = tid; e4 < p.NTILES * 64; e4 += RED_THREADS) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g0 = 0; g0 < p.groups; g0 += RG) {
      float4 a[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        a[i] = g0 + i < p.groups ? src[(g0 + i) * gs4 + e4]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        if (g0 + i >= p.groups) break;
        v.x += a[i].x;
        v.y += a[i].y;
        v.z += a[i].z;
        v.w += a[i].w;
      }
    }
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int t, s;
      frag_pos(4 * e4 + i, p.NT, t, s);
      dGs[s * LDG + t] = vv[i];
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  constexpr int KQ = KC / 4;
  for (int e = tid; e < 2 * tl * KQ; e += RED_THREADS) {
    const bool is_b = e >= tl * KQ;
    const int f = is_b ? e - tl * KQ : e;
    const int row = f / KQ, k = 4 * (f - row * KQ), kx = ch * KC + k;
    if (kx >= p.N) continue;
    const long long o = (static_cast<long long>(bi) * p.L + t0 + row) * p.N + kx;
    float v[4] = {};
    if (p.has_state) {
      const float* part =
          (is_b ? p.dBs : p.dCs) +
          (static_cast<long long>(bi) * p.groups * p.L + t0 + row) * p.N + kx;
      for (int g = 0; g < p.groups; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kx + i < p.N) v[i] += part[static_cast<long long>(g) * p.L * p.N + i];
    }
    if (is_b) {
#pragma unroll 4
      for (int s2 = row; s2 < tl; ++s2) {
        const float w = dGs[s2 * LDG + row];
        const float4 c = ld4(Cc + s2 * LDK + k);
        v[0] = fmaf(w, c.x, v[0]);
        v[1] = fmaf(w, c.y, v[1]);
        v[2] = fmaf(w, c.z, v[2]);
        v[3] = fmaf(w, c.w, v[3]);
      }
    } else {
#pragma unroll 4
      for (int t = 0; t <= row; ++t) {
        const float w = dGs[row * LDG + t];
        const float4 c = ld4(Bc + t * LDK + k);
        v[0] = fmaf(w, c.x, v[0]);
        v[1] = fmaf(w, c.y, v[1]);
        v[2] = fmaf(w, c.z, v[2]);
        v[3] = fmaf(w, c.w, v[3]);
      }
    }
    float* out = (is_b ? dB : dC) + o;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kx + i < p.N) out[i] = v[i];
  }
}

__global__ void __launch_bounds__(RED_THREADS)
    ssd_bwd_reduce(const BwdParams p, float* dB, float* dC, void* dA, int b) {
  extern __shared__ __align__(16) float rs[];
  const int nch = (p.N + KC - 1) / KC;
  const int tid = threadIdx.x;
  if (blockIdx.x < b * p.pieces * nch) reduce_piece(p, dB, dC, blockIdx.x, nch, rs);
  // dA: a warp a head, the first H / (RED_THREADS / 32) blocks; each lane
  // sums rows lane, lane + 32, ... in order, then a butterfly
  const int hh = blockIdx.x * (RED_THREADS / 32) + (tid >> 5);
  if (hh < p.H) {
    float s = 0.f;
    for (int r = tid & 31; r < b; r += 32)
      s += p.dAp[static_cast<long long>(r) * p.H + hh];
    s = warp_sum(s);
    if ((tid & 31) == 0) {
      if (p.a_bf16)
        static_cast<__nv_bfloat16*>(dA)[hh] = __float2bfloat16(s);
      else
        static_cast<float*>(dA)[hh] = s;
    }
  }
}

// The opt-in above 48 KB is made once per kernel, device and size, at the
// first launch, so a CUDA graph that captures later launches records no
// attribute call.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t (&opted)[64]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && smem <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e == cudaSuccess && dev < 64) opted[dev] = smem;
  return e;
}

size_t opted_fma[64], opted_mma[64], opted_mma_state[64], opted_scores[64],
    opted_reduce[64];

}  // namespace repro_ssd_bwd

// dx, ddt, dA, dB, dC of the SSD scan for the upstream gradient dy (and the
// final state's gradient, already in the dS scratch where has_state).
// Scratch: dS (b, h, p, n), with has_state; Gp (b, pieces, tiles, 256)
// with bf16 x; dGp (b, groups, pieces, tiles, 256); dBs, dCs (b, groups,
// l, n), zeroed, with has_state; dAp (b, h).  Two launches on ``stream``
// with f32 x, three with bf16.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* dy, const void* states, void* dS, void* dx, void* ddt,
    void* Gp, void* dGp, void* dBs, void* dCs, void* dAp, void* dB, void* dC,
    void* dA, int x_dtype, int a_dtype, int b, int l, int h, int p, int n,
    int chunk, int has_state, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, void* stream) {
  using namespace repro_ssd_bwd;
  const bool mma = x_dtype == DTYPE_BF16;
  if (b <= 0 || l <= 0 || h <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      l % chunk != 0 || p <= 0 || n <= 0 ||
      (a_dtype != DTYPE_F32 && a_dtype != DTYPE_BF16) ||
      (x_dtype != DTYPE_F32 && x_dtype != DTYPE_BF16) || dGp == nullptr ||
      (mma && Gp == nullptr) ||
      (has_state && (dS == nullptr || dBs == nullptr || dCs == nullptr)))
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
  prm.Gp = static_cast<float*>(Gp);
  prm.dGp = static_cast<float*>(dGp);
  prm.dBs = static_cast<float*>(dBs);
  prm.dCs = static_cast<float*>(dCs);
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
  prm.pieces = (l / chunk) * prm.NPC;
  prm.groups = (h + HEADS - 1) / HEADS;
  prm.T16 = round16(prm.TP);
  prm.NT = prm.T16 / 16;
  prm.NTILES = prm.NT * (prm.NT + 1) / 2;
  if (prm.pieces > 1 && states == nullptr) return cudaErrorInvalidValue;
  prm.bc_vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(C) % 16 == 0 && b_sb % 4 == 0 &&
               b_sl % 4 == 0 && c_sb % 4 == 0 && c_sl % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = b * prm.groups;
  cudaError_t e;
  if (mma) {
    const size_t smem = set_layout_mma(prm);
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    const auto u = reinterpret_cast<uintptr_t>(x);
    const auto v = reinterpret_cast<uintptr_t>(dy);
    prm.x_vec = u % 16 == 0 && p % 8 == 0 && x_sl % 8 == 0 && x_sh % 8 == 0 &&
                x_sb % 8 == 0;
    prm.dy_vec = v % 16 == 0 && p % 8 == 0;
    prm.dx_pair = reinterpret_cast<uintptr_t>(dx) % 4 == 0 && p % 2 == 0;
    const size_t ss = scores_smem(prm);
    if ((e = opt_in(ssd_bwd_scores, ss, opted_scores)) != cudaSuccess) return e;
    ssd_bwd_scores<<<b * prm.pieces, SCORE_THREADS, ss, s>>>(prm);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (has_state) {
      if ((e = opt_in(ssd_bwd_mma_kernel<true>, smem, opted_mma_state)) != cudaSuccess)
        return e;
      ssd_bwd_mma_kernel<true><<<blocks, MMA_THREADS, smem, s>>>(prm);
    } else {
      if ((e = opt_in(ssd_bwd_mma_kernel<false>, smem, opted_mma)) != cudaSuccess)
        return e;
      ssd_bwd_mma_kernel<false><<<blocks, MMA_THREADS, smem, s>>>(prm);
    }
  } else {
    const size_t smem = set_layout(prm);
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    if ((e = opt_in(ssd_bwd_fma_kernel, smem, opted_fma)) != cudaSuccess) return e;
    ssd_bwd_fma_kernel<<<blocks, THREADS, smem, s>>>(prm);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t rsm = reduce_smem(prm);
  if ((e = opt_in(ssd_bwd_reduce, rsm, opted_reduce)) != cudaSuccess) return e;
  const int rblocks = max(b * prm.pieces * ((n + KC - 1) / KC),
                          (h + RED_THREADS / 32 - 1) / (RED_THREADS / 32));
  ssd_bwd_reduce<<<rblocks, RED_THREADS, rsm, s>>>(
      prm, static_cast<float*>(dB), static_cast<float*>(dC), dA, b);
  return cudaGetLastError();
}
