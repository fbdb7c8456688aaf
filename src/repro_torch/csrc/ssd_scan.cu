// Mamba2 SSD chunk scan, CUDA for sm_90a.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan (Pallas TPU, body
// _ssd_kernel): the chunked state-space-duality scan of each (batch, head)
// from a zero state.  For each chunk of length T, with a = dt * A and
// a_cum its running sum inside the chunk:
//   y[s]  = sum_{t<=s} (C[s].B[t]) exp(a_cum[s] - a_cum[t]) x[t] dt[t]
//         + exp(a_cum[s]) C[s] . h                     (h: state entering)
//   h    <- exp(a_cum[T-1]) h + sum_t exp(a_cum[T-1] - a_cum[t]) x[t] dt[t] B[t]^T
// and the last chunk's h is the final state.  Everything is float32 inside,
// as in the Pallas body; y is written in x's type.
//
// Bound on the H100: at the SCOPE prefill shape (b 56, l 49, h 64, p 64,
// n 128, one chunk of 49) the scan does 3.46 GFLOP of f32 arithmetic, 84 %
// of it the state update (2 T p n a (row, head)), and moves 117 MB, mostly
// the f32 final state: 0.0516 ms by f32 operations (67 TFLOP/s), 0.035 ms
// by bytes (3.35 TB/s).  No TF32: the scan is held to a float64 witness
// within 2e-5, so every product is f32 FFMA on the CUDA cores.
//
// Design: every product is f32 FFMA, register-tiled, with 16-byte shared
// loads feeding 4 x 4 outer products:
//   - a block of 256 threads owns one row and a group of GROUP = 4 heads
//     (masked where the group passes h): b * ceil(h / 4) blocks, 896 at
//     the main shape, two blocks an SM (~104 KB of shared memory and 128
//     registers a thread each), which fills the 132 SMs best of 1, 2, 4, 8
//     and 16 heads a block;
//   - it stages B and C of a piece once with 16-byte cp.async and computes
//     the causal scores C[s].B[t] (4 x 4 tiles with t <= s, each in two
//     halves of n summed by neighbouring lanes) into shared memory.  With a
//     single piece (the main shape) all heads of the group reuse them; with
//     two or more pieces they are recomputed per head and piece, since the
//     heads walk the sequence one after another.  B's rows are stored with
//     their 16-byte quads permuted (bq) so the tiles' B loads do not
//     collide in the banks;
//   - per head: a_cum by one warp in float64, x dt (Xd) from x prefetched
//     in 16-byte loads during the previous head's state update, X' = x dt
//     exp(a_total - a_cum) (Xp), and the weights W[s][t] = score
//     exp(a_cum[s] - a_cum[t]) stored transposed, so y_diag = W . Xd is a
//     tiled (T x T)(T x p) product of float4 loads;
//   - the head's state (p x n) is held in registers only during its
//     update: a thread holds STATE_TILES 4 x 4 tiles (8 rows x 4 columns of
//     64 x 128 at 256 threads), updated as the rank-T product Xp^T B, three
//     float4 loads for 32 FFMAs; with a single piece a warp goes from its y
//     tiles to its state tiles without a barrier;
//   - the state goes to device memory once a head, in 16-byte stores; from
//     the second piece on it is kept in shared memory between pieces, and
//     y adds (exp(a_cum) C) . h^T, tiled like the scores (the main shape
//     never does);
//   - optionally (``states``, for the backward kernel ssd_scan_bwd.cu) the
//     state entering every piece but the first goes to device memory too,
//     written where it is kept between pieces; the serve path passes none,
//     and y and the final state keep their bits either way.
// A chunk longer than MAX_PIECE is walked in pieces of at most MAX_PIECE
// positions (two of 64 at T = 128): the same recurrence, cut finer, so
// that shared memory stays under 227 KB.  Summation orders, which
// tests/test_torch_ssm.py emulates on the CPU: each score over k in order
// within the halves [0, kh) and [kh, n) (kh = 4 floor(n4 / 8), n4 = n
// rounded up to 4), then lo + hi; y_diag over t in
// order (W is 0 for t > s), then + (exp(a_cum[s]) C[s]) . h[j] over k in
// order; the state h <- exp(a_total) h, then + Xp[t] B[t] over t in
// order.  a_cum is summed in float64 from the exact products dt * A, and
// each exponent (a difference of two such sums) is rounded once to f32.
// x, dt, B and C are read through their strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace repro_ssd {

constexpr int THREADS = 256;
constexpr int GROUP = 4;            // heads a block
constexpr int MAX_CHUNK = 128;
constexpr int MAX_PIECE = 64;       // positions of a chunk staged at once
constexpr int STATE_TILES = 2;      // 4 x 4 state tiles a thread holds
constexpr size_t MAX_SMEM = 232448; // 227 KB of dynamic shared memory

// dtype codes shared with the Python wrapper
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

struct SsdParams {
  const void* x;       // (b, l, h, p), strided, last dim contiguous
  const float* dt;     // (b, l, h), strided
  const void* A;       // (h,), contiguous
  const float* B;      // (b, l, n), strided, last dim contiguous
  const float* C;      // (b, l, n), strided, last dim contiguous
  void* y;             // (b, l, h, p), contiguous, x's type
  float* state;        // (b, h, p, n), contiguous
  float* states;       // (b, pieces - 1, h, p, n), contiguous, or null: the
                       // state entering piece q + 1 at q
  int a_bf16;
  int bc_vec;          // B and C rows 16-byte aligned: cp.async them
  int x_vec;           // x rows 16-byte aligned, p a multiple of 16 bytes
  int H, L, P, N, T;
  int TP, NPC;         // piece length, pieces a chunk
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl;
  // derived on the host (set_layout), read from the parameter bank
  int T4, P4, N4, NS;  // piece, p and n rounded up to 4; B, C, h row stride
  int CQ, RB, RQ;      // state column quads, row quads a band, row quads
  int R, JQ, GP;       // score tiles a side, y column quads, x groups a row
  int pieces, groups;  // pieces of the sequence, head groups of a row
  int SWM;             // B's swizzle mask (see bq)
  int o_cs, o_st, o_wt, o_xd, o_xp, o_dts, o_acum, o_decay, o_hs;  // floats
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
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
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

// Float offset of B's 16-byte quad kq in row t of Bs: the quads of a row
// are permuted by XOR with (t / 4) & swm, so that the score tiles' B loads
// (rows 4 tq + j of 8 consecutive tq at one kq) fall in 8 different bank
// groups, and a row read across the lanes stays conflict-free.
__device__ __forceinline__ int bq(int t, int kq, int swm) {
  return 4 * (kq ^ ((t >> 2) & swm));
}

// acc[i][j] += sum_{k0 <= k < k1} (scale[i] A[i][k]) Bm[t0 + j][k] over k
// in order: the four rows of A at `a`, rows t0 + j of Bm at `b` with its
// quads swizzled by swm (0: none), row stride ld, k0 and k1 multiples of 4
template <bool SCALED>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a,
                                         const float* b, int t0, int ld,
                                         int k0, int k1, int swm,
                                         const float (&scale)[4]) {
  for (int k = k0; k < k1; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ld4(a + i * ld + k);
      if (SCALED) {
        av[i].x *= scale[i];
        av[i].y *= scale[i];
        av[i].z *= scale[i];
        av[i].w *= scale[i];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      const float4 bv = ld4(b + t * ld + bq(t, k / 4, swm));
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

// x for Xd, in batches a thread keeps in flight.  Vector path (x rows
// 16-byte aligned, p a multiple of VE): XV = 2 16-byte loads of VE values
// (8 registers), groups g = g0 + u THREADS + tid of the piece's tl x
// (p / VE) groups.  Other x layouts take a plain loop of 2-byte or
// 4-byte loads (no shape of the model's does).
constexpr int XV = 2;                               // loads in a batch
template <typename TX> constexpr int VE = 16 / sizeof(TX);  // x values
template <typename TX>
__device__ __forceinline__ void load_x_vec(uint4 (&xr)[XV], const TX* x,
                                           long long x_sl, int t0, int tl,
                                           int GP, int g0) {
#pragma unroll
  for (int u = 0; u < XV; ++u) {
    const int g = g0 + u * THREADS + static_cast<int>(threadIdx.x);
    const int t = g / GP, jg = g - t * GP;
    if (t < tl)
      xr[u] =
          *reinterpret_cast<const uint4*>(x + (t0 + t) * x_sl + jg * VE<TX>);
  }
}

__device__ __forceinline__ void unpack(const uint4 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 pairs, the first in the low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Pieces a chunk and their length: a chunk of T splits into
// ceil(T / MAX_PIECE) pieces of ceil(T / pieces), the last one shorter.
__host__ __device__ __forceinline__ int pieces_of(int T) {
  return (T + MAX_PIECE - 1) / MAX_PIECE;
}
__host__ __device__ __forceinline__ int piece_len(int T) {
  const int n = pieces_of(T);
  return (T + n - 1) / n;
}

// The sizes and shared-memory offsets the kernel derives from p's shape,
// and the floats of dynamic shared memory a block takes (the Python
// wrapper's smem_bytes mirrors them): B and C rows, scores and weights,
// x dt and X', dt, a_cum (f64) and the decays, and, where the sequence
// has more than one piece, the entering state staged between pieces.
inline size_t set_layout(SsdParams& p, int ve) {
  p.T4 = round4(p.TP);
  p.P4 = round4(p.P);
  p.N4 = round4(p.N);
  p.NS = p.N4 + 4;
  p.CQ = p.N4 / 4;
  p.RB = THREADS / p.CQ;
  p.RQ = p.P4 / 4;
  p.R = p.T4 / 4;
  p.JQ = p.P4 / 4;
  p.GP = p.P / ve;
  p.SWM = 1;  // the largest power of two dividing CQ, at most 8, less one
  while (p.SWM < 8 && p.CQ % (2 * p.SWM) == 0) p.SWM *= 2;
  p.SWM -= 1;
  p.pieces = (p.L / p.T) * p.NPC;
  p.groups = (p.H + GROUP - 1) / GROUP;
  p.o_cs = p.T4 * p.NS;                  // after B
  p.o_st = p.o_cs + p.T4 * p.NS;
  p.o_wt = p.o_st + p.T4 * p.T4;
  p.o_xd = p.o_wt + p.T4 * p.T4;
  p.o_xp = p.o_xd + p.T4 * p.P4;
  p.o_dts = p.o_xp + p.T4 * p.P4;
  p.o_acum = p.o_dts + p.T4;             // T4 doubles
  p.o_decay = p.o_acum + 2 * p.T4;
  p.o_hs = p.o_decay + p.T4;
  return size_t(p.o_hs) + (p.pieces > 1 ? size_t(p.P4) * p.NS : 0);
}

// Whether a thread's STATE_TILES tiles cover the (P, N) state.
inline bool state_fits(int P, int N) {
  const int cq = round4(N) / 4, rq = round4(P) / 4;
  return cq <= THREADS && rq <= (THREADS / cq) * STATE_TILES;
}

template <typename TX>
__global__ void __launch_bounds__(THREADS, 2) ssd_kernel(const SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int T4 = p.T4, P4 = p.P4, N4 = p.N4, NS = p.NS;
  float* Bs = smem;                      // (T4, NS) B rows of the piece
  float* Cs = smem + p.o_cs;             // (T4, NS) C rows
  float* St = smem + p.o_st;             // (T4, T4) St[t][s] = C[s].B[t]
  float* Wt = smem + p.o_wt;             // (T4, T4) Wt[t][s] = W[s][t]
  float* Xd = smem + p.o_xd;             // (T4, P4) x dt
  float* Xp = smem + p.o_xp;             // (T4, P4) x dt exp(a_tot - a_cum)
  float* dts = smem + p.o_dts;           // (T4) dt
  double* acum = reinterpret_cast<double*>(smem + p.o_acum);  // (T4) a_cum
  float* decay = smem + p.o_decay;       // (T4) exp(a_total - a_cum)
  float* hs = smem + p.o_hs;             // (P4, NS) the entering state

  const int bi = blockIdx.x / p.groups;
  const int h0 = (blockIdx.x - bi * p.groups) * GROUP;
  const int tid = threadIdx.x;
  const int pieces = p.pieces;
  const bool share_scores = pieces == 1;
  const float* Bg = p.B + bi * p.b_sb;
  const float* Cg = p.C + bi * p.c_sb;
  const TX* xg = static_cast<const TX*>(p.x) + bi * p.x_sb;
  const float* dtg = p.dt + bi * p.dt_sb;
  TX* y = static_cast<TX*>(p.y);

  // this thread's state tiles: column quad cq, row quads rq[i] = rq0 + i RB
  // where that is a row quad of the state (mine[i]); the others, clamped
  // to the last row quad, are computed and never written, so the update
  // loop has no branch
  const int CQ = p.CQ, RB = p.RB, RQ = p.RQ;
  const int cq = tid % CQ, rq0 = tid / CQ;
  int rq[STATE_TILES];
  bool mine[STATE_TILES];
#pragma unroll
  for (int i = 0; i < STATE_TILES; ++i) {
    mine[i] = tid < RB * CQ && rq0 + i * RB < RQ;
    rq[i] = min(rq0 + i * RB, RQ - 1);
  }
  const int R = p.R, JQ = p.JQ;          // tiles of the scores and of y

  // x and dt of the next piece, fetched during this piece's state update
  const int GP = p.GP;                   // vector path: groups a row of x
  uint4 xr[XV];
  float dnext = 0.f;
  bool ahead = false;

  for (int g = 0; g < GROUP; ++g) {
    const int hi = h0 + g;
    if (hi >= p.H) break;                // the same for the whole block
    const float A =
        p.a_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.A)[hi])
            : static_cast<const float*>(p.A)[hi];
    const TX* x = xg + hi * p.x_sh;
    const float* dt = dtg + hi * p.dt_sh;
    for (int q = 0; q < pieces; ++q) {
      const int c = q / p.NPC, r = q - c * p.NPC;
      const int t0 = c * p.T + r * p.TP;
      const int tl = min(p.TP, p.T - r * p.TP);
      const bool stage = !share_scores || g == 0;
      __syncthreads();  // the previous piece is done with every buffer

      // B and C rows [0, T4) of the piece, zero past tl and past N
      if (stage) {
        for (int e = tid; e < T4 * CQ; e += THREADS) {
          const int t = e / CQ, k = 4 * (e - t * CQ);
          const bool in = t < tl;
          const long long row = t0 + (in ? t : 0);
          if (p.bc_vec) {
            repro::cp_async16(Bs + t * NS + bq(t, k / 4, p.SWM),
                              Bg + row * p.b_sl + k, in);
            repro::cp_async16(Cs + t * NS + k, Cg + row * p.c_sl + k, in);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool ok = in && k + u < p.N;
              Bs[t * NS + bq(t, k / 4, p.SWM) + u] =
                  ok ? Bg[row * p.b_sl + k + u] : 0.f;
              Cs[t * NS + k + u] = ok ? Cg[row * p.c_sl + k + u] : 0.f;
            }
          }
        }
        repro::cp_async_commit();
      }
      // the first batch of x in flight across the barrier (the previous
      // piece's state update may have fetched it already), and dt
      const int XG = tl * GP;                  // vector path: groups of x
      if (p.x_vec && !ahead) load_x_vec(xr, x, p.x_sl, t0, tl, GP, 0);
      if (tid < T4)  // T4 <= MAX_PIECE <= THREADS
        dts[tid] = ahead ? dnext : tid < tl ? dt[(t0 + tid) * p.dt_sl] : 0.f;
      repro::cp_async_wait<0>();
      __syncthreads();

      // x dt (everyone, first: its registers are free for the scores),
      // a_cum (warp 7), scores (warps 0-6).  A score tile takes rows
      // s = sq + R i and t = tq + R j (i, j < 4): the 8 lanes of a
      // shared-load phase then read 8 different B rows in 8 different bank
      // groups; all R x R tiles are computed, t > s is masked in W.
      if (p.x_vec) {
        for (int g0 = 0; g0 < XG; g0 += XV * THREADS) {
          if (g0 > 0) load_x_vec(xr, x, p.x_sl, t0, tl, GP, g0);
#pragma unroll
          for (int u = 0; u < XV; ++u) {
            const int g = g0 + u * THREADS + tid;
            if (g < XG) {
              const int t = g / GP, j = (g - t * GP) * VE<TX>;
              float v[VE<TX>];
              unpack(xr[u], v);
              const float d = dts[t];
#pragma unroll
              for (int w = 0; w < VE<TX>; w += 4)
                *reinterpret_cast<float4*>(Xd + t * P4 + j + w) =
                    make_float4(v[w] * d, v[w + 1] * d, v[w + 2] * d,
                                v[w + 3] * d);
            }
          }
        }
      } else {
        for (int e = tid; e < T4 * P4; e += THREADS) {
          const int t = e / P4, j = e - t * P4;
          Xd[e] = (t < tl && j < p.P)
                      ? to_f32(x[(t0 + t) * p.x_sl + j]) * dts[t]
                      : 0.f;
        }
      }
      if (tid >= THREADS - 32) {
        // a = dt * A in f64 (exact for f32 dt and A) and its inclusive scan
        // over the piece (at most 64 = two values a lane), Kogge-Stone over
        // the warp: every exponent below is a difference of f64 sums,
        // rounded once to f32
        const int lane = tid & 31;
        const double Ad = A;
        double v0 = lane < tl ? dts[lane] * Ad : 0.0;
        double v1 = lane + 32 < tl ? dts[lane + 32] * Ad : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double o0 = __shfl_up_sync(0xffffffffu, v0, off);
          const double o1 = __shfl_up_sync(0xffffffffu, v1, off);
          if (lane >= off) {
            v0 += o0;
            v1 += o1;
          }
        }
        v1 += __shfl_sync(0xffffffffu, v0, 31);
        const double a_tot = tl <= 32 ? __shfl_sync(0xffffffffu, v0, tl - 1)
                                      : __shfl_sync(0xffffffffu, v1, tl - 33);
        if (lane < tl) {
          acum[lane] = v0;
          decay[lane] = expf(static_cast<float>(a_tot - v0));
        }
        if (lane + 32 < tl) {
          acum[lane + 32] = v1;
          decay[lane + 32] = expf(static_cast<float>(a_tot - v1));
        }
      }
      if (stage && tid < THREADS - 32) {
        // the causal 4 x 4 tiles (tq <= sq), each in two halves of k summed
        // by neighbouring lanes, then added: lo + hi
        const int lane = tid & 31, pairs = R * (R + 1);  // 2 x tiles
        const int kh = (N4 / 8) * 4;                      // the halves' split
        const float unscaled[4] = {};
        for (int e0 = tid - lane; e0 < pairs; e0 += THREADS - 32) {
          const int e = e0 + lane, tile = e >> 1, half = e & 1;
          int sq = static_cast<int>((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
          while ((sq + 1) * (sq + 2) / 2 <= tile) ++sq;
          while (sq * (sq + 1) / 2 > tile) --sq;
          const int tq = tile - sq * (sq + 1) / 2;
          float acc[4][4] = {};
          if (e < pairs)
            dot_tile<false>(acc, Cs + 4 * sq * NS, Bs, 4 * tq, NS,
                            half ? kh : 0, half ? N4 : kh, p.SWM, unscaled);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float o = __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
              acc[i][j] = half ? acc[i][j] : acc[i][j] + o;
            }
          if (e < pairs && !half) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<float4*>(St + (4 * tq + j) * T4 + 4 * sq) =
                  make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          }
        }
      }
      __syncthreads();

      // this head's weights and X'
      const double a_total = acum[tl - 1];
#pragma unroll 2
      for (int e = tid; e < tl * R; e += THREADS) {  // row t, columns s0..+3
        const int t = e / R, s0 = 4 * (e - t * R);
        const float4 sc = ld4(St + t * T4 + s0);
        const double at = acum[t];
        const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = (t <= s0 + u && s0 + u < tl)
                     ? sv[u] * expf(static_cast<float>(acum[s0 + u] - at))
                     : 0.f;
        *reinterpret_cast<float4*>(Wt + t * T4 + s0) =
            make_float4(w[0], w[1], w[2], w[3]);
      }
      for (int e = tid; e < T4 * JQ; e += THREADS) {  // rows past tl: 0
        const int t = e / JQ;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < tl) {
          v = ld4(Xd + 4 * e);
          const float d = decay[t];
          v = make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
        }
        *reinterpret_cast<float4*>(Xp + 4 * e) = v;
      }
      __syncthreads();

      // y = W . Xd (+ (exp(a_cum) C) . h^T) in 4 x 4 tiles, then the state
      // update; with a single piece the two share no buffer, so a warp
      // done with its y tiles goes on to its state tiles without a barrier
      for (int e = tid; e < R * JQ; e += THREADS) {
        const int sq = e / JQ, jq = e - sq * JQ;
        const int s0 = 4 * sq, j0 = 4 * jq;
        float acc[4][4] = {};  // [s][j]
        const int tend = min(tl, s0 + 4);
        for (int t = 0; t < tend; ++t) {
          const float4 w = ld4(Wt + t * T4 + s0);
          const float wa[4] = {w.x, w.y, w.z, w.w};
          outer4(acc, wa, ld4(Xd + t * P4 + j0));
        }
        if (q > 0) {  // + (exp(a_cum[s]) C[s]) . h[j], over k in order
          float eo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            eo[i] = s0 + i < tl ? expf(static_cast<float>(acum[s0 + i])) : 0.f;
          dot_tile<true>(acc, Cs + s0 * NS, hs, j0, NS, 0, N4, 0, eo);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (s0 + i >= tl) break;
          TX* yrow = y + ((static_cast<long long>(bi) * p.L + t0 + s0 + i) *
                              p.H + hi) * p.P;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j0 + j < p.P) yrow[j0 + j] = from_f32<TX>(acc[i][j]);
        }
      }
      if (pieces > 1) __syncthreads();  // hs: read above, written below

      // the next piece's x and dt go in flight first
      {
        int ng = g, nq = q + 1;
        if (nq == pieces) ++ng, nq = 0;
        const int nhi = h0 + ng;
        ahead = p.x_vec && ng < GROUP && nhi < p.H;
        if (ahead) {
          const int nc = nq / p.NPC, nr = nq - nc * p.NPC;
          const int nt0 = nc * p.T + nr * p.TP;
          const int ntl = min(p.TP, p.T - nr * p.TP);
          load_x_vec(xr, xg + nhi * p.x_sh, p.x_sl, nt0, ntl, GP, 0);
          dnext = tid < ntl ? dtg[nhi * p.dt_sh + (nt0 + tid) * p.dt_sl] : 0.f;
        }
      }

      // h <- exp(a_total) h + sum_t Xp[t]^T B[t], in registers: zero at the
      // first piece, else this thread's tiles of the entering state in hs
      float h[STATE_TILES][4][4];
      const float e_total = expf(static_cast<float>(a_total));
#pragma unroll
      for (int i = 0; i < STATE_TILES; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q > 0) v = ld4(hs + (4 * rq[i] + u) * NS + 4 * cq);
          h[i][u][0] = v.x * e_total;
          h[i][u][1] = v.y * e_total;
          h[i][u][2] = v.z * e_total;
          h[i][u][3] = v.w * e_total;
        }
      // four rows a step, one swizzle each: rows tl..T4 - 1 of Xp and B
      // are 0 and leave h as it is
      for (int t4 = 0; t4 < tl; t4 += 4) {
        const float* brow = Bs + t4 * NS + bq(t4, cq, p.SWM);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 bv = ld4(brow + u * NS);
#pragma unroll
          for (int i = 0; i < STATE_TILES; ++i) {
            const float4 xv4 = ld4(Xp + (t4 + u) * P4 + 4 * rq[i]);
            const float xa[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
            outer4(h[i], xa, bv);
          }
        }
      }

      // the state leaves the registers once a piece: into hs for the next
      // piece (its y reads it after the next barrier), or, after the last
      // piece, to device memory, 16 bytes a store where n allows
      const bool last = q + 1 == pieces;
      float* st =
          p.state + (static_cast<long long>(bi) * p.H + hi) * p.P * p.N;
#pragma unroll
      for (int i = 0; i < STATE_TILES; ++i) {
        if (!mine[i]) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * rq[i] + u, k = 4 * cq;
          const float4 v =
              make_float4(h[i][u][0], h[i][u][1], h[i][u][2], h[i][u][3]);
          if (!last) {
            *reinterpret_cast<float4*>(hs + j * NS + k) = v;
            if (p.states != nullptr && j < p.P) {
              float* sv = p.states + ((static_cast<long long>(bi) *
                                           (pieces - 1) + q) * p.H + hi) *
                                         p.P * p.N;
              if (p.N % 4 == 0) {
                *reinterpret_cast<float4*>(sv + j * p.N + k) = v;
              } else {
#pragma unroll
                for (int w = 0; w < 4; ++w)
                  if (k + w < p.N) sv[j * p.N + k + w] = h[i][u][w];
              }
            }
          } else if (j < p.P) {
            if (p.N % 4 == 0) {
              *reinterpret_cast<float4*>(st + j * p.N + k) = v;
            } else {
#pragma unroll
              for (int w = 0; w < 4; ++w)
                if (k + w < p.N) st[j * p.N + k + w] = h[i][u][w];
            }
          }
        }
      }
    }
  }
}

// Launch with `smem` bytes of dynamic shared memory.  The opt-in above 48 KB
// is made once per instantiation, device and size — at the first launch,
// so a CUDA graph that captures later launches records no attribute call.
template <typename TX>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const SsdParams& p) {
  constexpr int MAX_DEVICES = 64;
  static size_t opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > opted_in[dev])) {
    e = cudaFuncSetAttribute(ssd_kernel<TX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted_in[dev] = smem;
  }
  ssd_kernel<TX><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

inline bool aligned16(const void* ptr, long long sb, long long sl) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
         sl % 4 == 0;
}

}  // namespace repro_ssd

extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    void* y, void* state, void* states, int x_dtype, int a_dtype, int b,
    int l, int h, int p, int n, int chunk, long long x_sb, long long x_sl,
    long long x_sh, long long dt_sb, long long dt_sl, long long dt_sh,
    long long b_sb, long long b_sl, long long c_sb, long long c_sl,
    void* stream) {
  using namespace repro_ssd;
  if (b <= 0 || l <= 0 || h <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      l % chunk != 0 || p <= 0 || n <= 0 || !state_fits(p, n) ||
      (a_dtype != DTYPE_F32 && a_dtype != DTYPE_BF16))
    return cudaErrorInvalidValue;
  const int bc_vec =
      n % 4 == 0 && aligned16(B, b_sb, b_sl) && aligned16(C, c_sb, c_sl);
  const int ve = x_dtype == DTYPE_BF16 ? 8 : 4;  // x values in 16 bytes
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && p % ve == 0 &&
                    x_sb % ve == 0 && x_sl % ve == 0 && x_sh % ve == 0;
  SsdParams prm{x, static_cast<const float*>(dt), A,
                static_cast<const float*>(B), static_cast<const float*>(C), y,
                static_cast<float*>(state), static_cast<float*>(states),
                a_dtype == DTYPE_BF16, bc_vec,
                x_vec, h, l, p, n, chunk, piece_len(chunk), pieces_of(chunk),
                x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl};
  const size_t smem = set_layout(prm, ve) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = b * prm.groups;
  if (x_dtype == DTYPE_BF16) return launch<__nv_bfloat16>(blocks, smem, s, prm);
  if (x_dtype == DTYPE_F32) return launch<float>(blocks, smem, s, prm);
  return cudaErrorInvalidValue;
}
