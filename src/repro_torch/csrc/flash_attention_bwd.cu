// Flash attention backward, CUDA for sm_90a: dQ, dK and dV of the function
// flash_attention.cu computes.
//
// Replaces no Pallas kernel: the reference trains through ref.attention
// (repro/kernels/ops.py sends every training length to it) and XLA derives
// the gradient under jax.checkpoint (repro/models/transformer.py).  The
// port's full-sequence attention on the card is the hand-written forward
// kernel, which autograd cannot see through, so its gradient is this
// kernel.  It covers all the forward takes: GQA (dK and dV summed over the
// q-heads of a group), causal with q_offset of either sign, a sliding
// window, softcap (the gradient through cap tanh(x / cap) is dS (1 - t^2)),
// dv != d, f32 and bf16 inputs, strided views with a contiguous last dim.
// Head dims: any pair of 32, 64, 128 and 256, MLA's (d, dv) = (192, 128)
// (deepseek-v2-lite's nope + rope with its v) and (48, 32) (its reduced
// config), and d = dv = 112 (zamba2-7b's
// tied attention block): a 112-wide row is 14 16-byte chunks and 7 mma
// k-steps, so the row loaders take a ragged last pass (load_rows,
// flash_common.cuh; the dQ kernel's own Q / dO rows), the f32 kernels'
// accumulator tiles are 16 columns wide (Owned), and every mma loop runs
// over 16-column slices one at a time (ldmatrix x4 pairs 8-wide n-tiles,
// never k-steps), so the odd count of k-steps needs no pairing.  MLA's
// pairs take the same bodies: 192 and 48 are multiples of 16 (12 and 3
// k-steps, 24 and 6 chunks a row, which the row loaders walk in ragged
// passes as at 112); at (192, 128) the dQ block keeps 24 n-tiles of dQ a
// warp (96 f32, as 128 at d 256) and runs one block an SM, and d + dv =
// 320 splits dK/dV's columns over 8 warps (96 + 64 a warp); the f32
// kernels own 16-row tiles of 192 columns as 3 a thread (Owned: W 64) and
// of 48 as 3 (W 16).  The scale is the forward's, passed explicitly (MLA's
// (nope + rope)^-0.5, not v's dim).
// A query row with no valid key gets zero gradient, as the forward writes
// it zero output.  Each row's log-sum-exp comes from the forward (its
// ``lse`` output), so no launch recomputes it.
//
// Bound on the H100: at the SFT shape (q (64, 32, 57, 128), k/v (64, 8, 57,
// 128), bf16, causal) the call moves ~149 MB of q, k, v, o, dO, dq, dk, dv
// once and needs ~4.3 GFLOP of products (~4 us at the bf16 tensor-core
// peak): bytes bound it (~45 us at 3.35 TB/s).  Q and dO are read by both
// launches and K/V by every dQ block of their group, mostly from L2.
//
// Two launches, dQ first, no atomics, so two calls give the same bits.
//
// bf16 (the training path), every product on mma.sync.m16n8k16 (bf16 in,
// f32 accumulate), tiles loaded with 16-byte cp.async into rows padded by
// 16 bytes that ldmatrix reads without bank conflicts (mma_bf16.cuh):
//   dq:   one block per (batch, kv-head, 64 position-major rows of the
//         group: row = qi * group + head), as the forward packs them, so
//         every K/V tile it loads feeds all the group's q-heads.  Each warp
//         owns 16 rows.  Prologue: delta = rowsum(dO o O) in f32 for its
//         rows, written to scratch for the dkdv launch.  Over 32-key tiles
//         of the block's keys, two in flight: S = Q K^T and dP = dO V^T on
//         mma, P = 2^(x c - lse log2 e) (x the score, softcapped or not, c
//         as the forward's exponent), dS = P (dP - delta) (1 - t^2 under
//         softcap), dQ += dS K with dS rounded to bf16 as mma's A operand
//         straight from the registers; dQ times the scale at the end.
//   dkdv: one block per (batch, kv-head, 64 keys); K and V stay in shared
//         memory, each warp owns 16 keys (and, where d + dv > 256, half of
//         their dK/dV columns: 8 warps).  The block walks the rows of the
//         group that may see its keys, position-major, 32 at a time, the Q
//         and dO tiles double-buffered, with each row's key interval, lse
//         and delta.  Per tile, transposed so that a key is a row of every
//         product and no operand goes through shared memory: S^T = K Q^T,
//         dP^T = V dO^T, P^T and dS^T element by element, dV += P^T dO with
//         P rounded to bf16 as the forward rounds it, dK += dS^T Q (times
//         the scale at the end).  A warp skips the tiles none of whose rows
//         sees its keys (the causal triangle).  All accumulators are f32 in
//         registers; dK/dV are staged through the K/V tiles and written in
//         16-byte pieces.
//
// f32 (FMA kernels, which keep the 2e-5 parity tensor cores cannot):
//   dq:   one block per (batch, q-head, 16 query rows): delta in the
//         prologue (8 strided partial sums a row, combined in a fixed
//         butterfly), then the key tiles the rows see, dQ += scale dS K;
//   dkdv: one block per (batch, kv-head, 16 keys): loops over the group's
//         q-heads and the query rows that see its keys, 16 at a time,
//         recomputes P = exp(x - lse), dV += P^T dO, dP = dO V^T,
//         dS = P (dP - delta), dK += scale dS^T Q.
// Every f32 score is the same sequential f32 dot product of the scaled q
// row and the k row, as the forward's.
#include <initializer_list>

#include "flash_common.cuh"

namespace repro {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;  // dO
  void* dq;       // (b, hq, sq, d), contiguous
  void* dk;       // (b, hkv, sk, d), contiguous
  void* dv;       // (b, hkv, sk, dv), contiguous
  const float* lse;  // (b, hq, sq): the forward's log-sum-exp of each row
  float* delta;      // (b, hq, sq) scratch, written by the dq launch
  int hq, group, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;
  int causal, window, q_offset;
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// f32: FMAs out of shared memory
// ---------------------------------------------------------------------------
constexpr int BQ = 16;  // query rows of a tile
constexpr int BKB = 16;  // keys of a tile
constexpr int LDS = BKB + 1;  // row stride of a (BQ x BKB) score tile

static_assert(BQ == BKB, "query and key tiles share load_rows_f32");

// BQ rows of ``src`` (row stride ``ss``) from row ``r0`` into shared memory
// as f32 times ``mul``, ``N + 1`` floats a row; rows at or past ``n`` are 0
template <int N, typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src,
                                              long long ss, int r0, int n,
                                              float mul) {
  for (int e = threadIdx.x; e < BQ * N; e += THREADS) {
    const int r = e / N, c = e - r * N;
    dst[r * (N + 1) + c] =
        r0 + r < n ? to_f32(src[(r0 + r) * ss + c]) * mul : 0.f;
  }
}

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Which entries of a (ROWS x N) accumulator tile a thread owns: W threads
// across a row, RP rows a pass; thread t owns rows t / W + RP * r (r < R)
// at columns t % W + W * c (c < C), so every address is a base plus a
// compile-time offset and a warp reads consecutive columns of one row.  W
// is the largest width that divides both N and the thread count: N itself
// up to 128 for the power-of-two dims, 16 for zamba2's 112 (7 columns a
// thread), so every thread owns entries and none owns one twice.
template <int N, int ROWS>
struct Owned {
  static constexpr int W = gcd(N, THREADS);
  static constexpr int RP = THREADS / W;
  static constexpr int R = ROWS / RP;
  static constexpr int C = N / W;
  static_assert(ROWS % RP == 0 && N % W == 0, "tile does not split");
  __device__ __forceinline__ static int row0() { return threadIdx.x / W; }
  __device__ __forceinline__ static int col0() { return threadIdx.x % W; }
};

template <int N>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < N; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// query row qi's key interval [lo, hi), the forward's masks; empty for a
// row past the sequence
__device__ __forceinline__ void key_interval(const BwdParams& p, int qi,
                                             int& lo, int& hi) {
  lo = hi = 0;
  if (qi < p.sq) row_interval(p, qi, lo, hi);
}

// the union of the tile rows' key intervals
__device__ __forceinline__ void union_interval(const int* lo, const int* hi,
                                               int sk, int& klo, int& khi) {
  klo = sk;
  khi = 0;
  for (int r = 0; r < BQ; ++r) {
    if (lo[r] < hi[r]) {
      klo = min(klo, lo[r]);
      khi = max(khi, hi[r]);
    }
  }
}

// P and dS of a (BQ rows) x (BKB keys from k0) tile into ps / dss; masked
// entries are 0.  The score x is the scaled q row's dot product with the k
// row, softcapped as the forward does; dS is the gradient with respect to
// that dot product.
template <int D, int DV>
__device__ __forceinline__ void tile_grads(
    const float* qs, const float* gs, const float* ks, const float* vs,
    const int* lo, const int* hi, const float* lse, const float* delta,
    int k0, float softcap, float* ps, float* dss) {
  for (int e = threadIdx.x; e < BQ * BKB; e += THREADS) {
    const int i = e / BKB, j = e - i * BKB, kj = k0 + j;
    float pv = 0.f, ds = 0.f;
    if (kj >= lo[i] && kj < hi[i]) {
      float x = dot_row<D>(qs + i * (D + 1), ks + j * (D + 1)), f = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        f = 1.f - t * t;
      }
      pv = expf(x - lse[i]);
      const float dp = dot_row<DV>(gs + i * (DV + 1), vs + j * (DV + 1));
      ds = pv * (dp - delta[i]) * f;
    }
    if (ps != nullptr) ps[i * LDS + j] = pv;
    dss[i * LDS + j] = ds;
  }
}

// At (48, 32) ptxas left to itself spills 4 bytes at 56 registers; asked
// for four blocks an SM it keeps everything in registers (122).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS, D == 48 ? 4 : 1)
    bwd_dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* ks = smem;                  // BKB x (D + 1)
  float* vs = ks + BKB * (D + 1);    // BKB x (DV + 1)
  float* qs = vs + BKB * (DV + 1);   // BQ x (D + 1), scaled
  float* gs = qs + BQ * (D + 1);     // BQ x (DV + 1)
  float* ps = gs + BQ * (DV + 1);    // BQ x LDS
  float* dss = ps + BQ * LDS;        // BQ x LDS
  __shared__ int lo[BQ], hi[BQ];
  __shared__ float lse[BQ], delta[BQ];
  using OK = Owned<D, BKB>;
  using OV = Owned<DV, BKB>;

  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int k0 = blockIdx.x * BKB, k1 = min(k0 + BKB, p.sk);
  load_rows_f32<D>(ks, static_cast<const T*>(p.k) + b * p.k_sb +
                           kvh * p.k_sh, p.k_ss, k0, p.sk, 1.f);
  load_rows_f32<DV>(vs, static_cast<const T*>(p.v) + b * p.v_sb +
                            kvh * p.v_sh, p.v_ss, k0, p.sk, 1.f);

  float acc_k[OK::R][OK::C], acc_v[OV::R][OV::C];
#pragma unroll
  for (int r = 0; r < OK::R; ++r)
#pragma unroll
    for (int c = 0; c < OK::C; ++c) acc_k[r][c] = 0.f;
#pragma unroll
  for (int r = 0; r < OV::R; ++r)
#pragma unroll
    for (int c = 0; c < OV::C; ++c) acc_v[r][c] = 0.f;

  // the query rows that may see keys [k0, k1)
  const int rlo = p.causal ? max(k0 - p.q_offset, 0) : 0;
  const int rhi = p.window > 0 ? min(p.sq, k1 + p.window - 1 - p.q_offset)
                               : p.sq;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const long long bh = static_cast<long long>(b) * p.hq + h;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* g = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
    for (int r0 = rlo; r0 < rhi; r0 += BQ) {
      load_rows_f32<D>(qs, q, p.q_ss, r0, p.sq, p.scale);
      load_rows_f32<DV>(gs, g, p.g_ss, r0, p.sq, 1.f);
      if (threadIdx.x < BQ) {
        const int qi = r0 + threadIdx.x;
        key_interval(p, qi, lo[threadIdx.x], hi[threadIdx.x]);
        lse[threadIdx.x] = qi < p.sq ? p.lse[bh * p.sq + qi] : 0.f;
        delta[threadIdx.x] = qi < p.sq ? p.delta[bh * p.sq + qi] : 0.f;
      }
      __syncthreads();
      tile_grads<D, DV>(qs, gs, ks, vs, lo, hi, lse, delta, k0, p.softcap,
                        ps, dss);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float* pr = ps + i * LDS + OV::row0();
        const float* gr = gs + i * (DV + 1) + OV::col0();
#pragma unroll
        for (int r = 0; r < OV::R; ++r)
#pragma unroll
          for (int c = 0; c < OV::C; ++c)
            acc_v[r][c] = fmaf(pr[r * OV::RP], gr[c * OV::W], acc_v[r][c]);
        const float* dr = dss + i * LDS + OK::row0();
        const float* qr = qs + i * (D + 1) + OK::col0();
#pragma unroll
        for (int r = 0; r < OK::R; ++r)
#pragma unroll
          for (int c = 0; c < OK::C; ++c)
            acc_k[r][c] = fmaf(dr[r * OK::RP], qr[c * OK::W], acc_k[r][c]);
      }
      __syncthreads();  // before the next rows overwrite qs, gs, ps, dss
    }
  }

  const long long kv0 = (static_cast<long long>(b) * hkv + kvh) * p.sk + k0;
  T* dk = static_cast<T*>(p.dk) + kv0 * D;
  T* dv = static_cast<T*>(p.dv) + kv0 * DV;
#pragma unroll
  for (int r = 0; r < OK::R; ++r) {
    const int j = OK::row0() + r * OK::RP;
#pragma unroll
    for (int c = 0; c < OK::C; ++c)  // the q rows were scaled
      if (k0 + j < p.sk)
        dk[j * D + OK::col0() + c * OK::W] = from_f32<T>(acc_k[r][c]);
  }
#pragma unroll
  for (int r = 0; r < OV::R; ++r) {
    const int j = OV::row0() + r * OV::RP;
#pragma unroll
    for (int c = 0; c < OV::C; ++c)
      if (k0 + j < p.sk)
        dv[j * DV + OV::col0() + c * OV::W] = from_f32<T>(acc_v[r][c]);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x (D + 1), scaled
  float* gs = qs + BQ * (D + 1);     // BQ x (DV + 1)
  float* ks = gs + BQ * (DV + 1);    // BKB x (D + 1)
  float* vs = ks + BKB * (D + 1);    // BKB x (DV + 1)
  float* dss = vs + BKB * (DV + 1);  // BQ x LDS
  __shared__ int lo[BQ], hi[BQ];
  __shared__ float lse[BQ], delta[BQ];
  using OQ = Owned<D, BQ>;

  const int bh = blockIdx.y, b = bh / p.hq, h = bh % p.hq;
  const int kvh = h / p.group;
  const int q0 = blockIdx.x * BQ;
  load_rows_f32<D>(qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q0, p.sq, p.scale);
  load_rows_f32<DV>(gs, static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh,
                    p.g_ss, q0, p.sq, 1.f);
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    key_interval(p, qi, lo[threadIdx.x], hi[threadIdx.x]);
    lse[threadIdx.x] = qi < p.sq ? p.lse[static_cast<long long>(bh) * p.sq + qi]
                                 : 0.f;
  }
  // delta = sum(dO * O): 8 threads a row, combined in a fixed butterfly;
  // written for the dkdv launch too
  {
    const int i = threadIdx.x >> 3, part = threadIdx.x & 7, qi = q0 + i;
    float s = 0.f;
    if (qi < p.sq) {
      const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh +
                   qi * p.o_ss;
      const T* g = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh +
                   qi * p.g_ss;
      for (int c = part; c < DV; c += 8) s = fmaf(to_f32(o[c]), to_f32(g[c]), s);
    }
    s += __shfl_xor_sync(FULL_MASK, s, 1);
    s += __shfl_xor_sync(FULL_MASK, s, 2);
    s += __shfl_xor_sync(FULL_MASK, s, 4);
    if (part == 0) {
      delta[i] = s;
      if (qi < p.sq) p.delta[static_cast<long long>(bh) * p.sq + qi] = s;
    }
  }
  __syncthreads();

  float acc[OQ::R][OQ::C];
#pragma unroll
  for (int r = 0; r < OQ::R; ++r)
#pragma unroll
    for (int c = 0; c < OQ::C; ++c) acc[r][c] = 0.f;
  int klo, khi;
  union_interval(lo, hi, p.sk, klo, khi);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int k0 = klo; k0 < khi; k0 += BKB) {
    load_rows_f32<D>(ks, k, p.k_ss, k0, p.sk, 1.f);
    load_rows_f32<DV>(vs, v, p.v_ss, k0, p.sk, 1.f);
    __syncthreads();
    tile_grads<D, DV>(qs, gs, ks, vs, lo, hi, lse, delta, k0, p.softcap,
                      nullptr, dss);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BKB; ++j) {
      const float* dr = dss + OQ::row0() * LDS + j;
      const float* kr = ks + j * (D + 1) + OQ::col0();
#pragma unroll
      for (int r = 0; r < OQ::R; ++r)
#pragma unroll
        for (int c = 0; c < OQ::C; ++c)
          acc[r][c] = fmaf(dr[r * OQ::RP * LDS], kr[c * OQ::W], acc[r][c]);
    }
    __syncthreads();  // before the next tile overwrites ks, vs, dss
  }

  T* dq = static_cast<T*>(p.dq) +
          (static_cast<long long>(bh) * p.sq + q0) * D;
#pragma unroll
  for (int r = 0; r < OQ::R; ++r) {
    const int i = OQ::row0() + r * OQ::RP;
#pragma unroll
    for (int c = 0; c < OQ::C; ++c)
      if (q0 + i < p.sq)
        dq[i * D + OQ::col0() + c * OQ::W] = from_f32<T>(acc[r][c] * p.scale);
  }
}

template <int D, int DV>
constexpr size_t grads_smem() {
  return ((size_t(BQ) + BKB) * (D + 1) + (size_t(BQ) + BKB) * (DV + 1) +
          2 * size_t(BQ) * LDS) * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// the four A-fragment registers of a 16 x 16 k-slice from the C fragments
// of its two 8-column tiles, rounded to bf16 (mma_bf16.cuh's layouts)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// A fragment (16 rows from ``row0``, k-slice ``kk``) of a row-major tile
// with row stride S
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, t + (row0 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
}

// B fragments of two 8-wide n-tiles (rows j8 .. j8 + 15 of a row-major tile
// with row stride S, each row one n) for k-slice kk: B = tile^T
template <int S>
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const bf16* t,
                                        int j8, int kk, int lane) {
  ldmatrix_x4(r, t + (j8 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-wide n-tiles (columns c0 .. c0 + 15) for the k-slice
// of rows t16 .. t16 + 15 of a row-major tile with row stride S: B = tile
template <int S>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* t,
                                       int t16, int c0, int lane) {
  ldmatrix_x4_trans(r, t + (t16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                           c0 + (lane >> 4) * 8);
}

template <int D, int DV>
struct DqTile {
  static constexpr int M = WARPS * 16;   // position-major rows a block
  static constexpr int BK = 32;          // keys a K/V tile
  static constexpr int STAGES = 2;       // K/V tiles in flight
  static constexpr int QS = D + 8, GS = DV + 8;   // row strides (+16 bytes)
  static constexpr int KS = D + 8, VS = DV + 8;
  static constexpr size_t smem =
      (size_t(M) * (QS + GS) + size_t(STAGES) * BK * (KS + VS)) *
      sizeof(bf16);
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, (D > 128 || DV > 128) ? 1 : 3)
    bwd_dq_mma_kernel(const BwdParams p) {
  using Tile = DqTile<D, DV>;
  constexpr int M = Tile::M, BK = Tile::BK, QS = Tile::QS, GS = Tile::GS,
                KS = Tile::KS, VS = Tile::VS;
  constexpr int NT = BK / 8, QT = D / 8;  // 8-wide n-tiles of S and of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // Q rows, later dQ staging
  bf16* gs = qs + M * QS;                        // dO rows
  bf16* ks = gs + M * GS;                        // STAGES K tiles
  bf16* vs = ks + Tile::STAGES * BK * KS;        // STAGES V tiles
  __shared__ int row_qi[M], row_g[M];
  __shared__ float row_delta[M];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  // position-major rows, tiles counted back from the last row as in the
  // forward
  const int row_end = p.group * p.sq - (gridDim.y - 1 - blockIdx.y) * M;
  const int row0 = max(row_end - M, 0), nrows = row_end - row0;
  const long long h0 = static_cast<long long>(kvh) * p.group;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  const bf16* gb = static_cast<const bf16*>(p.g) + b * p.g_sb + h0 * p.g_sh;
  const bf16* ob = static_cast<const bf16*>(p.o) + b * p.o_sb + h0 * p.o_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const long long lrow0 = (static_cast<long long>(b) * p.hq + h0) * p.sq;

  // the block's keys; K/V rows past khi in the last 16-key chunk are
  // zeroed: they meet dS = 0 in dS K (0 * NaN would not be 0)
  int klo, khi;
  key_span(p, row0 / p.group, (row0 + nrows - 1) / p.group, klo, khi);
  const int tfirst = (klo / BK) * BK;
  const int kend = min(khi, p.sk), kzend = (kend + 15) & ~15;
  if (tfirst < khi) {
    load_rows<BK, D, KS>(ks, kb, p.k_ss, tfirst, kend, kzend);
    load_rows<BK, DV, VS>(vs, vb, p.v_ss, tfirst, kend, kzend);
  }

  // each warp owns rows wr0 .. wr0 + 15 (position row_qi, head row_g) and
  // loads, reads and writes only its own Q, dO and dQ rows
  const int wr0 = warp * 16;
  if (lane < 16) {
    const int gr = row0 + wr0 + lane, qi = gr / p.group;
    row_qi[wr0 + lane] = qi;
    row_g[wr0 + lane] = gr - qi * p.group;
  }
  __syncwarp();
  {
    // the warp's 16 rows in row-major order of their 16-byte chunks, 32 a
    // pass; the last pass is ragged where 32 does not divide them (d = 112:
    // 14 chunks a row)
    constexpr int QC = D / 8, GC = DV / 8;
#pragma unroll
    for (int i = 0; i < (16 * QC + 31) / 32; ++i) {
      const int e = lane + 32 * i, r = wr0 + e / QC, c = e % QC;
      if (e < 16 * QC && r < nrows)
        cp_async16(qs + r * QS + c * 8,
                   qb + row_g[r] * p.q_sh + row_qi[r] * p.q_ss + c * 8, true);
    }
#pragma unroll
    for (int i = 0; i < (16 * GC + 31) / 32; ++i) {
      const int e = lane + 32 * i, r = wr0 + e / GC, c = e % GC;
      if (e < 16 * GC && r < nrows)
        cp_async16(gs + r * GS + c * 8,
                   gb + row_g[r] * p.g_sh + row_qi[r] * p.g_ss + c * 8, true);
    }
  }
  cp_async_commit();                               // group 0: Q, dO, tile 0
  if (tfirst + BK < khi) {
    load_rows<BK, D, KS>(ks + BK * KS, kb, p.k_ss, tfirst + BK, kend, kzend);
    load_rows<BK, DV, VS>(vs + BK * VS, vb, p.v_ss, tfirst + BK, kend,
                          kzend);
  }
  cp_async_commit();                               // group 1: K/V tile 1

  int wlo = p.sk, whi = 0;
  if (wr0 < nrows)
    key_span(p, row_qi[wr0], row_qi[min(wr0 + 16, nrows) - 1], wlo, whi);
  // this thread's two rows' key intervals, and their log-sum-exps loaded
  // now, in flight with the tiles
  int lo[2], hi[2];
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    lo[h] = hi[h] = 0;
    lse_r[h] = 0.f;
    if (r < nrows) {
      row_interval(p, row_qi[r], lo[h], hi[h]);
      lse_r[h] = p.lse[lrow0 + row_g[r] * p.sq + row_qi[r]];
    }
  }

  cp_async_wait<1>();
  __syncthreads();
  // delta = rowsum(dO o O) in f32: two lanes a row, each the 8-element
  // chunks of one parity in order, then one exchange; also written for the
  // dkdv launch
  {
    const int r = wr0 + (lane >> 1), half = lane & 1;
    float s = 0.f;
    if (r < nrows) {
      const bf16* orow = ob + row_g[r] * p.o_sh + row_qi[r] * p.o_ss;
      const bf16* grow = gs + r * GS;
#pragma unroll
      for (int i = 0; i < DV / 16; ++i) {
        const int c = (2 * i + half) * 8;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          s = fmaf(of.x, gf.x, s);
          s = fmaf(of.y, gf.y, s);
        }
      }
    }
    s += __shfl_xor_sync(FULL_MASK, s, 1);
    if (half == 0) {
      row_delta[r] = s;
      if (r < nrows) p.delta[lrow0 + row_g[r] * p.sq + row_qi[r]] = s;
    }
  }
  __syncwarp();
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    lse2[h] = lse_r[h] * LOG2E;
    dlt[h] = row_delta[r];
  }

  // the score x is s scaled (c = scale log2 e), or the softcapped s (c =
  // log2 e), as in the forward's exponent
  const bool capped = p.softcap > 0.f;
  const float cap_in = capped ? p.scale / p.softcap : 0.f;
  const float c = capped ? LOG2E : p.scale * LOG2E;
  float acc[QT][4];
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t0 = tfirst, st = 0; t0 < khi; t0 += BK, st ^= 1) {
    const bf16* kt = ks + st * BK * KS;
    const bf16* vt = vs + st * BK * VS;
    const bool active = t0 < whi && t0 + BK > wlo;   // warp-uniform
    // 16-key chunk u of the tile holds some key of this warp's rows iff
    // 16 u < chi and 16 u + 16 > clo: the others are skipped
    const int clo = wlo - t0, chi = whi - t0;
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // S = Q K^T, dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a<QS>(a, qs, wr0, kk, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j * 8 >= chi || j * 8 + 16 <= clo) continue;
          uint32_t bk[4];
          load_bt<KS>(bk, kt, j * 8, kk, lane);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t a[4];
        load_a<GS>(a, gs, wr0, kk, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j * 8 >= chi || j * 8 + 16 <= clo) continue;
          uint32_t bv[4];
          load_bt<VS>(bv, vt, j * 8, kk, lane);
          mma_bf16(dp[j], a, bv[0], bv[1]);
          mma_bf16(dp[j + 1], a, bv[2], bv[3]);
        }
      }
      // dS = P (dP - delta) (1 - t^2), 0 outside the row's keys
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = t0 + (lane & 3) * 2, rlo = lo[h] - k0, rhi = hi[h] - k0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[j][2 * h + e], f = 1.f;
            if (capped) {
              const float t = tanhf(x * cap_in);
              x = p.softcap * t;
              f = 1.f - t * t;
            }
            const bool valid = j * 8 + e >= rlo && j * 8 + e < rhi;
            const float pe = ex2(fmaf(x, c, -lse2[h]));
            dp[j][2 * h + e] =
                valid ? pe * (dp[j][2 * h + e] - dlt[h]) * f : 0.f;
          }
        }
      }
      // dQ += dS K
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        if (t * 16 >= chi || t * 16 + 16 <= clo) continue;
        uint32_t a[4];
        c_to_a(a, dp[2 * t], dp[2 * t + 1]);
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t bk[4];
          load_b<KS>(bk, kt, t * 16, jj * 16, lane);
          mma_bf16(acc[2 * jj], a, bk[0], bk[1]);
          mma_bf16(acc[2 * jj + 1], a, bk[2], bk[3]);
        }
      }
    }
    if (t0 + 2 * BK < khi) {                       // tile i + 2 into stage st
      __syncthreads();                             // once every warp is done
      load_rows<BK, D, KS>(ks + st * BK * KS, kb, p.k_ss, t0 + 2 * BK, kend,
                           kzend);
      load_rows<BK, DV, VS>(vs + st * BK * VS, vb, p.v_ss, t0 + 2 * BK, kend,
                            kzend);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // dQ = scale acc, through this warp's own Q rows, 16 bytes a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* qrow = qs + (wr0 + (lane >> 2) + 8 * h) * QS + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < QT; ++j)
      *reinterpret_cast<uint32_t*>(qrow + j * 8) = pack_bf16x2(
          acc[j][2 * h] * p.scale, acc[j][2 * h + 1] * p.scale);
  }
  __syncwarp();
  constexpr int QC = D / 8;
  for (int e = lane; e < 16 * QC; e += 32) {
    const int r = wr0 + e / QC, cc = e % QC;
    if (r >= nrows) break;
    bf16* o = static_cast<bf16*>(p.dq) +
              ((static_cast<long long>(b) * p.hq + h0 + row_g[r]) * p.sq +
               row_qi[r]) * D;
    *reinterpret_cast<uint4*>(o + cc * 8) =
        *reinterpret_cast<const uint4*>(qs + r * QS + cc * 8);
  }
}

template <int D, int DV>
struct DkvTile {
  // column slices of dK/dV: two where one warp's 16 rows of both would
  // need more than 128 f32 accumulators a thread
  static constexpr int CS = (D + DV > 256) ? 2 : 1;
  static constexpr int NW = WARPS * CS, THR = NW * 32;  // warps, threads
  static constexpr int N = WARPS * 16;     // keys a block, 16 a warp
  static constexpr int M = 32;             // query rows a step
  static constexpr int STAGES = 2;         // Q / dO tiles (more measured
                                           // slower at the SFT shape)
  static constexpr int QS = D + 8, GS = DV + 8, KS = D + 8, VS = DV + 8;
  static constexpr size_t smem =
      (size_t(N) * (KS + VS) + size_t(STAGES) * M * (QS + GS)) *
      sizeof(bf16);
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS * ((D + DV > 256) ? 2 : 1),
                                  (D + DV > 256) ? 1 : 2)
    bwd_dkdv_mma_kernel(const BwdParams p) {
  using Tile = DkvTile<D, DV>;
  static_assert(Tile::THR == THREADS * Tile::CS, "launch bounds");
  constexpr int N = Tile::N, M = Tile::M, QS = Tile::QS, GS = Tile::GS,
                KS = Tile::KS, VS = Tile::VS, THR = Tile::THR;
  constexpr int DKC = D / Tile::CS, DVC = DV / Tile::CS;  // a warp's columns
  constexpr int ST = M / 8;           // 8-wide n-tiles of S^T: query rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // N x KS, later dK staging
  bf16* vs = ks + N * KS;                        // N x VS, later dV staging
  bf16* qs = vs + N * VS;                        // STAGES x M x QS
  bf16* gs = qs + Tile::STAGES * M * QS;         // STAGES x M x GS
  constexpr int STAGES = Tile::STAGES;
  __shared__ int s_lo[STAGES][M], s_hi[STAGES][M];
  __shared__ float s_lse[STAGES][M], s_dl[STAGES][M];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp % WARPS, cs = warp / WARPS;  // key group, column slice
  const int hkv = p.hq / p.group;
  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * N, k1 = min(k0 + N, p.sk);
  const long long h0 = static_cast<long long>(kvh) * p.group;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  const bf16* gb = static_cast<const bf16*>(p.g) + b * p.g_sb + h0 * p.g_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const long long lrow0 = (static_cast<long long>(b) * p.hq + h0) * p.sq;

  // K and V rows [k0, k0 + N), zero past sk
  load_rows<N, D, KS, THR>(ks, kb, p.k_ss, k0, k1, k0 + N);
  load_rows<N, DV, VS, THR>(vs, vb, p.v_ss, k0, k1, k0 + N);

  // the positions that may see keys [k0, k1), as position-major rows
  // [R0, R1) of the group
  const int qlo = p.causal ? max(k0 - p.q_offset, 0) : 0;
  const int qhi = p.window > 0 ? min(p.sq, k1 + p.window - 1 - p.q_offset)
                               : p.sq;
  const int R0 = qlo * p.group, R1 = max(qhi, qlo) * p.group;
  const int ntiles = (R1 - R0 + M - 1) / M;

  // rows R0 + i M .. + M into stage st: Q, dO, lse and delta by cp.async
  // (zero past R1: those rows meet P = 0 and dS = 0 in the products over
  // the rows), each row's key interval computed
  auto stage_rows = [&](int i, int st) {
    const int r0 = R0 + i * M;
    constexpr int QC = D / 8, GC = DV / 8;
    bf16* qd = qs + st * M * QS;
    bf16* gd = gs + st * M * GS;
    for (int e = threadIdx.x; e < M * QC; e += THR) {
      const int j = e / QC, cc = e - j * QC, r = r0 + j;
      const int qi = r / p.group, g = r - qi * p.group;
      const bool ok = r < R1;
      cp_async16(qd + j * QS + cc * 8,
                 ok ? qb + g * p.q_sh + qi * p.q_ss + cc * 8 : qb, ok);
    }
    for (int e = threadIdx.x; e < M * GC; e += THR) {
      const int j = e / GC, cc = e - j * GC, r = r0 + j;
      const int qi = r / p.group, g = r - qi * p.group;
      const bool ok = r < R1;
      cp_async16(gd + j * GS + cc * 8,
                 ok ? gb + g * p.g_sh + qi * p.g_ss + cc * 8 : gb, ok);
    }
    if (threadIdx.x < M) {
      const int r = r0 + threadIdx.x;
      const int qi = r / p.group, g = r - qi * p.group;
      const bool ok = r < R1;
      int lo = 0, hi = 0;
      if (ok) row_interval(p, qi, lo, hi);
      s_lo[st][threadIdx.x] = lo;
      s_hi[st][threadIdx.x] = hi;
      const long long idx = ok ? lrow0 + static_cast<long long>(g) * p.sq + qi
                               : 0;
      cp_async4(&s_lse[st][threadIdx.x], p.lse + idx, ok);
      cp_async4(&s_dl[st][threadIdx.x], p.delta + idx, ok);
    }
  };
  // steps 0 .. STAGES - 2 in flight (group i: step i, group 0 also K, V)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) stage_rows(i, i);
    cp_async_commit();
  }

  float acc_k[DKC / 8][4], acc_v[DVC / 8][4];
#pragma unroll
  for (int j = 0; j < DKC / 8; ++j)
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j)
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  const int kw0 = k0 + kg * 16, kw1 = min(kw0 + 16, p.sk);  // warp's keys
  const int key_r = kw0 + (lane >> 2);      // this thread's keys, and + 8
  const bool capped = p.softcap > 0.f;
  const float cap_in = capped ? p.scale / p.softcap : 0.f;
  const float c = capped ? LOG2E : p.scale * LOG2E;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 2>();                   // rows i (and K, V)
    __syncthreads();
    // step i + STAGES - 1 into the stage every warp finished with in step
    // i - 1
    if (i + STAGES - 1 < ntiles)
      stage_rows(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    // the keys any row of this step sees: a warp none of whose keys is
    // among them skips the step (warp-uniform)
    const int r0 = R0 + i * M, r1 = min(r0 + M, R1);
    int tlo, thi;
    key_span(p, r0 / p.group, (r1 - 1) / p.group, tlo, thi);
    if (kw0 < kw1 && kw0 < thi && kw1 > tlo) {
      const bf16* qt = qs + st * M * QS;
      const bf16* gt = gs + st * M * GS;
      const int* lo = s_lo[st];
      const int* hi = s_hi[st];
      const float* l2 = s_lse[st];
      const float* dl = s_dl[st];
      float s[ST][4], dp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the M rows
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a<KS>(a, ks, kg * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < ST; j += 2) {
          uint32_t bq[4];
          load_bt<QS>(bq, qt, j * 8, kk, lane);
          mma_bf16(s[j], a, bq[0], bq[1]);
          mma_bf16(s[j + 1], a, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t a[4];
        load_a<VS>(a, vs, kg * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < ST; j += 2) {
          uint32_t bg[4];
          load_bt<GS>(bg, gt, j * 8, kk, lane);
          mma_bf16(dp[j], a, bg[0], bg[1]);
          mma_bf16(dp[j + 1], a, bg[2], bg[3]);
        }
      }
      // P^T and dS^T: entry e of n-tile j is key key_r + 8 (e / 2) and
      // row j * 8 + 2 (lane % 4) + e % 2 of the step
#pragma unroll
      for (int j = 0; j < ST; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + (lane & 3) * 2 + (e & 1);
          const int key = key_r + 8 * (e >> 1);
          float x = s[j][e], f = 1.f;
          if (capped) {
            const float t = tanhf(x * cap_in);
            x = p.softcap * t;
            f = 1.f - t * t;
          }
          const bool valid = key >= lo[col] && key < hi[col];
          const float pe =
              valid ? ex2(fmaf(x, c, -l2[col] * LOG2E)) : 0.f;
          dp[j][e] = valid ? pe * (dp[j][e] - dl[col]) * f : 0.f;
          s[j][e] = pe;
        }
      }
      // dV += P^T dO and dK += dS^T Q over the step's rows, P and dS
      // rounded to bf16 as A operands
#pragma unroll
      for (int t = 0; t < M / 16; ++t) {
        uint32_t a[4];
        c_to_a(a, s[2 * t], s[2 * t + 1]);
#pragma unroll
        for (int jj = 0; jj < DVC / 16; ++jj) {
          uint32_t bg[4];
          load_b<GS>(bg, gt, t * 16, cs * DVC + jj * 16, lane);
          mma_bf16(acc_v[2 * jj], a, bg[0], bg[1]);
          mma_bf16(acc_v[2 * jj + 1], a, bg[2], bg[3]);
        }
        c_to_a(a, dp[2 * t], dp[2 * t + 1]);
#pragma unroll
        for (int jj = 0; jj < DKC / 16; ++jj) {
          uint32_t bq[4];
          load_b<QS>(bq, qt, t * 16, cs * DKC + jj * 16, lane);
          mma_bf16(acc_k[2 * jj], a, bq[0], bq[1]);
          mma_bf16(acc_k[2 * jj + 1], a, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with K and V: they stage dK, dV

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = kg * 16 + (lane >> 2) + 8 * h;
    bf16* krow = ks + kr * KS + cs * DKC + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < DKC / 8; ++j)
      *reinterpret_cast<uint32_t*>(krow + j * 8) = pack_bf16x2(
          acc_k[j][2 * h] * p.scale, acc_k[j][2 * h + 1] * p.scale);
    bf16* vrow = vs + kr * VS + cs * DVC + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j)
      *reinterpret_cast<uint32_t*>(vrow + j * 8) =
          pack_bf16x2(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
  }
  __syncthreads();
  const long long kv0 = (static_cast<long long>(b) * hkv + kvh) * p.sk + k0;
  bf16* dk = static_cast<bf16*>(p.dk) + kv0 * D;
  bf16* dv = static_cast<bf16*>(p.dv) + kv0 * DV;
  for (int e = threadIdx.x; e < N * (D / 8); e += THR) {
    const int j = e / (D / 8), cc = e % (D / 8);
    if (k0 + j < k1)
      *reinterpret_cast<uint4*>(dk + j * D + cc * 8) =
          *reinterpret_cast<const uint4*>(ks + j * KS + cc * 8);
  }
  for (int e = threadIdx.x; e < N * (DV / 8); e += THR) {
    const int j = e / (DV / 8), cc = e % (DV / 8);
    if (k0 + j < k1)
      *reinterpret_cast<uint4*>(dv + j * DV + cc * 8) =
          *reinterpret_cast<const uint4*>(vs + j * VS + cc * 8);
  }
}

struct BwdLaunch {
  BwdParams p;
  int batch, dtype;
  cudaStream_t stream;

  // dq first: it writes delta, which dkdv reads
  template <int D, int DV>
  cudaError_t run_f32() const {
    const int hkv = p.hq / p.group;
    const dim3 rows_grid((p.sq + BQ - 1) / BQ, batch * p.hq);
    const dim3 keys_grid((p.sk + BKB - 1) / BKB, batch * hkv);
    cudaError_t e = launch(bwd_dq_kernel<float, D, DV>, rows_grid,
                           grads_smem<D, DV>(), stream, p);
    if (e != cudaSuccess) return e;
    return launch(bwd_dkdv_kernel<float, D, DV>, keys_grid,
                  grads_smem<D, DV>(), stream, p);
  }

  template <int D, int DV>
  cudaError_t run_bf16() const {
    using Dq = DqTile<D, DV>;
    using Dkv = DkvTile<D, DV>;
    const int hkv = p.hq / p.group;
    const dim3 rows_grid(batch * hkv, (p.group * p.sq + Dq::M - 1) / Dq::M);
    const dim3 keys_grid(batch * hkv, (p.sk + Dkv::N - 1) / Dkv::N);
    cudaError_t e = launch(bwd_dq_mma_kernel<D, DV>, rows_grid, Dq::smem,
                           stream, p);
    if (e != cudaSuccess) return e;
    return launch(bwd_dkdv_mma_kernel<D, DV>, keys_grid, Dkv::smem, stream,
                  p, Dkv::THR);
  }

  template <int D, int DV>
  cudaError_t operator()() const {
    if (dtype == DTYPE_BF16) return run_bf16<D, DV>();
    if (dtype == DTYPE_F32) return run_f32<D, DV>();
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, const float* lse,
    float* delta, int dtype, int b, int hq, int hkv, int sq, int sk, int d,
    int dv_dim, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long g_sb, long long g_sh, long long g_ss,
    int causal, int window, float softcap, float scale, int q_offset,
    void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  if (dtype == repro::DTYPE_BF16) {  // 16-byte cp.async / loads of every row
    for (long long st : {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                         o_sb, o_sh, o_ss, g_sb, g_sh, g_ss})
      if (st % 8 != 0) return cudaErrorInvalidValue;
    for (const void* ptr : {q, k, v, o, g, static_cast<const void*>(dq),
                            static_cast<const void*>(dk),
                            static_cast<const void*>(dv)})
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return cudaErrorInvalidValue;
  }
  repro::BwdLaunch f;
  f.p = repro::BwdParams{q, k, v, o, g, dq, dk, dv, lse, delta,
                         hq, hq / hkv, sq, sk,
                         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                         o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                         causal, window, q_offset, softcap, scale};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_pairs<repro::HeadPair<112, 112>,
                                    repro::HeadPair<192, 128>,
                                    repro::HeadPair<48, 32>>(d, dv_dim, f);
}
