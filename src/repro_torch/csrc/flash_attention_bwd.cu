// Flash attention backward, CUDA for sm_90a: dQ, dK and dV of the function
// flash_attention.cu computes.
//
// Replaces no Pallas kernel: the reference trains through ref.attention
// (repro/kernels/ops.py sends every training length to it) and XLA derives
// the gradient under jax.checkpoint (repro/models/transformer.py).  The
// port's full-sequence attention on the card is the hand-written forward
// kernel, which autograd cannot see through, so its gradient is this
// kernel.  It covers what the forward takes except softcap: GQA (dK and dV
// summed over the q-heads of a group), causal with q_offset, a sliding
// window, dv != d, f32 and bf16 inputs (f32 arithmetic), strided views
// with a contiguous last dim.  A query row with no valid key gets zero
// gradient, as the forward writes it zero output.
//
// Bound on the H100: at the training shape (q (64, 32, 80, 128), k/v
// (64, 8, 80, 128), bf16, causal) the call needs ~1e10 FLOPs on ~210 MB of
// q, k, v, o, dO, dq, dk, dv, ~50 FLOP/B, below the ~295 FLOP/B where bf16
// tensor cores would be the limit: moving those bytes once bounds it.  This
// first version is plain and right, not fast: f32 FMAs out of shared
// memory, no tensor cores, no TMA.
//
// Three launches, no atomics, so two launches give the same bits:
//   stats: one block per (batch, q-head, 16 query rows): each row's
//          log-sum-exp recomputed from q and k (online, in key order) and
//          delta = sum(dO * O), into f32 scratch;
//   dkdv:  one block per (batch, kv-head, 16 keys): loops over the group's
//          q-heads and the query rows that see its keys, 16 at a time,
//          recomputes P = exp(scale q.k - lse), dV += P^T dO,
//          dP = dO V^T, dS = P (dP - delta), dK += scale dS^T Q;
//   dq:    one block per (batch, q-head, 16 query rows): loops over the
//          key tiles the rows see, dQ += scale dS K.
// Every score is the same sequential f32 dot product of the scaled q row
// and the k row in all three kernels.
#include "attention_common.cuh"

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
  float* lse;     // (b, hq, sq) scratch
  float* delta;   // (b, hq, sq) scratch
  int hq, group, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;
  int causal, window, q_offset;
  float scale;
};

constexpr int BQ = 16;  // query rows of a tile
constexpr int BKB = 16;  // keys of a tile
constexpr int LDS = BKB + 1;  // row stride of a (BQ x BKB) score tile

static_assert(BQ == BKB, "query and key tiles share load_rows");

// BQ rows of ``src`` (row stride ``ss``) from row ``r0`` into shared memory
// as f32 times ``mul``, ``N + 1`` floats a row; rows at or past ``n`` are 0
template <int N, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0, int n,
                                          float mul) {
  for (int e = threadIdx.x; e < BQ * N; e += THREADS) {
    const int r = e / N, c = e - r * N;
    dst[r * (N + 1) + c] =
        r0 + r < n ? to_f32(src[(r0 + r) * ss + c]) * mul : 0.f;
  }
}

// Which entries of a (ROWS x N) accumulator tile a thread owns: W threads
// across a row, RP rows a pass; thread t owns rows t / W + RP * r (r < R)
// at columns t % W + W * c (c < C), so every address is a base plus a
// compile-time offset and a warp reads consecutive columns of one row.
template <int N, int ROWS>
struct Owned {
  static constexpr int W = N < THREADS ? N : THREADS;
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
  if (qi >= p.sq) {
    lo = hi = 0;
    return;
  }
  const int qpos = qi + p.q_offset;
  hi = p.causal ? min(qpos + 1, p.sk) : p.sk;
  lo = p.window > 0 ? max(qpos - p.window + 1, 0) : 0;
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
// entries are 0
template <int D, int DV>
__device__ __forceinline__ void tile_grads(
    const float* qs, const float* gs, const float* ks, const float* vs,
    const int* lo, const int* hi, const float* lse, const float* delta,
    int k0, float* ps, float* dss) {
  for (int e = threadIdx.x; e < BQ * BKB; e += THREADS) {
    const int i = e / BKB, j = e - i * BKB, kj = k0 + j;
    float pv = 0.f, ds = 0.f;
    if (kj >= lo[i] && kj < hi[i]) {
      pv = expf(dot_row<D>(qs + i * (D + 1), ks + j * (D + 1)) - lse[i]);
      const float dp = dot_row<DV>(gs + i * (DV + 1), vs + j * (DV + 1));
      ds = pv * (dp - delta[i]);
    }
    if (ps != nullptr) ps[i * LDS + j] = pv;
    dss[i * LDS + j] = ds;
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_stats_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x (D + 1), scaled
  float* ks = qs + BQ * (D + 1);     // BKB x (D + 1)
  __shared__ int lo[BQ], hi[BQ];

  const int bh = blockIdx.y, b = bh / p.hq, h = bh % p.hq;
  const int kvh = h / p.group;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  load_rows<D>(qs, q, p.q_ss, q0, p.sq, p.scale);
  if (threadIdx.x < BQ) key_interval(p, q0 + threadIdx.x, lo[threadIdx.x],
                                     hi[threadIdx.x]);

  // delta: 8 threads a row, combined in a fixed butterfly
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
    if (part == 0 && qi < p.sq)
      p.delta[static_cast<long long>(bh) * p.sq + qi] = s;
  }
  __syncthreads();

  int klo, khi;
  union_interval(lo, hi, p.sk, klo, khi);
  float* ss = ks + BKB * (D + 1);    // BQ x LDS scores
  float m = NEG_INF, l = 0.f;        // row threadIdx.x < BQ
  for (int k0 = klo; k0 < khi; k0 += BKB) {
    load_rows<D>(ks, k, p.k_ss, k0, p.sk, 1.f);
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * BKB; e += THREADS) {
      const int i = e / BKB, j = e - i * BKB, kj = k0 + j;
      if (kj >= lo[i] && kj < hi[i])
        ss[i * LDS + j] = dot_row<D>(qs + i * (D + 1), ks + j * (D + 1));
    }
    __syncthreads();
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;
      const int j0 = max(lo[r] - k0, 0), j1 = min(hi[r] - k0, BKB);
      for (int j = j0; j < j1; ++j) {
        const float s = ss[r * LDS + j];
        const float mn = fmaxf(m, s);
        l = l * expf(m - mn) + expf(s - mn);
        m = mn;
      }
    }
    __syncthreads();  // before the next tile overwrites ks and ss
  }
  if (threadIdx.x < BQ && q0 + threadIdx.x < p.sq)
    p.lse[static_cast<long long>(bh) * p.sq + q0 + threadIdx.x] =
        l > 0.f ? m + logf(l) : 0.f;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(const BwdParams p) {
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
  load_rows<D>(ks, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
               p.k_ss, k0, p.sk, 1.f);
  load_rows<DV>(vs, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
                p.v_ss, k0, p.sk, 1.f);

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
      load_rows<D>(qs, q, p.q_ss, r0, p.sq, p.scale);
      load_rows<DV>(gs, g, p.g_ss, r0, p.sq, 1.f);
      if (threadIdx.x < BQ) {
        const int qi = r0 + threadIdx.x;
        key_interval(p, qi, lo[threadIdx.x], hi[threadIdx.x]);
        lse[threadIdx.x] = qi < p.sq ? p.lse[bh * p.sq + qi] : 0.f;
        delta[threadIdx.x] = qi < p.sq ? p.delta[bh * p.sq + qi] : 0.f;
      }
      __syncthreads();
      tile_grads<D, DV>(qs, gs, ks, vs, lo, hi, lse, delta, k0, ps, dss);
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
  load_rows<D>(qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
               p.q_ss, q0, p.sq, p.scale);
  load_rows<DV>(gs, static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh,
                p.g_ss, q0, p.sq, 1.f);
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    key_interval(p, qi, lo[threadIdx.x], hi[threadIdx.x]);
    lse[threadIdx.x] = qi < p.sq ? p.lse[static_cast<long long>(bh) * p.sq + qi]
                                 : 0.f;
    delta[threadIdx.x] =
        qi < p.sq ? p.delta[static_cast<long long>(bh) * p.sq + qi] : 0.f;
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
    load_rows<D>(ks, k, p.k_ss, k0, p.sk, 1.f);
    load_rows<DV>(vs, v, p.v_ss, k0, p.sk, 1.f);
    __syncthreads();
    tile_grads<D, DV>(qs, gs, ks, vs, lo, hi, lse, delta, k0, nullptr, dss);
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
constexpr size_t stats_smem() {
  return (size_t(BQ) * (D + 1) + size_t(BKB) * (D + 1) + size_t(BQ) * LDS) *
         sizeof(float);
}

template <int D, int DV>
constexpr size_t grads_smem() {
  return ((size_t(BQ) + BKB) * (D + 1) + (size_t(BQ) + BKB) * (DV + 1) +
          2 * size_t(BQ) * LDS) * sizeof(float);
}

struct BwdLaunch {
  BwdParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <typename T, int D, int DV>
  cudaError_t run() const {
    const int hkv = p.hq / p.group;
    const dim3 rows_grid((p.sq + BQ - 1) / BQ, batch * p.hq);
    const dim3 keys_grid((p.sk + BKB - 1) / BKB, batch * hkv);
    cudaError_t e = launch(bwd_stats_kernel<T, D, DV>, rows_grid,
                           stats_smem<D, DV>(), stream, p);
    if (e != cudaSuccess) return e;
    e = launch(bwd_dkdv_kernel<T, D, DV>, keys_grid, grads_smem<D, DV>(),
               stream, p);
    if (e != cudaSuccess) return e;
    return launch(bwd_dq_kernel<T, D, DV>, rows_grid, grads_smem<D, DV>(),
                  stream, p);
  }

  template <int D, int DV>
  cudaError_t operator()() const {
    if (dtype == DTYPE_BF16) return run<__nv_bfloat16, D, DV>();
    if (dtype == DTYPE_F32) return run<float, D, DV>();
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, float* lse, float* delta,
    int dtype, int b, int hq, int hkv, int sq, int sk, int d, int dv_dim,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long g_sb, long long g_sh, long long g_ss, int causal, int window,
    float scale, int q_offset, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  repro::BwdLaunch f;
  f.p = repro::BwdParams{q, k, v, o, g, dq, dk, dv, lse, delta,
                         hq, hq / hkv, sq, sk,
                         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                         o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                         causal, window, q_offset, scale};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_dims(d, dv_dim, f);
}
