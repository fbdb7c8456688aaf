// Flash attention for the prefill, CUDA for sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (Pallas TPU,
// body _flash_kernel): GQA attention over the full sequence with an online
// softmax over KV blocks; causal with q_offset, sliding window, softcap
// before the mask, a true-seq_k pad mask, dv != d, KV head = h // group.
//
// Bound on the H100: at the SCOPE prefill shape (q (56, 32, 49, 128), k/v
// (56, 8, 49, 128), bf16, causal) the call needs ~1.1 GFLOP on 56 MB of
// q/k/v/o — ~20 FLOP/B, far below the ~295 FLOP/B where bf16 tensor cores
// would be the limit — so the bound is moving q/k/v/o once (~17 us).
//
// Two kernels behind one entry point, chosen by dtype:
//
// bf16 (flash_mma_kernel, the model's path): one block owns one (batch,
// kv-head) and 64 of its group's query rows, flattened position-major as
// row = qi * group + head-in-group, so every K/V tile it loads feeds all
// the group's q-heads and the rows of a tile share nearly one key interval.
// Q and tiles of 32 keys of K and V arrive as bf16 through 16-byte cp.async
// (rows padded by 16 bytes, so ldmatrix reads them without bank
// conflicts), two K/V tiles in flight, so the next tile lands while the
// block works on this one.  Each warp owns 16 rows: S = Q.K^T on
// mma.sync.m16n8k16 (bf16 in, f32 out), softcap, the row's key interval,
// and the online softmax (m, l, acc) in f32 registers with _flash_kernel's
// guards (m_safe, alpha = 0 on a row's first key, l == 0 -> 1, so a row
// with no key writes 0).  The scale is applied to S in f32, inside the
// exponent's FMA (exp(scale s - scale m) = 2^(s c - m c), c = scale
// log2 e); it is not folded into bf16 q, which would round, as 128^-0.5 is
// not a power of two.  O += P.V runs on the same mma with P rounded to
// bf16 (the one rounding the TPU kernel does not make; l sums the
// unrounded P).  A warp skips the 16-key chunks outside its rows' keys
// (the causal triangle's upper part, the padding past seq_k).  The output
// is staged through the warp's own Q rows in shared memory and written in
// 16-byte pieces.  No wgmma or TMA: at ~1.1 GFLOP a call even mma.sync at
// a fraction of peak takes a few us; what limits the kernel is the bytes
// and each block's chain of latencies (load, products, softmax, store),
// which the two-tile pipeline and up to 4 resident blocks a SM (<= 128
// registers a thread) overlap.  No atomics and no split over keys: a
// launch is deterministic.
//
// f32 (flash_kernel over attend_rows): one block per (batch * q-head,
// 16-row q tile), dot products as f32 FMAs out of shared memory, which
// keeps the 2e-5 parity with the f32 reference that tensor cores (bf16 or
// TF32) cannot.
//
// Either kernel also writes each row's log-sum-exp when given an ``lse``
// buffer (training's forward, which the backward reads instead of
// recomputing it); the serve path passes none and writes the same output.
//
// Head dims: any (d, dv) pair of 32, 64, 128 and 256, d = dv = 112
// (zamba2-7b's shared attention, 3584 / 32 heads, group 1), and MLA's
// pairs (deepseek-v2-lite's q / k of nope 128 + rope 64 = 192 with v 128,
// group 1; 48 / 32 on its reduced config).  At d 192 the bf16 kernel stages
// Q at a row stride of 200 elements (400 bytes: eight rows of an ldmatrix
// fall in distinct banks) and two K/V stages, 68.6 KB of dynamic shared
// memory, and runs twelve k-steps of Q fragments, each read from shared
// memory where it is used, so registers hold only S and O's accumulators
// as at d 128; like every pair above 128 it runs one block a SM at least,
// with up to 255 registers.  A 48-wide row is 6 16-byte chunks, copied
// like 112's in row-major order with a ragged last pass.  A 112-wide
// row is 14 16-byte chunks, which divide neither a warp nor the block's
// 128 threads, so the copies walk the tile's chunks in row-major order with
// a ragged last pass; its 7 k-steps and 14 n-tiles (7 ldmatrix.x4 pairs)
// fit mma.m16n8k16 as they are, and the f32 kernel gives the first 16 lanes
// a fourth output column.  Rows are read in place: nothing pads them to
// 128.
//
// Inputs may be strided views (last dim contiguous): the model passes the
// (b, s, h, d) projections transposed without a copy.  The bf16 kernel
// also needs every stride a multiple of 8 elements and 16-byte aligned
// bases (the wrapper checks both).
#include <initializer_list>

#include "flash_common.cuh"

namespace repro {

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // (b, hq, sq, dv), contiguous
  float* lse;  // (b, hq, sq) f32, or null: each row's log-sum-exp
  int hq, group, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int causal, window, q_offset;
  float softcap, scale;
};

constexpr int FLASH_R = 4;                       // rows per warp
constexpr int FLASH_ROWS = WARPS * FLASH_R;      // q rows per block

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_kernel(const FlashParams p) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + FLASH_ROWS * D;
  float* vs = ks + BK * (D + 1);
  __shared__ int lo[FLASH_ROWS], hi[FLASH_ROWS];
  __shared__ T* out[FLASH_ROWS];
  __shared__ float* lse[FLASH_ROWS];
  __shared__ int key_range[2];

  const int b = blockIdx.x / p.hq, h = blockIdx.x % p.hq;
  const int kvh = h / p.group;
  const int q0 = blockIdx.y * FLASH_ROWS;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;

  for (int e = threadIdx.x; e < FLASH_ROWS * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    const int qi = q0 + r;
    qs[e] = qi < p.sq ? to_f32(q[qi * p.q_ss + c]) * p.scale : 0.f;
  }
  if (threadIdx.x < FLASH_ROWS) {
    const int r = threadIdx.x, qi = q0 + r;
    int rlo = 0, rhi = 0;
    T* o = nullptr;
    float* ls = nullptr;
    if (qi < p.sq) {
      row_interval(p, qi, rlo, rhi);
      const long long row = (static_cast<long long>(b) * p.hq + h) * p.sq + qi;
      o = static_cast<T*>(p.out) + row * DV;
      if (p.lse != nullptr) ls = p.lse + row;
    }
    lo[r] = rlo;
    hi[r] = rhi;
    out[r] = o;
    lse[r] = ls;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int klo = p.sk, khi = 0;
    for (int r = 0; r < FLASH_ROWS; ++r) {
      if (lo[r] < hi[r]) {
        klo = min(klo, lo[r]);
        khi = max(khi, hi[r]);
      }
    }
    key_range[0] = klo;
    key_range[1] = khi;
  }
  __syncthreads();

  attend_rows<T, D, DV, FLASH_R>(
      qs, lo, hi, out, key_range[0], key_range[1],
      static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
      static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
      DenseKeys{p.k_ss, p.v_ss}, p.softcap, ks, vs, lse);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles, the GQA group packed into one block
// ---------------------------------------------------------------------------
template <int D, int DV>
struct MmaTile {
  static constexpr int M = WARPS * 16;              // q rows a block
  static constexpr int BK = 32;                     // keys a K/V tile
  static constexpr int STAGES = 2;                  // K/V tiles in flight
  static constexpr int QS = (D > DV ? D : DV) + 8;  // Q / O staging row stride
  static constexpr int KS = D + 8, VS = DV + 8;     // (elements, +16 bytes)
  static constexpr size_t smem =
      (size_t(M) * QS + size_t(STAGES) * BK * (KS + VS)) *
      sizeof(__nv_bfloat16);
};

template <int D, int DV>
// up to head dim 128, 4 blocks a SM: at most 128 registers a thread
__global__ void __launch_bounds__(THREADS, (D > 128 || DV > 128) ? 1 : 4)
    flash_mma_kernel(const FlashParams p) {
  using Tile = MmaTile<D, DV>;
  constexpr int M = Tile::M, BK = Tile::BK, QS = Tile::QS, KS = Tile::KS,
                VS = Tile::VS;
  constexpr int NT = BK / 8, OT = DV / 8;  // 8-wide n-tiles of S and of O
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // Q tile, later O staging
  bf16* ks = qs + M * QS;                        // STAGES K tiles
  bf16* vs = ks + Tile::STAGES * BK * KS;         // STAGES V tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  // position-major rows, tiles counted back from the last row, so the one
  // partial tile holds the first positions, which (causal) need the fewest
  // keys
  const int row_end = p.group * p.sq - (gridDim.y - 1 - blockIdx.y) * M;
  const int row0 = max(row_end - M, 0), nrows = row_end - row0;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb +
                   static_cast<long long>(kvh) * p.group * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the block's keys: the union of its rows' intervals; first K tile
  int klo, khi;
  key_span(p, row0 / p.group, (row0 + nrows - 1) / p.group, klo, khi);
  const int tfirst = (klo / BK) * BK;
  // Keys at or past khi are no row's and are not read.  S and P.V skip
  // whole 16-key chunks past khi; inside the last chunk a K row is never
  // read into an unmasked score, but a V row meets p = 0, so it is zeroed
  // (0 * NaN would not be 0).
  const int kend = min(khi, p.sk), vzend = (kend + 15) & ~15;
  if (tfirst < khi) load_rows<BK, D, KS>(ks, kb, p.k_ss, tfirst, kend, kend);

  // Each warp owns rows wr0 .. wr0 + 15: row r is position row_qi[r] of
  // head row_g[r] in the group.  The warp computes, loads and later writes
  // only its own rows, so no block barrier is needed before the loads.
  __shared__ int row_qi[M], row_g[M];
  const int wr0 = warp * 16;
  if (lane < 16) {
    const int gr = row0 + wr0 + lane, qi = gr / p.group;
    row_qi[wr0 + lane] = qi;
    row_g[wr0 + lane] = gr - qi * p.group;
  }
  __syncwarp();
  {
    // the warp's 16 rows of QC 16-byte chunks, lane l copying chunks l,
    // l + 32, ... in row-major order (whole rows a pass where QC divides
    // 32).  A row past nrows only feeds its own scores and output, never
    // written: it is left as it is
    constexpr int QC = D / 8;
#pragma unroll
    for (int i = 0; i < (16 * QC + 31) / 32; ++i) {
      const int e = lane + i * 32;
      const int r = wr0 + e / QC, c = e % QC;
      if (e < 16 * QC && r < nrows)
        cp_async16(qs + r * QS + c * 8,
                   qb + row_g[r] * p.q_sh + row_qi[r] * p.q_ss + c * 8, true);
    }
  }
  if (tfirst < khi)
    load_rows<BK, DV, VS>(vs, vb, p.v_ss, tfirst, kend, vzend);
  cp_async_commit();                               // group 0: Q, K/V tile 0
  if (tfirst + BK < khi) {
    load_rows<BK, D, KS>(ks + BK * KS, kb, p.k_ss, tfirst + BK, kend, kend);
    load_rows<BK, DV, VS>(vs + BK * VS, vb, p.v_ss, tfirst + BK, kend, vzend);
  }
  cp_async_commit();                               // group 1: K/V tile 1

  // this warp's keys, and this thread's two rows, wr0 + lane / 4 and 8
  // below it
  int wlo = p.sk, whi = 0;
  if (wr0 < nrows)
    key_span(p, row_qi[wr0], row_qi[min(wr0 + 16, nrows) - 1], wlo, whi);
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    lo[h] = hi[h] = 0;
    if (r < nrows) row_interval(p, row_qi[r], lo[h], hi[h]);
  }

  // scores stay unscaled (or softcapped) in registers: the scale, and
  // log2(e) for ex2, are applied in f32 inside the exponent's FMA
  const bool capped = p.softcap > 0.f;
  const float cap_in = p.scale / p.softcap;
  const float c = capped ? LOG2E : p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // tile i sits in stage i % 2 and is copy group i: while the block works
  // on tile i, tile i + 1 is landing
  for (int t0 = tfirst, st = 0; t0 < khi; t0 += BK, st ^= 1) {
    const bf16* kt = ks + st * BK * KS;
    const bf16* vt = vs + st * BK * VS;
    const bool active = t0 < whi && t0 + BK > wlo;   // warp-uniform
    // 16-key chunk c of the tile holds some key of this warp's rows iff
    // 16 c < chi and 16 c + 16 > clo: the others are skipped (warp-uniform)
    const int clo = wlo - t0, chi = whi - t0;
    float s[NT][4];
    cp_async_wait<1>();                            // tile i (and Q)
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + (wr0 + (lane & 15)) * QS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j * 8 >= chi || j * 8 + 16 <= clo) continue;
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * KS +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // key j * 8 + e of the tile is valid for this row iff it lies in
        // [lo, hi); both bounds taken relative to this lane's first key
        const int k0 = t0 + (lane & 3) * 2, rlo = lo[h] - k0, rhi = hi[h] - k0;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if ((j & ~1) * 8 >= chi || (j & ~1) * 8 + 16 <= clo) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[j][2 * h + e];
            if (capped) x = p.softcap * tanhf(x * cap_in);
            x = (j * 8 + e >= rlo && j * 8 + e < rhi) ? x : NEG_INF;
            s[j][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float m_safe = m_new <= NEG_INF ? 0.f : m_new;
        // exp(scale x - scale m_safe) as one FMA and ex2 (or exp(x - m_safe)
        // after the softcap); a masked x (NEG_INF) gives exactly 0, as the
        // TPU kernel's where(mask, p, 0)
        const float mb = -m_safe * c;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if ((j & ~1) * 8 >= chi || (j & ~1) * 8 + 16 <= clo) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(fmaf(s[j][2 * h + e], c, mb));
            s[j][2 * h + e] = pe;
            sum += pe;
          }
        }
        // alpha = exp(m_old - m_safe); a row with no key yet has acc = 0 and
        // l = 0, where the TPU kernel's alpha = 0 changes nothing either
        if (m[h] > NEG_INF) {
          const float alpha = ex2(fmaf(m[h], c, mb));
          l[h] *= alpha;
#pragma unroll
          for (int j = 0; j < OT; ++j) {
            acc[j][2 * h] *= alpha;
            acc[j][2 * h + 1] *= alpha;
          }
        }
        l[h] += sum;   // this lane's share; summed at the end
        m[h] = m_new;
      }
    }

    if (active) {
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        if (t * 16 >= chi || t * 16 + 16 <= clo) continue;
        const uint32_t a[4] = {
            pack_bf16x2(s[2 * t][0], s[2 * t][1]),
            pack_bf16x2(s[2 * t][2], s[2 * t][3]),
            pack_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1]),
            pack_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
        for (int jj = 0; jj < DV / 16; ++jj) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VS +
                                    jj * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * jj], a, bv[0], bv[1]);
          mma_bf16(acc[2 * jj + 1], a, bv[2], bv[3]);
        }
      }
    }
    if (t0 + 2 * BK < khi) {                       // tile i + 2 into stage st
      __syncthreads();                             // once every warp is done
      load_rows<BK, D, KS>(ks + st * BK * KS, kb, p.k_ss, t0 + 2 * BK, kend,
                           kend);
      load_rows<BK, DV, VS>(vs + st * BK * VS, vb, p.v_ss, t0 + 2 * BK, kend,
                            vzend);
    }
    cp_async_commit();
  }
  // O goes through this warp's own Q rows, which only this warp loaded and
  // read
  cp_async_wait<0>();
  __syncwarp();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(FULL_MASK, lt, 1);
    lt += __shfl_xor_sync(FULL_MASK, lt, 2);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int r = wr0 + (lane >> 2) + 8 * h;
    // the row's log-sum-exp in the scaled (or softcapped) domain of its
    // exponent: ln sum exp(x) = m + ln l for the scores x = scale s (or the
    // softcapped s), so 2^(x log2 e - lse log2 e) is the row's softmax; a
    // row with no key writes +inf, which makes every such term 0
    if (p.lse != nullptr && (lane & 3) == 0 && r < nrows)
      p.lse[(static_cast<long long>(b) * p.hq + kvh * p.group + row_g[r]) *
                p.sq + row_qi[r]] =
          lt == 0.f ? INFINITY : (capped ? m[h] : m[h] * p.scale) + logf(lt);
    bf16* orow = qs + r * QS + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
  __syncwarp();
  constexpr int OC = DV / 8;
  for (int e = lane; e < 16 * OC; e += 32) {
    const int r = wr0 + e / OC, c = e % OC;
    if (r >= nrows) break;
    bf16* o = static_cast<bf16*>(p.out) +
              ((static_cast<long long>(b) * p.hq + kvh * p.group + row_g[r]) *
                   p.sq + row_qi[r]) * DV;
    *reinterpret_cast<uint4*>(o + c * 8) =
        *reinterpret_cast<const uint4*>(qs + r * QS + c * 8);
  }
}

struct FlashLaunch {
  FlashParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <int D, int DV>
  cudaError_t operator()() const {
    if (dtype == DTYPE_BF16) {
      const int rows = p.group * p.sq;
      const dim3 grid(batch * (p.hq / p.group),
                      (rows + MmaTile<D, DV>::M - 1) / MmaTile<D, DV>::M);
      return launch(flash_mma_kernel<D, DV>, grid, MmaTile<D, DV>::smem,
                    stream, p);
    }
    if (dtype == DTYPE_F32) {
      const dim3 grid(batch * p.hq, (p.sq + FLASH_ROWS - 1) / FLASH_ROWS);
      return launch(flash_kernel<float, D, DV>, grid,
                    attend_smem_bytes<D, DV, FLASH_R>(), stream, p);
    }
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int b,
    int hq, int hkv, int sq, int sk, int d, int dv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int causal,
    int window, float softcap, float scale, int q_offset, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0)
    return cudaErrorInvalidValue;
  if (dtype == repro::DTYPE_BF16) {  // 16-byte cp.async of every row
    for (long long st : {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss})
      if (st % 8 != 0) return cudaErrorInvalidValue;
    for (const void* ptr : {q, k, v, static_cast<const void*>(out)})
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return cudaErrorInvalidValue;
  }
  repro::FlashLaunch f;
  f.p = repro::FlashParams{q, k, v, out, lse, hq, hq / hkv, sq, sk,
                           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                           causal, window, q_offset, softcap, scale};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_pairs<repro::HeadPair<112, 112>,
                                    repro::HeadPair<192, 128>,
                                    repro::HeadPair<48, 32>>(d, dv, f);
}
