// Shared block routine of the dense and the block-paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu): one query token of g
// grouped q-heads against the valid keys [lo, hi) of one (batch row,
// kv-head), for sm_90a.
//
// What bounds it on the H100.  A decode step reads each valid K/V row once
// and does ~g FLOP per byte, far below the ~295 FLOP/B where the card's
// arithmetic would be the limit, so the bound is bytes.  At the serving
// shapes (61 keys of 128, 4 q-heads a kv-head, bf16) a block moves ~31 KB,
// and what it costs is its chain of latencies: the launch, the loads of
// its length, K/V and q, then the dependent arithmetic on them.  The design
// keeps that chain short:
//
//  * Every valid key of a stage is in flight before any is waited on.  The
//    keys split into chunks of 16 by logical position; chunk c belongs to
//    warp c % 4, so one stage of 64 keys is one chunk a warp and a 61-key
//    row is one stage.  Each warp copies its own chunks, K and V in their
//    storage type, with 16-byte cp.async, and waits only on its own copies:
//    no block barrier until the combine.  q's loads go out right after the
//    copy.  Longer rows run the same loop, one K/V buffer a warp: a warp
//    issues its next chunk's copy once it is done with this one.
//  * A key row's address is computed once, by one lane, before its copy:
//    for a paged cache that is one division and one read of the page table,
//    and only for valid keys (the block never copies the table).  Invalid
//    slots of a chunk are zero-filled without a read, so the trash page and
//    unreferenced pages are never touched.
//  * Each warp scores its chunk for all heads of its block: the LK lanes
//    that share a K row read it in 16-byte pieces (bf16 converted in
//    registers) against q held in registers, a chain of at most 8 FMAs, and
//    the partial sums of the chunk's 16 rows meet in a reduce-scatter
//    butterfly (one shuffle per row and head) that leaves each lane pair
//    with one key's score.  The online softmax (m, l, acc) runs per warp
//    over its own chunks in f32, with the TPU kernel's guards (m_safe,
//    alpha = 0 on the first key, masked keys p = 0); P goes through a
//    warp-private shared buffer to P.V, where each lane owns ceil(dv / 32)
//    output columns (DecodeGeom: at d 112 some lanes sit out, see there).
//    Plain FMAs: at ~g FLOP/B tensor cores would change nothing.
//  * One combine: the warps' (m, l, acc) meet in shared memory behind one
//    barrier and merge in warp order; a warp without a valid key is
//    skipped, so an empty chunk is an exact no-op.  l == 0 -> 1, so a row
//    with no valid key writes 0.
//
// A row's arithmetic depends only on its logical keys, [lo, hi), softcap
// and scale: the chunk split is fixed by logical position, the score's
// summation order by d and the dtype, and the combine by warp order.  So a
// paged and a dense cache holding the same logical keys give the same bits,
// whatever S, kv_cap, the page size, the table, the batch or the grid; and
// with no atomics two launches give the same bits.
//
// Heads: a block keeps DEC_HEADS = 4 q-heads in registers (the main path's
// group).  A larger group (up to 16) takes dec_head_blocks(g) blocks of 4 heads
// side by side (blockIdx.y): at starcoder2-3b's group of 12 on 2 kv-heads
// that is 3 x 112 blocks instead of 112 blocks of three passes in a row,
// which left most SMs idle; the blocks of one (row, kv-head) after the
// first read its K/V from L2.  A head's arithmetic does not depend on its
// block, so the split changes no output bit.  Registers: bf16 heads up to 128
// are held to 128 a thread (4 blocks a SM, see DecodeGeom::MIN_BLOCKS);
// no instantiation spills.  K/V rows sit unpadded in shared memory: the
// lanes of a read always cover contiguous 128-byte lines, so no bank is hit
// twice.  Caches whose rows are not 16-byte aligned (views with odd
// strides) are copied element by element into the same layout, so they
// give the same bits.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "attention_common.cuh"
#include "mma_bf16.cuh"

namespace repro {

constexpr int DEC_CHUNK = 16;                   // keys a chunk
constexpr int DEC_HEADS = 4;                    // q-heads a block
constexpr int DEC_MAX_GROUP = 16;               // grouped q-heads a kv-head

// Blocks of DEC_HEADS q-heads for a group of g: the decode grid's y extent.
constexpr int dec_head_blocks(int g) {
  return (g + DEC_HEADS - 1) / DEC_HEADS;
}

// Where a row's keys are: its key interval [lo, hi) from its valid length,
// and key rows' addresses, in elements from this (row, kv-head)'s K and V
// bases.
struct DenseRows {
  long long k_ss, v_ss;
  int S, window;
  __device__ __forceinline__ void interval(int len, int& lo, int& hi) const {
    hi = min(len, S);
    lo = window > 0 ? max(len - window, 0) : 0;
  }
  __device__ __forceinline__ void at(int kpos, long long& ko,
                                     long long& vo) const {
    ko = kpos * k_ss;
    vo = kpos * v_ss;
  }
};

// Logical key j lives in slot j % page of physical page table[j / page]; the
// bases point at this kv-head's slice of page 0.
struct PagedRows {
  const int* table;  // this row's page table, in global memory
  int page, kv_cap;
  long long k_sp, k_ss, v_sp, v_ss;  // page and slot strides of K and V
  __device__ __forceinline__ void interval(int len, int& lo, int& hi) const {
    hi = min(len, kv_cap);
    lo = 0;
  }
  __device__ __forceinline__ void at(int kpos, long long& ko,
                                     long long& vo) const {
    const int lp = kpos / page;
    const long long pg = __ldg(table + lp);
    const long long slot = kpos - lp * page;
    ko = pg * k_sp + slot * k_ss;
    vo = pg * v_sp + slot * v_ss;
  }
};

constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Lane geometry.  A K row of PK 16-byte pieces is read by LK lanes, PK
// rounded up to a power of two so that the reduce-scatter's butterfly holds:
// where PK is not one (d 112: 14 pieces in bf16, 28 in f32) the lanes past
// PK read nothing and add 0.  Each lane owns EV = ceil(dv / 32) output
// columns; where 32 does not divide dv (112: 4 columns) the first LV = dv /
// EV lanes own them and the rest sit out P.V.  For every power-of-two head
// dim PK = LK * PL and LV = 32, the geometry the kernels had before.
template <typename T, int D, int DV>
struct DecodeGeom {
  static constexpr int VEC = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int PK = D / VEC;           // 16-byte pieces of a K row
  static constexpr int PKP = pow2_ceil(PK);    // ... rounded to a power of 2
  static constexpr int LK = PKP < 32 ? PKP : 32; // lanes that share a K row
  static constexpr int PL = PKP / LK;          // pieces a lane reads of it
  static constexpr int KW = 32 / LK;           // K rows a warp reads at once
  static constexpr int NI = DEC_CHUNK / KW;    // rounds a chunk (= LK / 2)
  static constexpr int QE = PL * VEC;          // q elements a lane holds
  static constexpr int EV = (DV + 31) / 32;    // output columns a lane owns
  static constexpr int LV = DV / EV;           // lanes that own columns
  static constexpr int BUF = DEC_CHUNK * (D + DV);   // elements a buffer
  // the batch decode grid (56 x 8 blocks of bf16 d 128) runs in one wave
  // only at 4 blocks a SM, so bf16 heads up to 128 are held to 128
  // registers a thread; other instantiations may take what they need (left
  // to itself, ptxas caps some of them at 80-128 registers and spills)
  static constexpr int MIN_BLOCKS = sizeof(T) == 2 && D <= 128 && DV <= 128
                                        ? 4 : 1;
  static_assert(NI * 2 == LK, "the reduce-scatter needs NI = LK / 2");
  static_assert(D % 16 == 0 && DV % 16 == 0 && LV * EV == DV,
                "head dims must be multiples of 16");
};

// Dynamic shared memory of one block: each warp's K/V buffer, the row
// offsets and P of its chunk, and the warps' (acc, m, l) for the combine.
template <typename T, int D, int DV>
constexpr size_t decode_smem_bytes() {
  return size_t(WARPS) * DecodeGeom<T, D, DV>::BUF * sizeof(T) +
         size_t(WARPS) * 2 * DEC_CHUNK * sizeof(long long) +
         size_t(WARPS) * DEC_HEADS * DEC_CHUNK * sizeof(float) +
         size_t(WARPS) * DEC_HEADS * (DV + 2) * sizeof(float);
}

// True when every K/V row of the cache starts on 16 bytes, so chunks can
// come in 16-byte cp.async pieces.
inline bool rows_aligned16(const void* base, size_t elem,
                           std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (long long s : strides)
    if ((s * static_cast<long long>(elem)) % 16) return false;
  return true;
}

// N contiguous elements of shared memory (aligned to their size, up to 16
// bytes) to f32 registers.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * int(sizeof(T));
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < PER; ++e) out[i * PER + e] = to_f32(t[e]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  } else if constexpr (BYTES == 4) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  } else {
    out[0] = to_f32(p[0]);
  }
}

// One warp copies the W-element rows of one chunk into dst (DEC_CHUNK x W,
// unpadded); offs[j] is key j's row offset from src, or < 0 for a slot
// outside the row's keys, which is zero-filled without a read.
template <typename T, int W>
__device__ __forceinline__ void copy_chunk(T* dst, const T* __restrict__ src,
                                           const long long* offs, int lane,
                                           bool vec16) {
  constexpr int VEC = 16 / sizeof(T), P = W / VEC;
  static_assert(DEC_CHUNK * P % 32 == 0, "a chunk is whole passes of 32");
#pragma unroll
  for (int t = 0; t < DEC_CHUNK * P / 32; ++t) {
    const int e = lane + 32 * t;
    const int j = e / P, pc = e - j * P;
    const long long o = offs[j];
    T* d = dst + j * W + pc * VEC;
    const T* s = src + (o < 0 ? 0 : o) + pc * VEC;
    if (vec16) {
      cp_async16(d, s, o >= 0);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) d[x] = o >= 0 ? s[x] : from_f32<T>(0.f);
    }
  }
}

// Leaves v[0][h] = the sum, over the LK lanes of this lane's K row group,
// of the partials v[i][h] of round i = r >> 1 (r = lane % LK): each round
// halves the values a lane holds and exchanges the other half with the lane
// CNT away.
template <int NI, int H, int CNT = NI>
__device__ __forceinline__ void reduce_scatter(float (&v)[NI][H], int r) {
  if constexpr (CNT > 1) {
    constexpr int HALF = CNT / 2;
    const bool upper = r & CNT;
#pragma unroll
    for (int t = 0; t < HALF; ++t) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float send = upper ? v[t][h] : v[t + HALF][h];
        const float keep = upper ? v[t + HALF][h] : v[t][h];
        v[t][h] = keep + __shfl_xor_sync(FULL_MASK, send, CNT);
      }
    }
    reduce_scatter<NI, H, HALF>(v, r);
  }
}

// One warp starts the copy of chunk c of this (row, kv-head) into its K/V
// buffer kb: lanes 0-15 resolve the chunk's key rows (rows.at, valid keys
// only) into offs, then all 32 lanes issue the 16-byte pieces, one commit.
template <typename T, int D, int DV, typename Rows>
__device__ __forceinline__ void issue_chunk(T* kb, long long* offs, int c,
                                            int lo, int hi, const Rows& rows,
                                            const T* __restrict__ kp,
                                            const T* __restrict__ vp,
                                            int lane, bool vec16) {
  __syncwarp();                     // every lane is done with the old offsets
  if (lane < DEC_CHUNK) {
    const int kpos = c * DEC_CHUNK + lane;
    long long ko = -1, vo = -1;
    if (kpos >= lo && kpos < hi) rows.at(kpos, ko, vo);
    offs[lane] = ko;
    offs[DEC_CHUNK + lane] = vo;
  }
  __syncwarp();
  copy_chunk<T, D>(kb, kp, offs, lane, vec16);
  copy_chunk<T, DV>(kb + DEC_CHUNK * D, vp, offs + DEC_CHUNK, lane, vec16);
  cp_async_commit();
}

// The block's q-heads [h0, h0 + nh) as this lane reads them (the elements
// of its pieces of d), in f32 times the scale; 0 past the group and past
// the row's PK pieces.
template <typename T, int QE, int VEC, int LK, int PK, int H>
__device__ __forceinline__ void load_q(float (&qr)[H][QE],
                                       const T* __restrict__ q,
                                       long long q_sh, int h0, int nh, int r,
                                       float scale) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int x = 0; x < QE; ++x) {
      const int piece = r + (x / VEC) * LK;
      const int col = piece * VEC + x % VEC;
      qr[h][x] = h < nh && piece < PK
                     ? to_f32(q[(h0 + h) * q_sh + col]) * scale : 0.f;
    }
  }
}

// q: this row's first q-head of the kv-head (heads q_sh apart, d
// contiguous); len: the row's valid length, which rows turns into its key
// interval [lo, hi); kp / vp: this (row, kv-head)'s K / V bases, key j's
// row at kp + rows.at(j); out: (g, DV) contiguous.  The block serves the
// heads [h0, h0 + DEC_HEADS) below g.  vec16: K and V rows start on 16
// bytes.
template <typename T, int D, int DV, typename Rows>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, long long q_sh, int g,
    const int* __restrict__ len, const T* __restrict__ kp,
    const T* __restrict__ vp, const Rows rows, T* __restrict__ out,
    float softcap, float scale, bool vec16, int h0, unsigned char* smem) {
  using G = DecodeGeom<T, D, DV>;
  constexpr int CH = DEC_CHUNK, H = DEC_HEADS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  T* kv = reinterpret_cast<T*>(smem) + warp * G::BUF;
  long long* offs_all = reinterpret_cast<long long*>(
      smem + size_t(WARPS) * G::BUF * sizeof(T));
  long long* offs = offs_all + warp * 2 * CH;
  float* pbuf_all = reinterpret_cast<float*>(offs_all + WARPS * 2 * CH);
  float* pw = pbuf_all + warp * H * CH;
  float* comb = pbuf_all + WARPS * H * CH;    // [WARPS][H][DV + 2]

  int lo, hi;
  rows.interval(*len, lo, hi);
  // this warp's chunks: first, first + WARPS, ... up to the one holding
  // key hi - 1
  const int c_lo = lo / CH;
  const int first =
      c_lo + ((warp - c_lo) % WARPS + WARPS) % WARPS;
  const int n_mine = (hi > lo && first * CH < hi)
                         ? ((hi - 1) / CH - first) / WARPS + 1 : 0;
  // lane = kg * LK + r reads piece r (+ LK ...) of K row i * KW + kg in
  // round i, and ends with the score of key (r >> 1) * KW + kg
  const int kg = lane / G::LK, r = lane % G::LK;
  const int my_key = (r >> 1) * G::KW + kg;

  const int nh = min(H, g - h0);
  if (n_mine > 0)
    issue_chunk<T, D, DV>(kv, offs, first, lo, hi, rows, kp, vp, lane, vec16);
  // q's loads fly beside the chunk's copy
  float qr[H][G::QE], m[H], l[H], acc[H][G::EV];
  load_q<T, G::QE, G::VEC, G::LK, G::PK, H>(qr, q, q_sh, h0, nh, r, scale);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < G::EV; ++e) acc[h][e] = 0.f;
  }

  for (int i = 0; i < n_mine; ++i) {
    const int c = first + i * WARPS;
    cp_async_wait<0>();
    __syncwarp();
    const T* kb = kv;
    const T* vb = kb + CH * D;
    // scores: partial dot products of every K row this lane reads ...
    float part[G::NI][H];
#pragma unroll
    for (int it = 0; it < G::NI; ++it) {
#pragma unroll
      for (int h = 0; h < H; ++h) part[it][h] = 0.f;
#pragma unroll
      for (int pp = 0; pp < G::PL; ++pp) {
        if (G::PK != G::PKP && r + pp * G::LK >= G::PK) continue;
        float kf[G::VEC];
        load_f32<T, G::VEC>(
            kb + (it * G::KW + kg) * D + (r + pp * G::LK) * G::VEC, kf);
#pragma unroll
        for (int h = 0; h < H; ++h) {
#pragma unroll
          for (int e = 0; e < G::VEC; ++e)
            part[it][h] = fmaf(qr[h][pp * G::VEC + e], kf[e], part[it][h]);
        }
      }
    }
    // ... summed over the row's lanes: lanes 2x and 2x + 1 hold my_key's
    reduce_scatter<G::NI, H>(part, r);

    // the online softmax of this warp's keys
    const int kpos = c * CH + my_key;
    const bool valid = kpos >= lo && kpos < hi;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float s = part[0][h] + __shfl_xor_sync(FULL_MASK, part[0][h], 1);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = valid ? s : NEG_INF;
      float cm = s;                 // max and sum over the 16 keys: lanes
#pragma unroll                       // 2x and 2x + 1 hold the same key
      for (int o = 2; o < 32; o <<= 1)
        cm = fmaxf(cm, __shfl_xor_sync(FULL_MASK, cm, o));
      const float m_new = fmaxf(m[h], cm);
      const float m_safe = m_new <= NEG_INF ? 0.f : m_new;
      const float p = valid ? expf(s - m_safe) : 0.f;
      const float alpha = m[h] <= NEG_INF ? 0.f : expf(m[h] - m_safe);
      float ps = p;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        ps += __shfl_xor_sync(FULL_MASK, ps, o);
      l[h] = l[h] * alpha + ps;
#pragma unroll
      for (int e = 0; e < G::EV; ++e) acc[h][e] *= alpha;
      if (!(lane & 1)) pw[h * CH + my_key] = p;
      m[h] = m_new;
    }
    __syncwarp();
    // P.V: this lane's EV columns of every key of the chunk
    if (G::LV == 32 || lane < G::LV) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float vf[G::EV];
        load_f32<T, G::EV>(vb + j * DV + lane * G::EV, vf);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float pj = pw[h * CH + j];
#pragma unroll
          for (int e = 0; e < G::EV; ++e)
            acc[h][e] = fmaf(pj, vf[e], acc[h][e]);
        }
      }
    }
    __syncwarp();                   // the buffer and P are free again
    if (i + 1 < n_mine)
      issue_chunk<T, D, DV>(kv, offs, c + WARPS, lo, hi, rows, kp, vp,
                            lane, vec16);
  }

  // the combine: every warp's (acc, m, l), merged in warp order
  float* cw = comb + warp * H * (DV + 2);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (G::LV == 32 || lane < G::LV) {
#pragma unroll
      for (int e = 0; e < G::EV; ++e)
        cw[h * (DV + 2) + lane * G::EV + e] = acc[h][e];
    }
    if (lane == 0) {
      cw[h * (DV + 2) + DV] = m[h];
      cw[h * (DV + 2) + DV + 1] = l[h];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nh * DV; idx += THREADS) {
    const int h = idx / DV, col = idx - h * DV;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mx = fmaxf(mx, comb[(w * H + h) * (DV + 2) + DV]);
    const float m_safe = mx <= NEG_INF ? 0.f : mx;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* cr = comb + (w * H + h) * (DV + 2);
      if (cr[DV] <= NEG_INF) continue;      // no valid key in this warp
      const float f = expf(cr[DV] - m_safe);
      lsum = fmaf(cr[DV + 1], f, lsum);
      a = fmaf(cr[col], f, a);
    }
    out[(h0 + h) * DV + col] = from_f32<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

}  // namespace repro
