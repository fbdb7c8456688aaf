// Single-token decode attention against a dense KV cache, CUDA for sm_90a.
//
// Replaces repro/kernels/decode_attention.py:88 decode_attention (Pallas
// TPU, body _decode_kernel, pl.pallas_call at :113): one query token per
// (batch row, q-head) against a (b, hkv, S, d) cache, masked by the row's
// valid length cache_len[b] (current token included), an optional sliding
// window and softcap.  A row with no valid key writes 0.
//
// Bound on the H100: bytes.  Each row reads its valid K/V once and does ~g
// FLOP per byte (g = hq / hkv), so the least time is the valid K/V bytes
// over 3.35 TB/s; at the batch decode shape (56 rows x 8 kv-heads, 61 keys
// of 128, bf16) ~4.5 us.  What held the first version back was latency
// inside a block (one 2-byte load per thread per step, a 128-FMA chain per
// key, two barriers per 32-key tile), not bytes.  Design: one block per
// (batch row, kv-head) serves its g <= 4 grouped q-heads, so each head's
// K/V are read once (a group of up to 16 takes a block for each 4 heads,
// the grid's y); it stops at the row's length (and starts at its window)
// instead of sweeping S.  The block body is decode_block
// (decode_common.cuh): every valid key of a 64-key stage in flight at once
// as 16-byte cp.async, split by logical position over the 4 warps, scored
// in registers, one combine.  The paged kernel runs the same body, so on
// the same logical cache the two agree bit for bit.  Head dims: any (d,
// dv) pair of 32, 64, 128 and 256, and d = dv = 112 (zamba2-7b's shared
// attention, group 1, whose rows of 14 or 28 16-byte pieces leave a few
// lanes idle: DecodeGeom).
#include "decode_common.cuh"

namespace repro {

struct DecodeParams {
  const void* q;  // (b, hq, 1, d), strided
  const void* k;  // (b, hkv, S, d), strided
  const void* v;  // (b, hkv, S, dv), strided
  const int* cache_len;  // (b,)
  void* out;  // (b, hq, 1, dv), contiguous
  int hkv, g, S, window;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float softcap, scale;
  bool vec16;  // every K/V row starts on 16 bytes
};

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS, DecodeGeom<T, D, DV>::MIN_BLOCKS)
    decode_kernel(const DecodeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const long long head0 = static_cast<long long>(b) * p.hkv * p.g +
                          kvh * p.g;
  decode_block<T, D, DV>(
      static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.g * p.q_sh, p.q_sh,
      p.g, p.cache_len + b,
      static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
      static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
      DenseRows{p.k_ss, p.v_ss, p.S, p.window},
      static_cast<T*>(p.out) + head0 * DV, p.softcap, p.scale,
      p.vec16, blockIdx.y * DEC_HEADS, smem);
}

struct DecodeLaunch {
  DecodeParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <typename T, int D, int DV>
  cudaError_t run() const {
    DecodeParams q = p;
    q.vec16 = rows_aligned16(p.k, sizeof(T), {p.k_sb, p.k_sh, p.k_ss}) &&
              rows_aligned16(p.v, sizeof(T), {p.v_sb, p.v_sh, p.v_ss});
    return launch(decode_kernel<T, D, DV>,
                  dim3(batch * p.hkv, dec_head_blocks(p.g)),
                  decode_smem_bytes<T, D, DV>(), stream, q);
  }

  template <int D, int DV>
  cudaError_t operator()() const {
    if (dtype == DTYPE_BF16) return run<__nv_bfloat16, D, DV>();
    if (dtype == DTYPE_F32) return run<float, D, DV>();
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, int dtype, int b, int hq, int hkv, int S, int d, int dv,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int window,
    float softcap, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::DEC_MAX_GROUP)
    return cudaErrorInvalidValue;
  repro::DecodeLaunch f;
  f.p = repro::DecodeParams{q, k, v, static_cast<const int*>(cache_len), out,
                            hkv, hq / hkv, S, window,
                            q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            softcap, scale, false};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_dims<112>(d, dv, f);
}
