// Single-token decode attention against a block-paged KV cache, CUDA for
// sm_90a.
//
// Replaces repro/kernels/decode_attention.py:185 paged_decode_attention
// (Pallas TPU, body _paged_decode_kernel, pl.pallas_call at :234): one
// query token per (batch row, q-head) against K/V stored as (n_pages + 1,
// hkv, page, d) physical pages, the last of them the trash page.  Row i's
// logical key j lives in slot j % page of page table[i, j / page]; the row
// attends keys [0, min(cache_len[i], kv_cap)), current token included,
// with an optional softcap.  A row with no valid key writes 0.
//
// Bound on the H100: bytes, as the dense decode kernel.  Each row reads its
// valid K/V once (and one table entry a valid page) and does ~g FLOP per
// byte, g = hq / hkv, so the least time is the valid K/V bytes over 3.35
// TB/s: ~1.3 us at the stream's shape (16 rows x 8 kv-heads, 61 keys of
// 128, bf16), where 128 blocks leave most SMs with one block and the time
// is that block's chain of latencies.  The first version paid, on top of
// the dense kernel's serial tile loop, a runtime division and a table read
// per key *element* and a copy of the row's whole table into shared memory.
// Design: the dense kernel's body, decode_block (decode_common.cuh), with
// another key-row address (PagedRows): one block per (batch row, kv-head)
// and 4 of its g <= 16 grouped q-heads; each key row's address is
// resolved once, by one lane, from the table entry of its page, only for
// valid keys; every valid key of a 64-key stage is in flight at once as
// 16-byte cp.async.  A page may be shorter than a chunk or straddle two:
// rows are addressed one by one, so page sizes 8, 16, 32 and a clipped
// last page (W * page > kv_cap) need nothing special.  The chunks follow
// logical positions, so on the same logical cache the paged and the dense
// kernels agree bit for bit.  Head dims as the dense kernel's, 112 included.
//
// Table entries are NOT range-checked here — that would cost a host sync per
// call.  repro_torch.serving.kv_pool.PagedKV keeps every entry of its host
// mirror in [0, n_pages] (allocated pages or the trash page), and the
// mirror is what the sampler uploads.
#include "decode_common.cuh"

namespace repro {

struct PagedParams {
  const void* q;          // (b, hq, 1, d), strided
  const void* k;          // (n_pages + 1, hkv, page, d), strided
  const void* v;          // (n_pages + 1, hkv, page, dv), strided
  const int* cache_len;   // (b,)
  const int* table;       // (b, n_w), contiguous
  void* out;              // (b, hq, 1, dv), contiguous
  int hkv, g, page, n_w, kv_cap;
  long long q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss;
  float softcap, scale;
  bool vec16;  // every K/V row starts on 16 bytes
};

constexpr int MAX_TABLE_WIDTH = 8192;            // pages per row

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS, DecodeGeom<T, D, DV>::MIN_BLOCKS)
    paged_decode_kernel(const PagedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const long long head0 = static_cast<long long>(b) * p.hkv * p.g +
                          kvh * p.g;
  decode_block<T, D, DV>(
      static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.g * p.q_sh, p.q_sh,
      p.g, p.cache_len + b, static_cast<const T*>(p.k) + kvh * p.k_sh,
      static_cast<const T*>(p.v) + kvh * p.v_sh,
      PagedRows{p.table + static_cast<long long>(b) * p.n_w, p.page,
                p.kv_cap, p.k_sp, p.k_ss, p.v_sp, p.v_ss},
      static_cast<T*>(p.out) + head0 * DV, p.softcap, p.scale,
      p.vec16, blockIdx.y * DEC_HEADS, smem);
}

struct PagedLaunch {
  PagedParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <typename T, int D, int DV>
  cudaError_t run() const {
    PagedParams q = p;
    q.vec16 = rows_aligned16(p.k, sizeof(T), {p.k_sp, p.k_sh, p.k_ss}) &&
              rows_aligned16(p.v, sizeof(T), {p.v_sp, p.v_sh, p.v_ss});
    return launch(paged_decode_kernel<T, D, DV>,
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

extern "C" int repro_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* cache_len,
    const void* table, void* out, int dtype, int b, int hq, int hkv, int d,
    int dv, int page, int n_w, int kv_cap, long long q_sb, long long q_sh,
    long long k_sp, long long k_sh, long long k_ss, long long v_sp,
    long long v_sh, long long v_ss, float softcap, float scale,
    void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::DEC_MAX_GROUP ||
      page <= 0 || n_w <= 0 || n_w > repro::MAX_TABLE_WIDTH || kv_cap <= 0 ||
      kv_cap > static_cast<long long>(n_w) * page)
    return cudaErrorInvalidValue;
  repro::PagedLaunch f;
  f.p = repro::PagedParams{q, k, v, static_cast<const int*>(cache_len),
                           static_cast<const int*>(table), out,
                           hkv, hq / hkv, page, n_w, kv_cap,
                           q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss,
                           softcap, scale, false};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_dims<112>(d, dv, f);
}
