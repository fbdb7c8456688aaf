// Single-token decode attention against a block-paged KV cache, CUDA for
// sm_90a.
//
// Replaces repro/kernels/decode_attention.py::paged_decode_attention (Pallas
// TPU, body _paged_decode_kernel): one query token per (batch row, q-head)
// against K/V stored as (n_pages + 1, hkv, page, d) physical pages, the last
// of them the trash page.  Row i's logical key j lives in slot j % page of
// page table[i, j / page]; the row attends keys [0, min(cache_len[i],
// kv_cap)), current token included, with an optional softcap.  A row with no
// valid key writes 0.
//
// Bound on the H100: memory, as the dense decode kernel.  Each row reads its
// valid K/V once (the table adds W ints) and does ~g FLOP per byte, g =
// hq / hkv, so the least time is the valid K/V bytes over 3.35 TB/s.  At the
// serving shapes (16 rows, 61 keys, 8 kv-heads of 128) that is ~1 us, and the
// kernel is bound by its launch and its serial tile loop instead.  Design:
// the dense decode kernel's, with another key address.  One block per
// (batch row, kv-head) serves all g <= 16 grouped q-heads; it copies its row
// of the page table into shared memory once, then streams the logical keys in
// the same BK = 32 tiles through attend_rows, whose loaders resolve each key
// through the table (PagedKeys).  The softmax body and the tile order are
// those of the dense kernel, so on the same logical cache the two agree bit
// for bit.  A page may be shorter than a tile or straddle two: the loaders
// address key by key, so page sizes 8, 16, 32 and a clipped last page
// (W * page > kv_cap) need nothing special.
//
// Table entries are NOT range-checked here — that would cost a host sync per
// call.  repro_torch.serving.kv_pool.PagedKV keeps every entry of its host
// mirror in [0, n_pages] (allocated pages or the trash page), and the
// mirror is what the sampler uploads.
#include "attention_common.cuh"

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
};

constexpr int PAGED_R = 4;                       // rows per warp (max)
constexpr int PAGED_ROWS = WARPS * PAGED_R;      // max grouped q-heads
constexpr int MAX_TABLE_WIDTH = 8192;            // pages per row

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const PagedParams p) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + PAGED_ROWS * D;
  float* vs = ks + BK * (D + 1);
  int* table = reinterpret_cast<int*>(vs + BK * DV);
  __shared__ int lo[PAGED_ROWS], hi[PAGED_ROWS];
  __shared__ T* out[PAGED_ROWS];

  const int b = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int hq = p.hkv * p.g;
  const int rhi = min(p.cache_len[b], p.kv_cap);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;

  for (int e = threadIdx.x; e < PAGED_ROWS * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    qs[e] = r < p.g ? to_f32(q[(kvh * p.g + r) * p.q_sh + c]) * p.scale : 0.f;
  }
  const int* trow = p.table + static_cast<long long>(b) * p.n_w;
  for (int w = threadIdx.x; w < p.n_w; w += THREADS) table[w] = trow[w];
  if (threadIdx.x < PAGED_ROWS) {
    const int r = threadIdx.x;
    const bool active = r < p.g;
    lo[r] = 0;
    hi[r] = active ? rhi : 0;
    out[r] = active ? static_cast<T*>(p.out) +
                          (static_cast<long long>(b) * hq + kvh * p.g + r) * DV
                    : nullptr;
  }
  __syncthreads();

  attend_rows<T, D, DV, PAGED_R>(
      qs, lo, hi, out, 0, rhi,
      static_cast<const T*>(p.k) + kvh * p.k_sh,
      static_cast<const T*>(p.v) + kvh * p.v_sh,
      PagedKeys{table, p.page, p.k_sp, p.k_ss, p.v_sp, p.v_ss}, p.softcap, ks,
      vs);
}

struct PagedLaunch {
  PagedParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <int D, int DV>
  cudaError_t operator()() const {
    const dim3 grid(batch * p.hkv);
    const size_t smem =
        attend_smem_bytes<D, DV, PAGED_R>() + size_t(p.n_w) * sizeof(int);
    if (dtype == DTYPE_BF16)
      return launch(paged_decode_kernel<__nv_bfloat16, D, DV>, grid, smem,
                    stream, p);
    if (dtype == DTYPE_F32)
      return launch(paged_decode_kernel<float, D, DV>, grid, smem, stream, p);
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
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::PAGED_ROWS ||
      page <= 0 || n_w <= 0 || n_w > repro::MAX_TABLE_WIDTH || kv_cap <= 0 ||
      kv_cap > static_cast<long long>(n_w) * page)
    return cudaErrorInvalidValue;
  repro::PagedLaunch f;
  f.p = repro::PagedParams{q, k, v, static_cast<const int*>(cache_len),
                           static_cast<const int*>(table), out,
                           hkv, hq / hkv, page, n_w, kv_cap,
                           q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss,
                           softcap, scale};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_dims(d, dv, f);
}
