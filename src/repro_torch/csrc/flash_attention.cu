// Flash attention for the prefill, CUDA for sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (Pallas TPU,
// body _flash_kernel): GQA attention over the full sequence with an online
// softmax over KV blocks; causal with q_offset, sliding window, softcap
// before the mask, a true-seq_k pad mask, dv != d, KV head = h // group.
//
// Bound on the H100: at the SCOPE prefill shape (sq = sk ~ 49, d = 128,
// bf16) a (batch, head) does ~49 * 49 / 2 * 2 * 256 FLOPs on 49 * 3 * 256
// bytes — ~8 FLOP/B, far below the ~295 FLOP/B where bf16 tensor cores would
// be the limit — so the bound is moving q/k/v/o once.  Design: one block per
// (batch * q-head, 16-row q tile); each block streams its KV head's tiles
// (only up to the causal / window limit of its rows) through shared memory
// once and keeps the softmax state in registers, so nothing of size sq x sk
// ever reaches device memory.  This first version does its dot products as
// f32 FMAs out of shared memory, which (not the bytes) limits it; tensor-core
// tiles are the next step (PERF.md has its time beside the bound).
// Inputs may be strided views (last dim contiguous): the model passes the
// (b, s, h, d) projections transposed without a copy.
#include "attention_common.cuh"

namespace repro {

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // (b, hq, sq, dv), contiguous
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
    if (qi < p.sq) {
      const int qpos = qi + p.q_offset;
      rhi = p.causal ? min(qpos + 1, p.sk) : p.sk;
      rlo = p.window > 0 ? max(qpos - p.window + 1, 0) : 0;
      o = static_cast<T*>(p.out) +
          ((static_cast<long long>(b) * p.hq + h) * p.sq + qi) * DV;
    }
    lo[r] = rlo;
    hi[r] = rhi;
    out[r] = o;
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
      DenseKeys{p.k_ss, p.v_ss}, p.softcap, ks, vs);
}

struct FlashLaunch {
  FlashParams p;
  int batch, dtype;
  cudaStream_t stream;

  template <int D, int DV>
  cudaError_t operator()() const {
    const dim3 grid(batch * p.hq, (p.sq + FLASH_ROWS - 1) / FLASH_ROWS);
    const size_t smem = attend_smem_bytes<D, DV, FLASH_R>();
    if (dtype == DTYPE_BF16)
      return launch(flash_kernel<__nv_bfloat16, D, DV>, grid, smem, stream, p);
    if (dtype == DTYPE_F32)
      return launch(flash_kernel<float, D, DV>, grid, smem, stream, p);
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int hq, int hkv, int sq, int sk, int d, int dv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int causal,
    int window, float softcap, float scale, int q_offset, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0)
    return cudaErrorInvalidValue;
  repro::FlashLaunch f;
  f.p = repro::FlashParams{q, k, v, out, hq, hq / hkv, sq, sk,
                           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                           causal, window, q_offset, softcap, scale};
  f.batch = b;
  f.dtype = dtype;
  f.stream = static_cast<cudaStream_t>(stream);
  return repro::dispatch_head_dims(d, dv, f);
}
