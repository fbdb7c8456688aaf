// Cosine top-k anchor retrieval, CUDA for sm_90a.
//
// Replaces repro/kernels/topk_retrieval.py::topk_retrieval (Pallas TPU, body
// _topk_kernel): scores of unit-norm queries (q, d) against unit-norm anchors
// (n, d), keeping the k best per query, ties to the lower anchor index (the
// order lax.top_k gives the TPU merge).  Normalization stays outside, in the
// wrapper, as on the TPU.
//
// Bound on the H100: neither bytes nor FLOPs — at the SCOPE shape (q = 8
// queries, n = 250 anchors, d = 32, k = 5) the inputs are 33 KB and the work
// 128 KFLOP, so the kernel is bound by its launch and the k selection rounds.
// Design: one block per query row.  Anchors stream in chunks of 1024: each
// warp scores one anchor at a time (lanes across d, coalesced, one warp-sum),
// writing the chunk's scores into shared memory behind the running top-k
// buffer; then k rounds of a block-wide arg-max over (buffer + chunk) pick
// the new buffer — the same merge as the TPU kernel's running (score, index)
// buffer, with the (score desc, index asc) order made explicit.
#include <climits>
#include <math.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 1024;
constexpr int KMAX = 64;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(THREADS)
topk_kernel(const float* __restrict__ qn, const float* __restrict__ an,
            float* __restrict__ scores, int* __restrict__ idx, int na, int d,
            int k) {
  extern __shared__ float qsh[];  // d floats: this block's query row
  __shared__ float cs[KMAX + CHUNK];
  __shared__ int ci[KMAX + CHUNK];
  __shared__ float sel_s[KMAX];
  __shared__ int sel_i[KMAX];
  __shared__ float red_s[WARPS];
  __shared__ int red_i[WARPS], red_p[WARPS];

  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < d; c += THREADS) qsh[c] = qn[(long long)row * d + c];
  __syncthreads();

  int nbuf = 0;  // running top-k entries at the front of cs/ci
  for (int base = 0; base < na; base += CHUNK) {
    const int cnt = min(CHUNK, na - base);
    for (int a = warp; a < cnt; a += WARPS) {
      const float* ar = an + (long long)(base + a) * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(qsh[c], ar[c], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
      if (lane == 0) {
        cs[nbuf + a] = s;
        ci[nbuf + a] = base + a;
      }
    }
    __syncthreads();

    const int ncand = nbuf + cnt;
    for (int r = 0; r < k; ++r) {
      float bs = -INFINITY;
      int bi = INT_MAX, bp = -1;
      for (int p = threadIdx.x; p < ncand; p += THREADS) {
        if (better(cs[p], ci[p], bs, bi)) {
          bs = cs[p];
          bi = ci[p];
          bp = p;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float os = __shfl_xor_sync(FULL_MASK, bs, o);
        const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
        const int op = __shfl_xor_sync(FULL_MASK, bp, o);
        if (better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
          bp = op;
        }
      }
      if (lane == 0) {
        red_s[warp] = bs;
        red_i[warp] = bi;
        red_p[warp] = bp;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < WARPS; ++w) {
          if (better(red_s[w], red_i[w], bs, bi)) {
            bs = red_s[w];
            bi = red_i[w];
            bp = red_p[w];
          }
        }
        sel_s[r] = bs;
        sel_i[r] = bi;
        if (bp >= 0) {  // taken: never selected again
          cs[bp] = -INFINITY;
          ci[bp] = INT_MAX;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < k) {
      cs[threadIdx.x] = sel_s[threadIdx.x];
      ci[threadIdx.x] = sel_i[threadIdx.x];
    }
    nbuf = k;
    __syncthreads();
  }
  if (threadIdx.x < k) {
    scores[(long long)row * k + threadIdx.x] = cs[threadIdx.x];
    idx[(long long)row * k + threadIdx.x] = ci[threadIdx.x];
  }
}

}  // namespace

extern "C" int repro_topk_retrieval(const void* qn, const void* an,
                                    void* scores, void* idx, int nq, int na,
                                    int d, int k, void* stream) {
  if (nq <= 0 || k <= 0 || k > KMAX || k > na || d <= 0 || d > 4096)
    return cudaErrorInvalidValue;
  topk_kernel<<<nq, THREADS, d * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qn), static_cast<const float*>(an),
      static_cast<float*>(scores), static_cast<int*>(idx), na, d, k);
  return cudaGetLastError();
}
