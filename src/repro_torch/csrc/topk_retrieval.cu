// Cosine top-k anchor retrieval, CUDA for sm_90a.
//
// Replaces repro/kernels/topk_retrieval.py::topk_retrieval (Pallas TPU, body
// _topk_kernel): scores of the queries (q, d) against the anchors (n, d),
// both taken to unit norm as x / (|x| + 1e-8), keeping the k best per query,
// ties to the lower anchor index (the order lax.top_k gives the TPU merge).
// Unlike the TPU kernel, the normalization happens here, inside the one
// launch: the query's always, the anchors' unless the caller passes them
// unit-norm already (the retriever does, once, at construction).
//
// Bound on the H100: neither bytes nor FLOPs — at the SCOPE shape (q = 8
// queries, n = 250 anchors, d = 32, k = 5) the inputs are 33 KB and the work
// 128 KFLOP, so the kernel is bound by its launch and its latency chain.
// Design, for latency: one block of 256 threads per query.  The block
// normalizes its query into shared memory (the only two block barriers
// before the final merge).  Anchors go in chunks of 256, warp w owning
// anchors base + 32 w + lane: for d <= 128 each thread scores its own
// anchor row, all of the row's float4 loads in flight at once; for larger d
// the warp scores its 32 anchors one at a time, lanes across d.  Each warp
// keeps a running top-k in registers (slot r in lane r % 32) and merges
// each chunk into it with k rounds of a warp shuffle arg-max under the
// explicit (score desc, index asc) order, skipped when no new score beats
// the current k-th.  One barrier later, warp 0 merges the warps' lists the
// same way and writes the result.
#include <climits>
#include <cstdint>
#include <math.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 64;
constexpr int RUN = KMAX / 32;        // running top-k entries a lane holds
constexpr int THREAD_ROW_D = 128;     // a thread per anchor row up to this d
constexpr float EPS = 1e-8f;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct TopkParams {
  const float* q;    // (nq, d) raw queries
  const float* a;    // (na, d) anchors
  float* scores;     // (nq, k)
  int* idx;          // (nq, k)
  int na, d, k, normalize_anchors, vec;
};

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// the warp's best (s, i) pair, in every lane
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(FULL_MASK, s, o);
    const int oi = __shfl_xor_sync(FULL_MASK, i, o);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Merge one new candidate a lane (ns, ni) into the warp's running top-k
// (rs, ri): slot r lives in lane r % 32, register r / 32, best first.
__device__ void merge(float (&rs)[RUN], int (&ri)[RUN], float ns, int ni,
                      int k, int lane) {
  // nothing to do unless some new score beats the current k-th
  float kth_s = rs[0];
  int kth_i = ri[0];
#pragma unroll
  for (int q = 1; q < RUN; ++q) {
    if ((k - 1) / 32 == q) {
      kth_s = rs[q];
      kth_i = ri[q];
    }
  }
  kth_s = __shfl_sync(FULL_MASK, kth_s, (k - 1) & 31);
  kth_i = __shfl_sync(FULL_MASK, kth_i, (k - 1) & 31);
  if (!__any_sync(FULL_MASK, better(ns, ni, kth_s, kth_i))) return;

  float os[RUN];
  int oi[RUN];
#pragma unroll
  for (int q = 0; q < RUN; ++q) {
    os[q] = -INFINITY;
    oi[q] = INT_MAX;
  }
  // this lane's best untaken candidate
  float bs = ns;
  int bi = ni;
#pragma unroll
  for (int q = 0; q < RUN; ++q) {
    if (better(rs[q], ri[q], bs, bi)) {
      bs = rs[q];
      bi = ri[q];
    }
  }
  for (int r = 0; r < k; ++r) {
    float ws = bs;
    int wi = bi;
    warp_best(ws, wi);
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      if (r == q * 32 + lane) {
        os[q] = ws;
        oi[q] = wi;
      }
    }
    if (ws == bs && wi == bi) {   // this lane held the winner: take it
      if (ni == wi) {
        ns = -INFINITY;
        ni = INT_MAX;
      }
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        if (ri[q] == wi) {
          rs[q] = -INFINITY;
          ri[q] = INT_MAX;
        }
      }
      bs = ns;
      bi = ni;
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        if (better(rs[q], ri[q], bs, bi)) {
          bs = rs[q];
          bi = ri[q];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RUN; ++q) {
    rs[q] = os[q];
    ri[q] = oi[q];
  }
}

// qn . (row / (|row| + eps)) or qn . row, by one thread; float4 loads when
// `vec` (d % 4 == 0 and a 16-byte aligned anchor matrix)
__device__ __forceinline__ float score_row(const float* __restrict__ qn,
                                           const float* __restrict__ row,
                                           const TopkParams& p) {
  float s = 0.f;
  if (p.vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qn);
    const int n4 = p.d >> 2;
    float den = 1.f;
    if (p.normalize_anchors) {
      float ss = 0.f;
#pragma unroll 8
      for (int c = 0; c < n4; ++c) {
        const float4 x = __ldg(r4 + c);
        ss = fmaf(x.x, x.x, ss);
        ss = fmaf(x.y, x.y, ss);
        ss = fmaf(x.z, x.z, ss);
        ss = fmaf(x.w, x.w, ss);
      }
      den = sqrtf(ss) + EPS;
    }
#pragma unroll 8
    for (int c = 0; c < n4; ++c) {
      float4 x = __ldg(r4 + c);
      const float4 y = q4[c];
      if (p.normalize_anchors) {
        x.x = x.x / den;
        x.y = x.y / den;
        x.z = x.z / den;
        x.w = x.w / den;
      }
      s = fmaf(y.x, x.x, s);
      s = fmaf(y.y, x.y, s);
      s = fmaf(y.z, x.z, s);
      s = fmaf(y.w, x.w, s);
    }
    return s;
  }
  float den = 1.f;
  if (p.normalize_anchors) {
    float ss = 0.f;
    for (int c = 0; c < p.d; ++c) ss = fmaf(row[c], row[c], ss);
    den = sqrtf(ss) + EPS;
  }
  for (int c = 0; c < p.d; ++c)
    s = fmaf(qn[c], p.normalize_anchors ? row[c] / den : row[c], s);
  return s;
}

// the same, by the whole warp (lanes across d), in every lane
__device__ __forceinline__ float score_row_warp(const float* __restrict__ qn,
                                                const float* __restrict__ row,
                                                const TopkParams& p, int lane) {
  float den = 1.f;
  if (p.normalize_anchors) {
    float ss = 0.f;
    for (int c = lane; c < p.d; c += 32) ss = fmaf(row[c], row[c], ss);
    den = sqrtf(warp_sum(ss)) + EPS;
  }
  float s = 0.f;
  for (int c = lane; c < p.d; c += 32)
    s = fmaf(qn[c], p.normalize_anchors ? row[c] / den : row[c], s);
  return warp_sum(s);
}

__global__ void __launch_bounds__(THREADS) topk_kernel(const TopkParams p) {
  extern __shared__ __align__(16) float qn[];  // d floats: the unit query
  __shared__ float red[WARPS];
  __shared__ float cand_s[WARPS * KMAX];
  __shared__ int cand_i[WARPS * KMAX];

  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the query, over |q| + eps
  const float* q = p.q + static_cast<long long>(row) * p.d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < p.d; c += THREADS) {
    const float x = q[c];
    qn[c] = x;
    ss = fmaf(x, x, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) tot += red[w];
  const float den = sqrtf(tot) + EPS;
  for (int c = threadIdx.x; c < p.d; c += THREADS) qn[c] = qn[c] / den;
  __syncthreads();

  // score chunk by chunk, merging into each warp's running top-k
  float rs[RUN];
  int ri[RUN];
#pragma unroll
  for (int qq = 0; qq < RUN; ++qq) {
    rs[qq] = -INFINITY;
    ri[qq] = INT_MAX;
  }
  for (int base = 0; base < p.na; base += THREADS) {
    const int first = base + warp * 32;
    float s = -INFINITY;
    int i = INT_MAX;
    if (p.d <= THREAD_ROW_D) {
      const int a = first + lane;
      if (a < p.na) {
        s = score_row(qn, p.a + static_cast<long long>(a) * p.d, p);
        i = a;
      }
    } else {
      for (int j = 0; j < 32 && first + j < p.na; ++j) {
        const float t = score_row_warp(
            qn, p.a + static_cast<long long>(first + j) * p.d, p, lane);
        if (lane == j) {
          s = t;
          i = first + j;
        }
      }
    }
    merge(rs, ri, s, i, p.k, lane);
  }

  // every warp's k best; warp 0 merges the WARPS lists and writes the result
#pragma unroll
  for (int qq = 0; qq < RUN; ++qq) {
    const int r = qq * 32 + lane;
    if (r < p.k) {
      cand_s[warp * p.k + r] = rs[qq];
      cand_i[warp * p.k + r] = ri[qq];
    }
  }
  __syncthreads();
  if (warp != 0) return;
  const int ncand = WARPS * p.k;   // lane owns entries lane, lane + 32, ...
  auto local_best = [&](float& bs, int& bi, int& bp) {
    bs = -INFINITY;
    bi = INT_MAX;
    bp = -1;
    for (int e = lane; e < ncand; e += 32) {
      if (better(cand_s[e], cand_i[e], bs, bi)) {
        bs = cand_s[e];
        bi = cand_i[e];
        bp = e;
      }
    }
  };
  float bs;
  int bi, bp;
  local_best(bs, bi, bp);
  float* out_s = p.scores + static_cast<long long>(row) * p.k;
  int* out_i = p.idx + static_cast<long long>(row) * p.k;
  for (int r = 0; r < p.k; ++r) {
    float ws = bs;
    int wi = bi;
    warp_best(ws, wi);
    if (lane == (r & 31)) {
      out_s[r] = ws;
      out_i[r] = wi;
    }
    if (bp >= 0 && ws == bs && wi == bi) {   // taken: never chosen again
      cand_s[bp] = -INFINITY;
      cand_i[bp] = INT_MAX;
      local_best(bs, bi, bp);
    }
  }
}

}  // namespace

extern "C" int repro_topk_retrieval(const void* q, const void* a,
                                    void* scores, void* idx, int nq, int na,
                                    int d, int k, int normalize_anchors,
                                    void* stream) {
  if (nq <= 0 || k <= 0 || k > KMAX || k > na || d <= 0 || d > 4096)
    return cudaErrorInvalidValue;
  const TopkParams p{static_cast<const float*>(q), static_cast<const float*>(a),
                     static_cast<float*>(scores), static_cast<int*>(idx), na,
                     d, k, normalize_anchors,
                     d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0};
  topk_kernel<<<nq, THREADS, d * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
