// Paged GQA decode attention over ONE memory tier, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (Pallas body `_kernel`), and
// computes exactly what that kernel computes: for each (lane b, KV head
// kh) the G query rows attend over the pages listed in page_list[b],
// with f32 scores and accumulation, scale HD^-0.5, the finite NEG_INF
// (-1e30) and the `<= NEG_INF/2` guards, a page valid only where
// page_list >= 0 and the token offset is below page_valid. Outputs:
// out [B,KH,G,HD] (normalized by l, q's dtype), m and l [B,KH,G] f32,
// and the per-page log-sum-exp [B,KH,G,N] f32, computed from each page
// alone (NEG_INF for a page with no valid token) — the importance
// statistic of the placement policy.
//
// What bounds it on the H100: bytes. Per (b, kh) the kernel reads
// G*HD query values and every valid page's 16 x HD K and V tiles, and
// does 4*G*HD flops per token read — about 2 flops per byte at G = 2,
// far below the ~295 flops per byte where bf16 tensor cores would be
// the limit. The least time is the valid K/V bytes over 3.35 TB/s.
//
// What the design does about it:
//  * Holes are skipped, not loaded: a page with page_list < 0 or
//    page_valid == 0 costs one int load and writes its LSE as NEG_INF,
//    and a partial page loads only its valid rows. The kernel moves no
//    byte the result does not need.
//  * B*KH is 64 at full width — half the 132 SMs. The page range of
//    each (b, kh) is cut into `splits` ranges (flash-decoding), one CTA
//    each, so the grid holds several CTAs per SM and their page loads
//    overlap; a second small kernel merges the per-split (m, l, acc).
//  * K/V tiles move with 16-byte vector loads (neighbouring threads on
//    neighbouring addresses) and are widened to f32 in shared memory;
//    K rows are padded by one float so the score loop is free of bank
//    conflicts.
//  * The pools are taken as a raw pointer plus element strides, so a
//    pool that lives in pinned host memory behind a mapped pointer
//    needs no change here.
// Not done yet: cp.async/TMA double buffering of the next page, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

template <typename E> struct Pack;

template <> struct Pack<float> {
  static constexpr int kN = 4;  // elements per 16-byte vector
  __device__ static void load(const float* p, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

struct Shape {
  int B, KH, G, HD, P, T, N;
  long long k_sb, k_sp, k_st, k_skh;  // element strides of k_pool
  long long v_sb, v_sp, v_st, v_skh;  // element strides of v_pool
  int pages_per_split;
  float scale;
};

// Shared-memory plan (floats): q [G*HD] | k [T*(HD+1)] | v [T*HD] |
// p [G*T] | acc [G*HD] | m, l, corr_old, corr_page [G each].
__host__ __device__ inline size_t smem_floats(int G, int T, int HD) {
  return (size_t)G * HD + (size_t)T * (HD + 1) + (size_t)T * HD +
         (size_t)G * T + (size_t)G * HD + 4 * (size_t)G;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const E* __restrict__ q, const E* __restrict__ k_pool,
                   const E* __restrict__ v_pool,
                   const int* __restrict__ page_list,
                   const int* __restrict__ page_valid,
                   float* __restrict__ lse, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   Shape s) {
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = s.G, HD = s.HD, T = s.T, N = s.N;
  const int KS = HD + 1;  // padded K row

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * HD;
  float* v_s = k_s + T * KS;
  float* p_s = v_s + T * HD;
  float* acc_s = p_s + G * T;
  float* m_s = acc_s + G * HD;
  float* l_s = m_s + G;
  float* co_s = l_s + G;  // correction of the running state
  float* cp_s = co_s + G; // correction of the page's contribution

  const long long bk = (long long)b * s.KH + kh;
  for (int i = tid; i < G * HD; i += kThreads) {
    q_s[i] = Pack<E>::to_f(q[bk * G * HD + i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int p0 = split * s.pages_per_split;
  const int p1 = min(N, p0 + s.pages_per_split);
  const int vec = HD / Pack<E>::kN;  // 16-byte vectors per row
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = kThreads / 32;

  for (int i = p0; i < p1; ++i) {
    int slot = page_list[(long long)b * N + i];
    int nv = page_valid[(long long)b * N + i];
    if (slot < 0 || nv <= 0) {  // hole: skipped, not loaded
      if (tid < G) lse[(bk * G + tid) * N + i] = kNegInf;
      continue;
    }
    slot = min(slot, s.P - 1);
    nv = min(nv, T);
    __syncthreads();  // the previous page is no longer read

    const E* kp = k_pool + b * s.k_sb + slot * s.k_sp + kh * s.k_skh;
    const E* vp = v_pool + b * s.v_sb + slot * s.v_sp + kh * s.v_skh;
    for (int idx = tid; idx < nv * vec; idx += kThreads) {
      const int t = idx / vec, c = idx - t * vec;
      float buf[Pack<E>::kN];
      Pack<E>::load(kp + t * s.k_st + c * Pack<E>::kN, buf);
#pragma unroll
      for (int j = 0; j < Pack<E>::kN; ++j) k_s[t * KS + c * Pack<E>::kN + j] = buf[j];
      Pack<E>::load(vp + t * s.v_st + c * Pack<E>::kN, buf);
#pragma unroll
      for (int j = 0; j < Pack<E>::kN; ++j) v_s[t * HD + c * Pack<E>::kN + j] = buf[j];
    }
    __syncthreads();

    // scores: `tpp` neighbouring threads share one (g, t) dot product
    const int pairs = G * nv;
    int tpp = 1;
    while (tpp < 32 && pairs * tpp * 2 <= kThreads) tpp *= 2;
    const int span = pairs * tpp;
    for (int base = 0; base < span; base += kThreads) {  // uniform trip count
      const int idx = base + tid;
      const bool on = idx < span;
      const int pr = idx / tpp, sub = idx - pr * tpp;
      float part = 0.f;
      if (on) {
        const int g = pr / nv, t = pr - g * nv;
        const float* qr = q_s + g * HD;
        const float* kr = k_s + t * KS;
        for (int d = sub; d < HD; d += tpp) part += qr[d] * kr[d];
      }
      for (int off = tpp >> 1; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (on && sub == 0) {
        const int g = pr / nv, t = pr - g * nv;
        p_s[g * T + t] = part * s.scale;
      }
    }
    __syncthreads();

    // page-local softmax and the running update: one warp per row
    for (int g = warp; g < G; g += nwarps) {
      const float sc = lane < nv ? p_s[g * T + lane] : kNegInf;
      float mp = sc;
      for (int off = 16; off > 0; off >>= 1)
        mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, off));
      const float e = lane < nv ? expf(sc - mp) : 0.f;
      float lp = e;
      for (int off = 16; off > 0; off >>= 1)
        lp += __shfl_xor_sync(0xffffffffu, lp, off);
      if (lane < nv) p_s[g * T + lane] = e;
      if (lane == 0) {
        lse[(bk * G + g) * N + i] = mp + logf(fmaxf(lp, 1e-37f));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mp);
        const float c_old = m_old <= kNegInf / 2 ? 0.f : expf(m_old - m_new);
        const float c_page = expf(mp - m_new);
        l_s[g] = l_s[g] * c_old + lp * c_page;
        m_s[g] = m_new;
        co_s[g] = c_old;
        cp_s[g] = c_page;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * HD; idx += kThreads) {
      const int g = idx / HD, d = idx - g * HD;
      const float* pr = p_s + g * T;
      float pv = 0.f;
      for (int t = 0; t < nv; ++t) pv += pr[t] * v_s[t * HD + d];
      acc_s[idx] = acc_s[idx] * co_s[g] + pv * cp_s[g];
    }
  }
  __syncthreads();

  const long long row = (long long)split * s.B * s.KH + bk;
  for (int i = tid; i < G * HD; i += kThreads) part_acc[row * G * HD + i] = acc_s[i];
  if (tid < G) {
    part_m[row * G + tid] = m_s[tid];
    part_l[row * G + tid] = l_s[tid];
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, E* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int BKH, int G, int HD, int splits) {
  const long long bk = blockIdx.x;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx - g * HD;
    float m = kNegInf;
    for (int sp = 0; sp < splits; ++sp)
      m = fmaxf(m, part_m[((long long)sp * BKH + bk) * G + g]);
    const float m_safe = m <= kNegInf / 2 ? 0.f : m;
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const long long r = (long long)sp * BKH + bk;
      const float ls = part_l[r * G + g];
      if (ls > 0.f) {
        const float c = expf(part_m[r * G + g] - m_safe);
        l += ls * c;
        acc += part_acc[r * G * HD + idx] * c;
      }
    }
    out[bk * G * HD + idx] = Pack<E>::from_f(acc / fmaxf(l, 1e-20f));
    if (d == 0) {
      m_out[bk * G + g] = m;
      l_out[bk * G + g] = l;
    }
  }
}

template <typename E>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_list, const int* page_valid, void* out,
                   float* m_out, float* l_out, float* lse, float* part_m,
                   float* part_l, float* part_acc, const Shape& s, int splits,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(s.G, s.T, s.HD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(splits, s.KH, s.B);
  paged_split_kernel<E><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k_pool),
      static_cast<const E*>(v_pool), page_list, page_valid, lse, part_m,
      part_l, part_acc, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_merge_kernel<E><<<s.B * s.KH, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<E*>(out), m_out, l_out,
      s.B * s.KH, s.G, s.HD, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16 (q, pools and out share it). q and out are contiguous
// [B, KH, G, HD]; page_list / page_valid contiguous int32 [B, N]; the
// pools are [B, P, T, KH, HD] with the given element strides and a
// contiguous last dim. Partial buffers: part_m / part_l [splits, B, KH,
// G], part_acc [splits, B, KH, G, HD], all f32. Returns a cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_list, const int* page_valid, void* out, float* m_out,
    float* l_out, float* lse, float* part_m, float* part_l, float* part_acc,
    int B, int KH, int G, int HD, int P, int T, int N, long long k_sb,
    long long k_sp, long long k_st, long long k_skh, long long v_sb,
    long long v_sp, long long v_st, long long v_skh, int splits,
    int pages_per_split, float scale, int dtype, void* stream) {
  if (T > 32 || T < 1 || G < 1 || HD < 1 || splits < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  Shape s{B, KH, G, HD, P, T, N, k_sb, k_sp, k_st, k_skh,
          v_sb, v_sp, v_st, v_skh, pages_per_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(q, k_pool, v_pool, page_list, page_valid, out, m_out,
                      l_out, lse, part_m, part_l, part_acc, s, splits, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k_pool, v_pool, page_list, page_valid, out,
                              m_out, l_out, lse, part_m, part_l, part_acc, s,
                              splits, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
