// Causal (or full) streaming-softmax attention for prefill, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (Pallas body `_kernel`), and
// computes what that kernel computes: f32 scores q.k * D^-0.5 (plain
// FMA, no TF32), query i sees keys 0..i when causal (aligned at 0), a
// running (m, l, acc) in f32 with the finite NEG_INF (-1e30) and its
// guards (p = 0 where s <= NEG_INF/2, m_safe, corr = 0 while m is still
// NEG_INF), and out = acc / max(l, 1e-20) cast to q's dtype.
// It differs from the Pallas kernel in what does not change the
// function: it reads q [B, Sq, H, D] and k/v [B, Sk, KH, D] through
// their strides (no transpose), takes GQA K/V un-repeated (query head
// h reads KV head h / (H / KH)), takes any Sq and Sk (rows and keys
// past the end are masked, not asserted away), and skips the key
// blocks above the diagonal instead of masking them.
//
// What bounds it on the H100: operations. At the prefill shape of the
// main path (B=4, S=2304, H=16, KH=8, D=128, bf16, causal) it does
// 4*B*H*D*S(S+1)/2 = 87 GFLOP on 113 MB: 0.088 ms at the 989 TFLOP/s
// of the bf16 tensor cores against 0.034 ms for the bytes.
//
// What this first version does about it: it is right and simple, not
// fast. The products run on the CUDA cores in f32 (an upper bound of
// 67 TFLOP/s, so at least ~15x the tensor-core bound):
//  * one CTA of 256 threads per (q block of 64 rows, head, lane); the
//    q tile and each 64-key K and V tile are widened to f32 in shared
//    memory (16-byte vector loads, rows padded by 4 floats so the
//    float4 reads of the inner loops are free of bank conflicts);
//  * each thread owns a 4 x 4 block of the 64 x 64 score tile and a
//    4 x D/16 block of the output, so every shared-memory read feeds
//    4 FMAs; the 16 threads that share a row reduce its max and sum
//    with warp shuffles;
//  * causal blocks above the diagonal are skipped (half the work), and
//    the q blocks with the most keys are launched first.
// Not done yet: mma.sync / wgmma products in bf16, cp.async or TMA
// double buffering of the next K/V tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kQB = 64;       // query rows per CTA
constexpr int kKB = 64;       // keys per tile
constexpr int kPad = 4;       // floats of padding per shared row
constexpr int kRows = 4;      // score / output rows per thread
constexpr int kCols = 4;      // score columns per thread (kKB / 16)

template <typename E> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ static void load(const float* p, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static float from_f(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
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
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
};

// `n` (1, 2 or 4) consecutive floats of shared memory.
template <int N> __device__ inline void lds(const float* p, float* dst);
template <> __device__ inline void lds<1>(const float* p, float* dst) {
  dst[0] = p[0];
}
template <> __device__ inline void lds<2>(const float* p, float* dst) {
  float2 v = *reinterpret_cast<const float2*>(p);
  dst[0] = v.x; dst[1] = v.y;
}
template <> __device__ inline void lds<4>(const float* p, float* dst) {
  float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

struct Shape {
  int B, Sq, Sk, H, KH;
  long long q_sb, q_ss, q_sh;  // element strides of q (last dim 1)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  float scale;
};

// Rows [row0, row0 + n) of a [*, S, heads, D] tensor's head, widened to
// f32 into shared rows of `stride` floats; rows past `rows` are zeros.
template <typename E, int D>
__device__ inline void load_tile(const E* __restrict__ src, long long ss,
                                 int row0, int rows, int n, float* dst,
                                 int stride) {
  constexpr int kVec = Elem<E>::kVec;
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < n * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = idx - r * kPerRow;
    float buf[kVec];
    if (row0 + r < rows) {
      Elem<E>::load(src + (long long)(row0 + r) * ss + c * kVec, buf);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) buf[j] = 0.f;
    }
    float* d = dst + r * stride + c * kVec;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(buf[j], buf[j + 1], buf[j + 2], buf[j + 3]);
  }
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // q [kQB][D+pad] | k [kKB][D+pad] | v [kKB][D+pad] | p [kQB][kKB+pad]
  return sizeof(float) * ((size_t)(kQB + 2 * kKB) * (D + kPad) +
                          (size_t)kQB * (kKB + kPad));
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const E* __restrict__ q, const E* __restrict__ k,
             const E* __restrict__ v, E* __restrict__ out, Shape s) {
  constexpr int DS = D + kPad;          // shared row stride of q, k, v
  constexpr int PS = kKB + kPad;        // shared row stride of p
  constexpr int DC = D / 16;            // output columns per thread
  constexpr int VW = DC < 4 ? DC : 4;   // their vector width

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kQB * DS;
  float* v_s = k_s + kKB * DS;
  float* p_s = v_s + kKB * DS;

  const int nq = (s.Sq + kQB - 1) / kQB;
  // the q blocks with the most keys first: under causal masking they
  // are the longest, and launching them last would leave a ragged tail
  const int iq = s.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (s.H / s.KH);
  const int q0 = iq * kQB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;              // rows ty*4 .. ty*4+3
  const int tx = tid & 15;              // score columns tx + 16*j

  const E* qb = q + b * s.q_sb + h * s.q_sh;
  const E* kb = k + b * s.k_sb + kh * s.k_sh;
  const E* vb = v + b * s.v_sb + kh * s.v_sh;
  load_tile<E, D>(qb, s.q_ss, q0, s.Sq, kQB, q_s, DS);

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int k_end = s.Sk;
  if (s.causal) k_end = min(k_end, q0 + kQB);   // blocks above skipped
  for (int k0 = 0; k0 < k_end; k0 += kKB) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<E, D>(kb, s.k_ss, k0, s.Sk, kKB, k_s, DS);
    load_tile<E, D>(vb, s.v_ss, k0, s.Sk, kKB, v_s, DS);
    __syncthreads();

    // scores of rows ty*4+i against keys k0 + tx + 16*j
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[kRows][4], kv[kCols][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) lds<4>(q_s + (ty * 4 + i) * DS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) lds<4>(k_s + (tx + 16 * j) * DS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qv[i][e], kv[j][e], sc[i][j]);
    }

    // mask, then the running softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < s.Sk && (!s.causal || kj <= qi);
        sc[i][j] = ok ? sc[i][j] * s.scale : kNegInf;
        mb = fmaxf(mb, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = sc[i][j] <= kNegInf / 2 ? 0.f : expf(sc[i][j] - m_safe);
        rs += p;
        p_s[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // p rows are written and read by the same half-warp

    // acc += p v over the tile's keys
    const int n_keys = min(kKB, s.Sk - k0);
    for (int c0 = 0; c0 < n_keys; c0 += 4) {
      float pv[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) lds<4>(p_s + (ty * 4 + i) * PS + c0, pv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = v_s + (c0 + e) * DS;
        float vv[DC];
#pragma unroll
        for (int g = 0; g < DC / VW; ++g)
          lds<VW>(vr + g * 16 * VW + tx * VW, vv + g * VW);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i][e], vv[c], acc[i][c]);
      }
    }
  }

  // out [B, Sq, H, D], contiguous
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    E* orow = out + (((long long)b * s.Sq + qi) * s.H + h) * D;
#pragma unroll
    for (int g = 0; g < DC / VW; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[g * 16 * VW + tx * VW + e] =
            Elem<E>::from_f(acc[i][g * VW + e] * inv);
  }
}

template <typename E, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Shape& s, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((s.Sq + kQB - 1) / kQB, s.H, s.B);
  flash_kernel<E, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), s);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, const Shape& s, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<E, 16>(q, k, v, out, s, stream);
    case 32: return launch<E, 32>(q, k, v, out, s, stream);
    case 64: return launch<E, 64>(q, k, v, out, s, stream);
    case 128: return launch<E, 128>(q, k, v, out, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out share it). q is [B, Sq, H, D], k and v
// [B, Sk, KH, D], each with the given element strides of its first
// three dims and a contiguous last dim; out is a contiguous
// [B, Sq, H, D]. KH divides H; D is 16, 32, 64 or 128. Returns a
// cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KH, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  Shape s{B, Sq, Sk, H, KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
          v_sb, v_ss, v_sh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(D, q, k, v, out, s, st);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(D, q, k, v, out, s, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
