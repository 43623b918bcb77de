// Backward of the prefill flash attention (csrc/flash_attention.cu) for
// Hopper (sm_90a): dQ, dK and dV from q, k, v, out, dout and the
// forward's per-row log-sum-exp.
//
// Ports no TPU kernel: the reference never differentiates its Pallas
// kernel (`flash_attention_bhsd`, src/repro/kernels/flash_attention.py);
// it trains through plain jnp attention by autodiff
// (src/repro/models/layers.py `naive_attention` / `flash_attention_jnp`).
// This kernel computes that gradient by the closed formulas, FA2-style,
// recomputing P from the saved LSE instead of storing it:
//
//   P    = exp(q.k * scale - lse)        (0 where masked: causal, past Sk)
//   dV   = P^T dout
//   dP   = dout V^T
//   Δ    = rowsum(dout * out)
//   dS   = P * (dP - Δ)
//   dQ   = dS K * scale,   dK = dS^T Q * scale
//
// with GQA K/V un-repeated (query head h reads KV head h / (H / KH)), so
// dK and dV sum over the G query heads of their group. Three launches:
//  * delta_kernel: Δ [B, H, Sq] f32, one warp per (b, query, head) row;
//  * dkdv_kernel: one CTA per (64-key block, KV head, lane); K and V
//    tiles stay in shared memory while it loops over its G query heads
//    and over the query blocks that see its keys (from the diagonal
//    when causal), dK and dV accumulating in registers: GQA sums
//    in-register;
//  * dq_kernel: one CTA per (64-query block, head, lane), looping over
//    the key blocks its queries see.
// No float atomics anywhere: every output element is written once, by
// one thread, after sums in a fixed order, so a backward (and a train
// step on one card) is bitwise reproducible.
//
// Products run on the CUDA cores by FMA in f32 (tiles widened to f32 in
// shared memory, each thread a 4 x 4 block of the 64 x 64 score tile,
// as the forward's f32 body); bf16 inputs give bf16 gradients from f32
// sums. Tensor cores are later work.
//
// What bounds it on the H100: operations. The least work is 2.5x the
// forward's (the forward's two products and the backward's five, with
// S recomputed once, counted as 10 FLOP per visible pair and head
// dimension against the forward's 4); at the training shape (B=8,
// S=512, H=16 over KH=8, D=128, bf16, causal) that is 21.5 GFLOP,
// 0.022 ms at 989 TFLOP/s. On CUDA cores, FMA in f32 (67 TFLOP/s) and
// one CTA of 8 warps per SM, it runs far above that bound (PERF.md).
//
// Takes: causal or not (queries aligned at key 0, as the forward),
// Sq != Sk, f32 or bf16, head dims 16, 32, 64, 128 and 160.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 64;       // query rows and keys per tile
constexpr int kPad = 4;        // floats of padding per shared row
constexpr int kPS = kBlk + kPad;   // shared row stride of P / dS

typedef __nv_bfloat16 bf16;

template <typename E> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ static void load(const float* p, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <> struct Elem<bf16> {
  static constexpr int kVec = 8;
  __device__ static void load(const bf16* p, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  }
  __device__ static float to_f(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from_f(float x) { return __float2bfloat16(x); }
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

// Rows [row0, row0 + kBlk) of one head of a [*, S, heads, D] tensor,
// widened to f32 into shared rows of D + kPad floats; rows past `rows`
// are zeros.
template <typename E, int D>
__device__ inline void load_tile(const E* __restrict__ src, long long ss,
                                 int row0, int rows, float* dst) {
  constexpr int kVec = Elem<E>::kVec;
  constexpr int kPerRow = D / kVec;
  constexpr int DS = D + kPad;
  for (int idx = threadIdx.x; idx < kBlk * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = idx - r * kPerRow;
    float buf[kVec];
    if (row0 + r < rows) {
      Elem<E>::load(src + (long long)(row0 + r) * ss + c * kVec, buf);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) buf[j] = 0.f;
    }
    float* d = dst + r * DS + c * kVec;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(buf[j], buf[j + 1], buf[j + 2], buf[j + 3]);
  }
}

// dots[i][j] = a row (ty*4 + i) . b row (tx + 16 j), over D.
template <int D>
__device__ inline void tile_dots(const float* a_s, const float* b_s, int ty,
                                 int tx, float (&dots)[4][4]) {
  constexpr int DS = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dots[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds<4>(a_s + (ty * 4 + i) * DS + d, av[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) lds<4>(b_s + (tx + 16 * j) * DS + d, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dots[i][j] = fmaf(av[i][e], bv[j][e], dots[i][j]);
  }
}

// The vector width of a thread's D / 16 output columns: 4, or what
// divides D / 16 (2 at D = 160, 1 at D = 16).
template <int D> __host__ __device__ constexpr int col_vec() {
  return (D / 16) % 4 == 0 ? 4 : (D / 16) % 2 == 0 ? 2 : 1;
}

// acc[i][c] += sum over the tile's 64 rows r of p row (ty*4 + i)[r] *
// x row r [column c of this thread]; p rows past the data are zeros.
template <int D>
__device__ inline void tile_acc(const float* p_s, const float* x_s, int ty,
                                int tx, float (&acc)[4][D / 16]) {
  constexpr int DS = D + kPad;
  constexpr int DC = D / 16;
  constexpr int VW = col_vec<D>();
  for (int c0 = 0; c0 < kBlk; c0 += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds<4>(p_s + (ty * 4 + i) * kPS + c0, pv[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* xr = x_s + (c0 + e) * DS;
      float xv[DC];
#pragma unroll
      for (int g = 0; g < DC / VW; ++g)
        lds<VW>(xr + g * 16 * VW + tx * VW, xv + g * VW);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i][e], xv[c], acc[i][c]);
    }
  }
}

// Row (ty*4 + i) of a thread's accumulator, times `mul`, into row `row`
// of a contiguous [*, D] output.
template <typename E, int D>
__device__ inline void store_rows(E* __restrict__ dst, const float (&acc)[D / 16],
                                  float mul, int tx) {
  constexpr int VW = col_vec<D>();
#pragma unroll
  for (int g = 0; g < D / 16 / VW; ++g)
#pragma unroll
    for (int e = 0; e < VW; ++e)
      dst[g * 16 * VW + tx * VW + e] = Elem<E>::from_f(acc[g * VW + e] * mul);
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // four [kBlk][D + pad] tiles | P / dS [kBlk][kBlk + pad] | 2 x kBlk rows
  return sizeof(float) * ((size_t)4 * kBlk * (D + kPad) +
                          (size_t)kBlk * kPS + 2 * kBlk);
}

// Δ[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]: one warp a row.
template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const E* __restrict__ out, const E* __restrict__ dout,
             float* __restrict__ delta, int B, int Sq, int H) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * Sq * H) return;
  const E* o = out + row * D;
  const E* g = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(Elem<E>::to_f(o[d]), Elem<E>::to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bi = row / H;      // b * Sq + i
    const int i = (int)(bi % Sq);
    const int b = (int)(bi / Sq);
    delta[((long long)b * H + h) * Sq + i] = acc;
  }
}

// dK, dV of one 64-key block of one KV head of one lane.
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            E* __restrict__ dk, E* __restrict__ dv, Shape s) {
  constexpr int DS = D + kPad;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBlk * DS;
  float* q_s = v_s + kBlk * DS;
  float* do_s = q_s + kBlk * DS;
  float* p_s = do_s + kBlk * DS;
  float* lse_s = p_s + kBlk * kPS;
  float* dl_s = lse_s + kBlk;

  const int k0 = blockIdx.x * kBlk;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = s.H / s.KH;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;     // key rows ty*4 .. ty*4+3
  const int tx = tid & 15;     // query columns tx + 16 j

  load_tile<E, D>(k + b * s.k_sb + kh * s.k_sh, s.k_ss, k0, s.Sk, k_s);
  load_tile<E, D>(v + b * s.v_sb + kh * s.v_sh, s.v_ss, k0, s.Sk, v_s);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (s.Sq + kBlk - 1) / kBlk;
  // causal: only the queries at or after this block's first key see it
  const int iq0 = s.causal ? k0 / kBlk : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const E* qb = q + b * s.q_sb + h * s.q_sh;
    const E* gb = dout + ((long long)b * s.Sq * s.H + h) * D;
    const float* lse_b = lse + ((long long)b * s.H + h) * s.Sq;
    const float* dl_b = delta + ((long long)b * s.H + h) * s.Sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kBlk;
      __syncthreads();   // the previous query tile is no longer read
      load_tile<E, D>(qb, s.q_ss, q0, s.Sq, q_s);
      load_tile<E, D>(gb, (long long)s.H * D, q0, s.Sq, do_s);
      if (tid < kBlk) {
        const bool in = q0 + tid < s.Sq;
        lse_s[tid] = in ? lse_b[q0 + tid] : 0.f;
        dl_s[tid] = in ? dl_b[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T (keys x queries), P^T; dP^T = V dout^T; dS^T
      float pT[4][4], dsT[4][4];
      tile_dots<D>(k_s, q_s, ty, tx, pT);
      tile_dots<D>(v_s, do_s, ty, tx, dsT);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q0 + tx + 16 * j;
          const bool ok = qi < s.Sq && kj < s.Sk && (!s.causal || kj <= qi);
          const float p = ok ? expf(pT[i][j] * s.scale - lse_s[tx + 16 * j])
                             : 0.f;
          pT[i][j] = p;
          dsT[i][j] = p * (dsT[i][j] - dl_s[tx + 16 * j]);
        }
      }
      // dV += P^T dout; then dK += dS^T q (scaled at the store). The rows
      // of p_s a half-warp writes are the rows it alone reads.
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * kPS + tx + 16 * j] = pT[i][j];
      __syncwarp();
      tile_acc<D>(p_s, do_s, ty, tx, dv_acc);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * kPS + tx + 16 * j] = dsT[i][j];
      __syncwarp();
      tile_acc<D>(p_s, q_s, ty, tx, dk_acc);
      __syncwarp();
    }
  }

  // dk, dv [B, Sk, KH, D], contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= s.Sk) continue;
    const long long off = (((long long)b * s.Sk + kj) * s.KH + kh) * D;
    store_rows<E, D>(dk + off, dk_acc[i], s.scale, tx);
    store_rows<E, D>(dv + off, dv_acc[i], 1.f, tx);
  }
}

// dQ of one 64-query block of one head of one lane.
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
          const E* __restrict__ v, const E* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          E* __restrict__ dq, Shape s) {
  constexpr int DS = D + kPad;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBlk * DS;
  float* k_s = do_s + kBlk * DS;
  float* v_s = k_s + kBlk * DS;
  float* p_s = v_s + kBlk * DS;

  const int nq = (s.Sq + kBlk - 1) / kBlk;
  // the query blocks with the most keys first (causal)
  const int iq = s.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (s.H / s.KH);
  const int q0 = iq * kBlk;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;     // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;     // key columns tx + 16 j

  load_tile<E, D>(q + b * s.q_sb + h * s.q_sh, s.q_ss, q0, s.Sq, q_s);
  load_tile<E, D>(dout + ((long long)b * s.Sq * s.H + h) * D,
                  (long long)s.H * D, q0, s.Sq, do_s);
  float row_lse[4], row_dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const long long at = ((long long)b * s.H + h) * s.Sq + qi;
    row_lse[i] = qi < s.Sq ? lse[at] : 0.f;
    row_dl[i] = qi < s.Sq ? delta[at] : 0.f;
  }
  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;

  const E* kb = k + b * s.k_sb + kh * s.k_sh;
  const E* vb = v + b * s.v_sb + kh * s.v_sh;
  int k_end = s.Sk;
  if (s.causal) k_end = min(k_end, q0 + kBlk);   // blocks above skipped
  for (int k0 = 0; k0 < k_end; k0 += kBlk) {
    __syncthreads();   // the previous key tile is no longer read
    load_tile<E, D>(kb, s.k_ss, k0, s.Sk, k_s);
    load_tile<E, D>(vb, s.v_ss, k0, s.Sk, v_s);
    __syncthreads();

    float ds[4][4], dp[4][4];
    tile_dots<D>(q_s, k_s, ty, tx, ds);
    tile_dots<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < s.Sq && kj < s.Sk && (!s.causal || kj <= qi);
        const float p = ok ? expf(ds[i][j] * s.scale - row_lse[i]) : 0.f;
        ds[i][j] = p * (dp[i][j] - row_dl[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * kPS + tx + 16 * j] = ds[i][j];
    __syncwarp();
    tile_acc<D>(p_s, k_s, ty, tx, dq_acc);
    __syncwarp();
  }

  // dq [B, Sq, H, D], contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s.Sq) continue;
    store_rows<E, D>(dq + (((long long)b * s.Sq + qi) * s.H + h) * D,
                     dq_acc[i], s.scale, tx);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename E, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta,
                   const Shape& s, cudaStream_t stream) {
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* ge = static_cast<const E*>(dout);
  const long long rows = (long long)s.B * s.Sq * s.H;
  delta_kernel<E, D><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                       kThreads, 0, stream>>>(
      static_cast<const E*>(out), ge, delta, s.B, s.Sq, s.H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr size_t smem = smem_bytes<D>();
  if ((e = allow_smem(dkdv_kernel<E, D>, smem)) != cudaSuccess) return e;
  if ((e = allow_smem(dq_kernel<E, D>, smem)) != cudaSuccess) return e;
  dim3 grid_kv((s.Sk + kBlk - 1) / kBlk, s.KH, s.B);
  dkdv_kernel<E, D><<<grid_kv, kThreads, smem, stream>>>(
      qe, ke, ve, ge, lse, delta, static_cast<E*>(dk), static_cast<E*>(dv),
      s);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dim3 grid_q((s.Sq + kBlk - 1) / kBlk, s.H, s.B);
  dq_kernel<E, D><<<grid_q, kThreads, smem, stream>>>(
      qe, ke, ve, ge, lse, delta, static_cast<E*>(dq), s);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, const void* out, const void* dout,
                         const float* lse, void* dq, void* dk, void* dv,
                         float* delta, const Shape& s, cudaStream_t st) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, dout, lse, dq, dk, dv, delta, s, st);
  if (dtype == 1)
    return launch<bf16, D>(q, k, v, out, dout, lse, dq, dk, dv, delta, s, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, out, dout, dq, dk and dv share it). q is
// [B, Sq, H, D] and k, v [B, Sk, KH, D], each with the given element
// strides of its first three dims and a contiguous last dim; out, dout
// and dq are contiguous [B, Sq, H, D], dk and dv contiguous
// [B, Sk, KH, D]; lse (the forward's) and delta (scratch) are f32
// [B, H, Sq]. KH divides H; D is 16, 32, 64, 128 or 160. Launches
// three kernels on `stream`. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Sk, int H, int KH, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  Shape s{B, Sq, Sk, H, KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
          v_sb, v_ss, v_sh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (D) {
    case 16: return (int)launch_dtype<16>(dtype, q, k, v, out, dout, l, dq, dk, dv, d, s, st);
    case 32: return (int)launch_dtype<32>(dtype, q, k, v, out, dout, l, dq, dk, dv, d, s, st);
    case 64: return (int)launch_dtype<64>(dtype, q, k, v, out, dout, l, dq, dk, dv, d, s, st);
    case 128: return (int)launch_dtype<128>(dtype, q, k, v, out, dout, l, dq, dk, dv, d, s, st);
    case 160: return (int)launch_dtype<160>(dtype, q, k, v, out, dout, l, dq, dk, dv, d, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
