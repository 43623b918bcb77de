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
//  * delta: Δ [B, H, Sq] f32, one warp per (b, query, head) row;
//  * dkdv: one CTA per (key block, KV head, lane); K and V stay in
//    shared memory while it loops over its G query heads and over the
//    query blocks that see its keys (from the diagonal when causal), dK
//    and dV accumulating in registers: GQA sums in-register;
//  * dq: one CTA per (64-query block, head, lane), looping over the key
//    blocks its queries see, S and dP recomputed (7 products in all,
//    not 5: the price of writing every output once).
// No float atomics anywhere: every output element is written once, by
// one thread, after sums in a fixed order, so a backward (and a train
// step on one card) is bitwise reproducible. The CTAs with the most
// work launch first (the key or query block is the grid's slowest
// dimension).
//
// What bounds it on the H100: bytes, barely. At the training shape
// (B=8, S=512, H=16 over KH=8, D=128, bf16, causal) it reads q, k, v,
// out, dout and the LSE and writes dq, dk, dv: 100.9 MB, 0.030 ms at
// 3.35 TB/s; its least work (2.5x the forward's: the forward's two
// products and the backward's five, 10 against 4 FLOP per visible pair
// and head dimension) is 21.5 GFLOP, 0.022 ms at 989 TFLOP/s. The
// seven products it runs are 30 GFLOP.
//
// Two bodies, chosen by dtype:
//  * bf16 (training's path): all five products of each kernel on the
//    tensor cores with Hopper's warpgroup `wgmma.mma_async` (bf16 in,
//    f32 accumulate), every tile by TMA (4-D tensor maps over the
//    strided q, k, v and the contiguous dout, 64-row boxes swizzled as
//    the descriptors name them; rows past S zero-filled), as the
//    forward's `wgmma` body, whose helpers it shares (hopper.cuh).
//    dkdv: K and V of the CTA's keys come once; Q and dout of each
//    (head, query block) stream through a ring of kBwdStages stages
//    tracked by mbarriers, the block's LSE and Δ rows loaded beside them
//    (one iteration ahead). S^T = K Q^T and dP^T = V dout^T are
//    `m64n64k16` from shared memory (two commit groups: P^T =
//    exp2(S^T scale log2e - lse log2e) is formed while dP^T is still in
//    the tensor cores); dS^T = P^T (dP^T - Δ); both accumulators turn in
//    place into the register A operands of dV += P^T dout and dK +=
//    dS^T Q, with dout and Q read MN-major (the transpose bit), as the
//    forward reads V. One warpgroup per 64 keys holds dK and dV (2 x
//    D / 2 f32 registers a thread) beside S^T and dP^T; P and dS never
//    pass through shared memory. Past kSplitAbove padded columns (D =
//    160, a 192-column tile as the forward's: 96 + 96 + 64 registers
//    would not fit), a second warpgroup owns dK: the first computes
//    S^T, dP^T, P^T, dS^T and dV and hands dS^T's bf16 A fragments over
//    through shared memory, thread to thread (both warpgroups' fragment
//    layouts are the same), behind a named barrier.
//    dq: the forward's structure: Q and dout once, K and V through the
//    ring, S = Q K^T and dP = dout V^T from shared memory, dS in
//    registers, dQ += dS K with K read MN-major.
//    Rounding: P and dS enter their products rounded once to bf16
//    (FA2/FA3 do the same), not as the forward's hi + lo: the tolerance
//    here is 1e-2 of each gradient's max |value|, and that model of the
//    arithmetic measures 2.2e-3 to 4.0e-3 of it on the CPU
//    (tests/test_torch_flash_grad.py
//    `test_bf16_products_within_the_backward_tolerance`).
//    Head dims 16, 32, 64 (TMA's 32-, 64- and 128-byte swizzles), 128
//    and 160. Registers, spills and times: PERF.md.
//  * f32: products on the CUDA cores by FMA (no TF32): the card-vs-CPU
//    parity of training needs full-f32 products. Tiles widened to f32
//    in shared memory, each thread a 4 x 4 block of the 64 x 64 score
//    tile, as the forward's f32 body; P / dS through shared memory; one
//    CTA of 8 warps per SM.
//
// Takes: causal or not (queries aligned at key 0, as the forward),
// Sq != Sk, f32 or bf16, head dims 16, 32, 64, 128 and 160.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------
// f32: FMA body (and the Δ pre-pass of both)
// ---------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBlk = 64;       // query rows and keys per tile
constexpr int kPad = 4;        // floats of padding per shared row
constexpr int kPS = kBlk + kPad;   // shared row stride of P / dS

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

template <> struct Elem<bf16> {   // Δ's, on the bf16 path
  __device__ static float to_f(bf16 x) { return __bfloat162float(x); }
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

// ---------------------------------------------------------------------
// bf16: tensor-core body (wgmma over TMA-fed tiles)
// ---------------------------------------------------------------------

constexpr int kWg = 128;          // threads of a warpgroup
constexpr int kRowsT = kBoxRows;  // rows of every tile (queries or keys)
// Chosen by scripts/kernel_variants.py at the training shape (PERF.md):
constexpr int kKeyWgs = 1;        // 64-key sub-blocks of a dkdv CTA
constexpr int kBwdStages = 2;     // ring depth: Q / dout (dkdv), K / V (dq)
constexpr int kSplitAbove = 128;  // padded head dims past this split dK off

// Bytes of one 64-row tile of D (padded) bf16 columns.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kRowsT * padded<D>() * (int)sizeof(bf16);
}

// Rows [s0, s0 + 64) of head hd of lane b into a swizzled tile: one box
// per 64-column block (a box past D arrives zero-filled, and counts in
// full toward the barrier's bytes).
template <int D>
__device__ inline void tma_tile(uint32_t dst, const CUtensorMap* map, int hd,
                                int s0, int b, uint32_t bar) {
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 64)
    tma_load(dst + (c0 / 64) * kRowsT * 128, map, c0, hd, s0, b, bar);
}

template <int D> struct Swz {
  static constexpr int kRowB = D * 2 < 128 ? D * 2 : 128;   // swizzle row
  static constexpr uint32_t kLayout = kRowB == 128 ? 1 : kRowB == 64 ? 2 : 3;
};

// acc (64 x 64, f32) = A . B^T over the D real columns: A and B two
// 64-row tiles, K-major in their swizzle; k-step kk starts 32 bytes
// further into a 128-byte row, or in the next column block.
template <int D>
__device__ inline void ss_product(float* acc, uint32_t a, uint32_t b) {
  constexpr int kRowB = Swz<D>::kRowB;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 32 / kRowB) * kRowsT * kRowB + kk * 32 % kRowB;
    wgmma_ss_n64(acc, gmma_desc(a + off, 16, 8 * kRowB, Swz<D>::kLayout),
                 gmma_desc(b + off, 16, 8 * kRowB, Swz<D>::kLayout), kk > 0);
  }
}

// acc (64 x DP) += A . B: A (64 x 64) as bf16 fragments in registers,
// one [4] per 16-wide k-step; B a 64-row tile read MN-major (the
// transpose bit): k-step j is its rows 16 j .. 16 j + 15.
template <int D>
__device__ inline void rs_product(float* acc, const uint32_t (&a)[4][4],
                                  uint32_t b) {
  constexpr int kRowB = Swz<D>::kRowB;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_tile<padded<D>()>(
        acc, a[j],
        gmma_desc(b + j * 16 * kRowB, kRowsT * kRowB, 8 * kRowB,
                  Swz<D>::kLayout),
        kRowsT * kRowB);
}

__device__ inline uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A 64 x 64 accumulator, rounded once to bf16, as the A fragments of
// its four 16-column k-steps (the accumulator's columns 16 j .. 16 j + 15
// hold k-step j's values at the places the A layout wants them).
__device__ inline void to_frags(const float* d, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(d[8 * j], d[8 * j + 1]);
    a[j][1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
    a[j][2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
    a[j][3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
  }
}

// Rows row0 .. row0 + 63 (those below `rows`) of a warpgroup's 64 x DP
// accumulator, times `mul`, as bf16 into rows of `stride` elements at
// `dst` (the first D columns).
template <int D>
__device__ inline void store_acc(bf16* __restrict__ dst, long long stride,
                                 int row0, int rows, const float* acc,
                                 float mul) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= rows) continue;
    bf16* p = dst + (long long)row * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * mul,
                                acc[4 * n + 2 * r + 1] * mul);
  }
}

// Does the dK of a 64-key block live in a second warpgroup?
template <int D> __host__ __device__ constexpr bool split_dk() {
  return padded<D>() > kSplitAbove;
}

template <int D, int NK>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  // K, V [NK] | Q, dout [kBwdStages] tiles | LSE, Δ rows [2][2][64] f32
  // | dS^T fragments [NK][16][kWg] when split | mbarriers (K/V, ring)
  // | slack to start the tiles on 1024 bytes
  return (size_t)tile_bytes<D>() * (2 * NK + 2 * kBwdStages) + 1024 +
         (split_dk<D>() ? (size_t)NK * 16 * kWg * 4 : 0) +
         8 * (1 + kBwdStages) + 1024;
}

template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  // Q, dout | K, V [kBwdStages] tiles | mbarriers (Q/dout, ring) | slack
  return (size_t)tile_bytes<D>() * (2 + 2 * kBwdStages) +
         8 * (1 + kBwdStages) + 1024;
}

// dK, dV of NK 64-key blocks of one KV head of one lane. A warpgroup
// per key block computes S^T, dP^T, P^T, dS^T and dV (and dK, unless
// split_dk: then warpgroup NK + kw owns key block kw's dK).
template <int D, int NK>
__global__ void __launch_bounds__(kWg * NK * (split_dk<D>() ? 2 : 1))
dkdv_wgmma_kernel(const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Shape s,
                  const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __grid_constant__ CUtensorMap tmg) {
  constexpr bool kSplit = split_dk<D>();
  constexpr int kTile = tile_bytes<D>();
  constexpr int kAcc = padded<D>() / 2;   // accumulator floats a thread

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + NK * kTile;
  const uint32_t q_s = v_s + NK * kTile;
  const uint32_t g_s = q_s + kBwdStages * kTile;
  const uint32_t rows_at = g_s + kBwdStages * kTile;
  float* rows_s = reinterpret_cast<float*>(smem_raw + (rows_at - raw));
  uint32_t* xch = reinterpret_cast<uint32_t*>(rows_s + 256);
  const uint32_t bars = rows_at + 1024 + (kSplit ? NK * 16 * kWg * 4 : 0);
  const uint32_t kv_bar = bars;           // K and V
  const uint32_t ring = bars + 8;         // one per stage

  const int wg = threadIdx.x / kWg;
  const int kw = wg % NK;                 // this warpgroup's key block
  const bool main_wg = !kSplit || wg < NK;
  const int tid = threadIdx.x % kWg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column pair

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kRowsT * NK;
  const int kb = k0 + kw * kRowsT;        // first key of this warpgroup
  const int G = s.H / s.KH;
  const int nq = (s.Sq + kRowsT - 1) / kRowsT;
  // causal: only the query blocks at or after the first key see it
  const int iq0 = s.causal ? min(k0 / kRowsT, nq) : 0;
  const int nv = nq - iq0;
  const int n_it = G * nv;                // (head, query block) pairs

  auto head_of = [&](int i) { return kh * G + i / nv; };
  auto q0_of = [&](int i) { return (iq0 + i % nv) * kRowsT; };
  // the ring: iteration i's Q and dout in stage i % kBwdStages
  auto issue = [&](int i) {
    const int st = i % kBwdStages;
    const uint32_t bar = ring + 8 * st;
    mbar_expect_tx(bar, 2 * kTile);
    tma_tile<D>(q_s + st * kTile, &tmq, head_of(i), q0_of(i), b, bar);
    tma_tile<D>(g_s + st * kTile, &tmg, head_of(i), q0_of(i), b, bar);
  };
  // iteration i's LSE (log2 units) and Δ rows into buffer i % 2, by the
  // first warpgroup (the buffer was last read in iteration i - 2)
  auto fill_rows = [&](int i) {
    const int which = threadIdx.x / kRowsT, r = threadIdx.x % kRowsT;
    const int qi = q0_of(i) + r;
    const long long at = ((long long)b * s.H + head_of(i)) * s.Sq + qi;
    float x = 0.f;
    if (qi < s.Sq) x = which == 0 ? lse[at] * kLog2e : delta[at];
    rows_s[(i % 2) * 2 * kRowsT + threadIdx.x] = x;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) mbar_init(ring + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < kWg && n_it > 0) fill_rows(0);
  __syncthreads();   // the barriers are initialized, rows 0 written
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(kv_bar, 2 * NK * kTile);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      tma_tile<D>(k_s + j * kTile, &tmk, kh, k0 + j * kRowsT, b, kv_bar);
      tma_tile<D>(v_s + j * kTile, &tmv, kh, k0 + j * kRowsT, b, kv_bar);
    }
#pragma unroll
    for (int i = 0; i < kBwdStages - 1; ++i)
      if (i < n_it) issue(i);
  }

  const float sl2 = s.scale * kLog2e;   // exponents in log2 units
  // rows of this thread's S^T / dP^T fragments: keys kj0 and kj0 + 8;
  // columns: queries 8 n + 2 t and 8 n + 2 t + 1 of each 8-column block
  const int kj0 = kb + warp * 16 + g;
  float acc[kAcc];                      // dV (main), dK (split's second)
  float acc2[kSplit ? 1 : kAcc];        // dK (not split)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kSplit ? 1 : kAcc); ++i) acc2[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kBwdStages;
    if (it == 0) mbar_wait(kv_bar, 0);
    mbar_wait(ring + 8 * st, (it / kBwdStages) & 1);
    __syncthreads();   // stage it - 1 and rows buffer (it + 1) % 2 free
    if (threadIdx.x == 0 && it + kBwdStages - 1 < n_it)
      issue(it + kBwdStages - 1);
    const uint32_t qt = q_s + st * kTile, gt = g_s + st * kTile;
    const float* lse_r = rows_s + (it % 2) * 2 * kRowsT;
    const float* dl_r = lse_r + kRowsT;

    if (main_wg) {
      const int q0 = q0_of(it);
      float sc[32], dp[32];
      wg_fence();
      ss_product<D>(sc, k_s + kw * kTile, qt);   // S^T = K Q^T
      wg_commit();
      ss_product<D>(dp, v_s + kw * kTile, gt);   // dP^T = V dout^T
      wg_commit();
      if (threadIdx.x < kWg && it + 1 < n_it) fill_rows(it + 1);
      wg_wait<1>();
      reg_fence<32>(sc);

      // P^T, masked only where the tile crosses the diagonal or an end
      const bool edge = (s.causal && kb + kRowsT - 1 > q0) ||
                        q0 + kRowsT > s.Sq || kb + kRowsT > s.Sk;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_r + 8 * n +
                                                           2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * n + 2 * t + (e & 1);
          const int kj = kj0 + 8 * (e >> 1);
          const bool ok = !edge || (qi < s.Sq && kj < s.Sk &&
                                    (!s.causal || kj <= qi));
          const float x = fmaf(sc[4 * n + e], sl2, -((e & 1) ? l2.y : l2.x));
          sc[4 * n + e] = ok ? ex2(x) : 0.f;
        }
      }
      wg_wait<0>();
      reg_fence<32>(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl_r + 8 * n +
                                                           2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n + e] = sc[4 * n + e] *
                          (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t pa[4][4], da[4][4];   // P^T, dS^T as bf16 A fragments
      to_frags(sc, pa);
      to_frags(dp, da);
      if constexpr (kSplit) {        // dS^T to the dK warpgroup
        uint32_t* x = xch + kw * 16 * kWg + tid;
#pragma unroll
        for (int j = 0; j < 16; ++j) x[j * kWg] = da[j / 4][j % 4];
        asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + kw), "n"(2 * kWg)
                     : "memory");
      }
      reg_fence<kAcc>(acc);
      if constexpr (!kSplit) reg_fence<kAcc>(acc2);
      wg_fence();
      rs_product<D>(acc, pa, gt);                 // dV += P^T dout
      if constexpr (!kSplit) rs_product<D>(acc2, da, qt);   // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      reg_fence<kAcc>(acc);
      if constexpr (!kSplit) reg_fence<kAcc>(acc2);
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kw), "n"(2 * kWg)
                   : "memory");
      uint32_t da[4][4];
      const uint32_t* x = xch + kw * 16 * kWg + tid;
#pragma unroll
      for (int j = 0; j < 16; ++j) da[j / 4][j % 4] = x[j * kWg];
      reg_fence<kAcc>(acc);
      wg_fence();
      rs_product<D>(acc, da, qt);                 // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      reg_fence<kAcc>(acc);
    }
  }

  // dk, dv [B, Sk, KH, D], contiguous
  const long long stride = (long long)s.KH * D;
  bf16* dk_b = dk + ((long long)b * s.Sk * s.KH + kh) * D;
  bf16* dv_b = dv + ((long long)b * s.Sk * s.KH + kh) * D;
  if (main_wg) {
    store_acc<D>(dv_b, stride, kb, s.Sk, acc, 1.f);
    if constexpr (!kSplit) store_acc<D>(dk_b, stride, kb, s.Sk, acc2, s.scale);
  } else {
    store_acc<D>(dk_b, stride, kb, s.Sk, acc, s.scale);
  }
}

// dQ of one 64-query block of one head of one lane: the forward's
// structure, K and V through the ring.
template <int D>
__global__ void __launch_bounds__(kWg)
dq_wgmma_kernel(const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                Shape s, const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmg) {
  constexpr int kTile = tile_bytes<D>();
  constexpr int kAcc = padded<D>() / 2;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + kTile;
  const uint32_t k_s = g_s + kTile;
  const uint32_t v_s = k_s + kBwdStages * kTile;
  const uint32_t qg_bar = v_s + kBwdStages * kTile;   // Q and dout
  const uint32_t ring = qg_bar + 8;                    // one per stage

  const int nq = (s.Sq + kRowsT - 1) / kRowsT;
  // the query blocks with the most keys first (causal)
  const int iq = s.causal ? nq - 1 - blockIdx.z : blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (s.H / s.KH);
  const int q0 = iq * kRowsT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  int k_end = s.Sk;
  if (s.causal) k_end = min(k_end, q0 + kRowsT);   // blocks above skipped
  const int n_tiles = (k_end + kRowsT - 1) / kRowsT;

  auto issue = [&](int i) {
    const int st = i % kBwdStages;
    const uint32_t bar = ring + 8 * st;
    mbar_expect_tx(bar, 2 * kTile);
    tma_tile<D>(k_s + st * kTile, &tmk, kh, i * kRowsT, b, bar);
    tma_tile<D>(v_s + st * kTile, &tmv, kh, i * kRowsT, b, bar);
  };
  if (threadIdx.x == 0) {
    mbar_init(qg_bar, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) mbar_init(ring + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are initialized
  if (threadIdx.x == 0) {
    mbar_expect_tx(qg_bar, 2 * kTile);
    tma_tile<D>(q_s, &tmq, h, q0, b, qg_bar);
    tma_tile<D>(g_s, &tmg, h, q0, b, qg_bar);
#pragma unroll
    for (int i = 0; i < kBwdStages - 1; ++i)
      if (i < n_tiles) issue(i);
  }

  const float sl2 = s.scale * kLog2e;
  // this thread's rows: queries qi0 and qi0 + 8
  const int qi0 = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    const long long at = ((long long)b * s.H + h) * s.Sq + qi;
    lse2[r] = qi < s.Sq ? lse[at] * kLog2e : 0.f;
    dl[r] = qi < s.Sq ? delta[at] : 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kBwdStages;
    const int k0 = it * kRowsT;
    if (it == 0) mbar_wait(qg_bar, 0);
    mbar_wait(ring + 8 * st, (it / kBwdStages) & 1);
    __syncthreads();   // stage it - 1 is free again
    if (threadIdx.x == 0 && it + kBwdStages - 1 < n_tiles)
      issue(it + kBwdStages - 1);
    const uint32_t kt = k_s + st * kTile, vt = v_s + st * kTile;

    float sc[32], dp[32];
    wg_fence();
    ss_product<D>(sc, q_s, kt);     // S = Q K^T
    wg_commit();
    ss_product<D>(dp, g_s, vt);     // dP = dout V^T
    wg_commit();
    wg_wait<1>();
    reg_fence<32>(sc);

    const bool edge = k0 + kRowsT > s.Sk ||
                      (s.causal && k0 + kRowsT - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * n + 2 * t + (e & 1);
        const int qi = qi0 + 8 * (e >> 1);
        const bool ok = !edge || (kj < s.Sk && (!s.causal || kj <= qi));
        const float x = fmaf(sc[4 * n + e], sl2, -lse2[e >> 1]);
        sc[4 * n + e] = ok ? ex2(x) : 0.f;
      }
    }
    wg_wait<0>();
    reg_fence<32>(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    uint32_t da[4][4];   // dS as bf16 A fragments
    to_frags(dp, da);
    reg_fence<kAcc>(acc);
    wg_fence();
    rs_product<D>(acc, da, kt);     // dQ += dS K
    wg_commit();
    wg_wait<0>();
    reg_fence<kAcc>(acc);
  }

  // dq [B, Sq, H, D], contiguous
  store_acc<D>(dq + ((long long)b * s.Sq * s.H + h) * D, (long long)s.H * D,
               q0, s.Sq, acc, s.scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename E, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         const Shape& s, cudaStream_t stream) {
  const long long rows = (long long)s.B * s.Sq * s.H;
  delta_kernel<E, D><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                       kThreads, 0, stream>>>(
      static_cast<const E*>(out), static_cast<const E*>(dout), delta, s.B,
      s.Sq, s.H);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta,
                       const Shape& s, cudaStream_t stream) {
  const float* qe = static_cast<const float*>(q);
  const float* ke = static_cast<const float*>(k);
  const float* ve = static_cast<const float*>(v);
  const float* ge = static_cast<const float*>(dout);
  cudaError_t e = launch_delta<float, D>(out, dout, delta, s, stream);
  if (e != cudaSuccess) return e;

  constexpr size_t smem = smem_bytes<D>();
  if ((e = allow_smem(dkdv_kernel<float, D>, smem)) != cudaSuccess) return e;
  if ((e = allow_smem(dq_kernel<float, D>, smem)) != cudaSuccess) return e;
  dim3 grid_kv((s.Sk + kBlk - 1) / kBlk, s.KH, s.B);
  dkdv_kernel<float, D><<<grid_kv, kThreads, smem, stream>>>(
      qe, ke, ve, ge, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), s);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dim3 grid_q((s.Sq + kBlk - 1) / kBlk, s.H, s.B);
  dq_kernel<float, D><<<grid_q, kThreads, smem, stream>>>(
      qe, ke, ve, ge, lse, delta, static_cast<float*>(dq), s);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        const Shape& s, cudaStream_t stream) {
  cudaError_t e = launch_delta<bf16, D>(out, dout, delta, s, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap tmq, tmk, tmv, tmg;
  const long long g_ss = (long long)s.H * D;   // dout: contiguous
  if (!tile_map<D>(&tmq, q, s.B, s.Sq, s.H, s.q_sb, s.q_ss, s.q_sh) ||
      !tile_map<D>(&tmk, k, s.B, s.Sk, s.KH, s.k_sb, s.k_ss, s.k_sh) ||
      !tile_map<D>(&tmv, v, s.B, s.Sk, s.KH, s.v_sb, s.v_ss, s.v_sh) ||
      !tile_map<D>(&tmg, dout, s.B, s.Sq, s.H, g_ss * s.Sq, g_ss, D))
    return cudaErrorInvalidValue;

  constexpr size_t kv_smem = dkdv_smem_bytes<D, kKeyWgs>();
  if ((e = allow_smem(dkdv_wgmma_kernel<D, kKeyWgs>, kv_smem)) != cudaSuccess)
    return e;
  constexpr int kv_threads = kWg * kKeyWgs * (split_dk<D>() ? 2 : 1);
  const int kb = kRowsT * kKeyWgs;
  dim3 grid_kv(s.KH, s.B, (s.Sk + kb - 1) / kb);
  dkdv_wgmma_kernel<D, kKeyWgs><<<grid_kv, kv_threads, kv_smem, stream>>>(
      lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, tmq,
      tmk, tmv, tmg);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t q_smem = dq_smem_bytes<D>();
  if ((e = allow_smem(dq_wgmma_kernel<D>, q_smem)) != cudaSuccess) return e;
  dim3 grid_q(s.H, s.B, (s.Sq + kRowsT - 1) / kRowsT);
  dq_wgmma_kernel<D><<<grid_q, kWg, q_smem, stream>>>(
      lse, delta, static_cast<bf16*>(dq), s, tmq, tmk, tmv, tmg);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, const void* out, const void* dout,
                         const float* lse, void* dq, void* dk, void* dv,
                         float* delta, const Shape& s, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, dout, lse, dq, dk, dv, delta, s, st);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, dout, lse, dq, dk, dv, delta, s, st);
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
