// Causal (or full) streaming-softmax attention for prefill, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (Pallas body `_kernel`), and
// computes what that kernel computes: scores q.k * D^-0.5 accumulated
// in f32, query i sees keys 0..i when causal (aligned at 0), a running
// (m, l, acc) in f32 with the finite NEG_INF (-1e30) and its guards
// (p = 0 where s <= NEG_INF/2, m_safe, corr = 0 while m is still
// NEG_INF), and out = acc / max(l, 1e-20) cast to q's dtype. When
// training asks for it (a non-null `lse`), the epilogue also writes
// each row's log-sum-exp m + log(l) in f32, which the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from.
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
// Two bodies, chosen by dtype:
//  * bf16 (the main path): both products on the tensor cores with
//    Hopper's warpgroup `wgmma.mma_async` (bf16 in, f32 accumulate).
//    One CTA of one warpgroup (4 warps) per (64-row q block, head,
//    lane); S = Q.K^T is `m64n64k16` with Q and K read from shared
//    memory by descriptor; S's accumulator stays in registers and is
//    turned, in place, into the A operand (registers) of O += P.V,
//    `m64nDk16` with V read by descriptor with the transpose bit. P
//    makes no trip through shared memory, and O (64 x D) stays in
//    registers. P enters P.V as bf16 hi + lo (lo the bf16 rounding of
//    P - hi, a second product): P rounded once to bf16 moves out by up
//    to 2^-9 relative, and where |out| >= 2 that flips bf16 roundings
//    of out by one step, 0.0156, past the 1e-2 tolerance
//    (scripts/bf16_p_rounding.py); hi + lo holds P to ~2^-17.
//    K/V tiles of 64 keys come by TMA (thread 0, a 4-D tensor map
//    {D, KH, S, B} over the strided tensor, so GQA and packed QKV views
//    need no copy; rows past Sk zero-filled) into a ring of 2 stages
//    tracked by mbarriers: the next tile is in flight while this one is
//    computed, one block barrier per tile. Tiles use TMA's swizzle
//    (128-byte, or 64/32-byte for D = 32/16), which is also the layout
//    the wgmma descriptors name; Q comes once by `cp.async` into the
//    same layout. Masking runs on the tiles that cross the diagonal or
//    the end of the keys only; the scale folds into the exponent and
//    the softmax uses ex2.approx. Not done yet: a producer warp with
//    `setmaxnreg`, two consumer warpgroups, and overlapping one tile's
//    softmax with the next tile's products.
//    Measured by chip_smoke.py phase 2b on an NVIDIA H100 80GB HBM3
//    (700 W) at the prefill shape above: 0.296 ms, 294 TFLOP/s — 3.4x
//    the bound, 1.75x the 0.169 ms of scaled_dot_product_attention
//    (PERF.md).
//    Head dims 16, 32, 64, 128 and 160. A head dim above 64 that is not
//    a multiple of 64 (160: stablelm-12b) is held in a shared tile
//    padded to the next multiple (192): TMA fills the third 64-column
//    box's columns past D with zeros, Q's tail is never read (the
//    products of Q.K^T step over the D real columns only), and O.V
//    runs over all 192 columns (m64n128k16 + m64n64k16), whose last 32
//    stay zero and are not stored.
//  * f32: products on the CUDA cores by FMA (no TF32): the
//    card-vs-CPU parity of the single-stream path needs full-f32
//    products. q/K/V tiles widened to f32 in shared memory, each thread
//    a 4 x 4 block of the 64 x 64 score tile; causal blocks above the
//    diagonal skipped, the q blocks with the most keys launched first.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // f32 body
constexpr int kQB = 64;       // query rows per CTA
constexpr int kKB = 64;       // keys per tile
constexpr int kPad = 4;       // floats of padding per shared row
constexpr int kRows = 4;      // score / output rows per thread
constexpr int kCols = 4;      // score columns per thread (kKB / 16)

// ---------------------------------------------------------------------
// f32: FMA body
// ---------------------------------------------------------------------

template <typename E> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ static void load(const float* p, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static float from_f(float x) { return x; }
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
flash_fma_kernel(const E* __restrict__ q, const E* __restrict__ k,
             const E* __restrict__ v, E* __restrict__ out,
             float* __restrict__ lse, Shape s) {
  constexpr int DS = D + kPad;          // shared row stride of q, k, v
  constexpr int PS = kKB + kPad;        // shared row stride of p
  constexpr int DC = D / 16;            // output columns per thread
  // their vector width: 4, or what divides DC (2 at D = 160)
  constexpr int VW = DC % 4 == 0 ? 4 : DC % 2 == 0 ? 2 : 1;

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
    if (lse != nullptr && tx == 0)   // m is in scaled units here
      lse[((long long)b * s.H + h) * s.Sq + qi] =
          (m[i] <= kNegInf / 2 ? 0.f : m[i]) + logf(fmaxf(l[i], 1e-20f));
    E* orow = out + (((long long)b * s.Sq + qi) * s.H + h) * D;
#pragma unroll
    for (int g = 0; g < DC / VW; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[g * 16 * VW + tx * VW + e] =
            Elem<E>::from_f(acc[i][g * VW + e] * inv);
  }
}

// ---------------------------------------------------------------------
// bf16: tensor-core body (wgmma, TMA ring)
// ---------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup per CTA
constexpr int kQBM = 64;          // query rows per CTA
constexpr int kKBM = 64;          // keys per tile
constexpr int kStages = 2;        // K/V tiles in the ring

// 16 bytes global -> shared; `bytes` 0 zero-fills the destination.
__device__ inline void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of ROWS rows
// of D bf16 values, laid out as TMA's swizzle modes lay it: the tile is
// cut into column blocks of 128 bytes (all of a row when D < 64); in
// each, chunk c of row r sits at c ^ (r % 8) (64-byte rows: c ^ (r / 2
// % 4); 32-byte rows: c ^ (r / 4 % 2)), which is the XOR of address
// bits 4-6 with bits 7-9 that TMA applies. Tiles start on 1024 bytes.
template <int D, int ROWS>
__device__ inline uint32_t swz(int r, int c) {
  constexpr int kRowB = D * 2 < 128 ? D * 2 : 128;
  constexpr int kCpr = kRowB / 16;
  uint32_t a = (uint32_t)((c / kCpr) * ROWS * kRowB + r * kRowB +
                          (c % kCpr) * 16);
  return a ^ (((a >> 7) & (kCpr - 1)) << 4);
}

// Issue the copies of rows [row0, row0 + N) of one head of a
// [*, S, heads, D] tensor into a swizzled tile; rows at or past `rows`
// are zero-filled.
template <int D, int N>
__device__ inline void load_tile_async(const bf16* __restrict__ src,
                                       long long ss, int row0, int rows,
                                       uint32_t dst) {
  constexpr int kC = D / 8;
  for (int idx = threadIdx.x; idx < N * kC; idx += kWgThreads) {
    const int r = idx / kC, c = idx - r * kC;
    const bool in = row0 + r < rows;
    const bf16* p = src + (in ? (long long)(row0 + r) * ss + c * 8 : 0);
    cp_async16(dst + swz<D, N>(r, c), p, in ? 16 : 0);
  }
}

template <int D>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  // q [kQBM][DP] | k, v [kStages][kKBM][DP], bf16 | an mbarrier per
  // stage | slack to start the tiles on 1024 bytes
  return sizeof(bf16) * (size_t)padded<D>() * (kQBM + 2 * kStages * kKBM) +
         8 * kStages + 1024;
}

// Two consecutive P values as bf16 hi + lo (the bf16 rounding of what
// hi leaves), one A-fragment register each: hi + lo holds P to ~2^-17.
__device__ inline void pack_p(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                           y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}

__device__ inline void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_wgmma_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                   float* __restrict__ lse,
                   Shape s, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv) {
  constexpr int DP = padded<D>();   // shared tile width (D, or 192)
  constexpr int KS = D / 16;       // k-steps of Q.K^T (real columns)
  constexpr int DT = D / 8;        // 8-column tiles of O that are stored
  constexpr int DTP = DP / 8;      // ... and that are computed
  constexpr int kTile = kKBM * DP * (int)sizeof(bf16);
  constexpr int kRowB = D * 2 < 128 ? D * 2 : 128;   // swizzle row bytes
  constexpr uint32_t kLayout = kRowB == 128 ? 1 : kRowB == 64 ? 2 : 3;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // tiles start on 1024 bytes, as the swizzle modes want
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kQBM * DP * (int)sizeof(bf16);
  const uint32_t v_s = k_s + kStages * kTile;
  const uint32_t full = v_s + kStages * kTile;   // mbarrier per stage

  const int nq = (s.Sq + kQBM - 1) / kQBM;
  // the q blocks with the most keys first (causal)
  const int iq = s.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (s.H / s.KH);
  const int q0 = iq * kQBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row / column pair

  const bf16* qb = q + b * s.q_sb + h * s.q_sh;

  int k_end = s.Sk;
  if (s.causal) k_end = min(k_end, q0 + kQBM);  // blocks above skipped
  const int n_tiles = (k_end + kKBM - 1) / kKBM;

  // the ring: tile i lives in stage i % kStages; thread 0 issues each
  // tile's K and V boxes by TMA onto the stage's mbarrier (DP / 64
  // boxes each: a box past D arrives zero-filled, and counts in full)
  auto issue = [&](int i) {
    if (threadIdx.x != 0) return;
    const int st = i % kStages;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 64) {
      const uint32_t off = (c0 / 64) * kKBM * 128;   // column block
      tma_load(k_s + st * kTile + off, &tmk, c0, kh, i * kKBM, b, bar);
      tma_load(v_s + st * kTile + off, &tmv, c0, kh, i * kKBM, b, bar);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_tile_async<D, kQBM>(qb, s.q_ss, q0, s.Sq, q_s);
  cp_async_commit();
  __syncthreads();   // the barriers are initialized
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    if (i < n_tiles) issue(i);

  const float sl2 = s.scale * kLog2e;   // exponents in log2 units
  // this thread's rows of S and O: qi0 and qi0 + 8; its columns
  // 8 n + 2 t and 8 n + 2 t + 1 of each 8-column block n
  const int qi0 = q0 + warp * 16 + g;

  float o[DTP * 4];
#pragma unroll
  for (int i = 0; i < DTP * 4; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKBM;
    if (it == 0) {   // q, written by cp.async, is read by wgmma
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
    __syncthreads();   // q is everyone's; stage it-1 is free again
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    const uint32_t kt = k_s + (it % kStages) * kTile;
    const uint32_t vt = v_s + (it % kStages) * kTile;

    // S = Q K^T: A = Q and B = K, both K-major in the swizzled tiles;
    // k-step kk starts 32 bytes further into a 128-byte row, or in the
    // next column block
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = kk * 32 % kRowB;
      const uint32_t blk = (kk * 32) / kRowB;
      const uint64_t da = gmma_desc(q_s + blk * kQBM * kRowB + off, 16,
                                    8 * kRowB, kLayout);
      const uint64_t db = gmma_desc(kt + blk * kKBM * kRowB + off, 16,
                                    8 * kRowB, kLayout);
      wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wg_commit_wait();
    reg_fence<32>(sc);

    // mask only the tiles that cross the diagonal or the end; scores
    // stay unscaled, the scale folds into the exponent
    const bool edge = k0 + kKBM > s.Sk || (s.causal && k0 + kKBM - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = qi0 + (e >> 1) * 8;
          if (kj >= s.Sk || (s.causal && kj > qi)) sc[4 * n + e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
      }
    }
    float corr[2], m_sl2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      m_sl2[r] = m_safe * sl2;
      corr[r] = m[r] <= kNegInf / 2 ? 0.f : ex2((m[r] - m_safe) * sl2);
      m[r] = m_new;
      l[r] *= corr[r];   // this thread's share of the row sum
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[4 * n + e];
        const float p = x <= kNegInf / 2
                            ? 0.f : ex2(fmaf(x, sl2, -m_sl2[e >> 1]));
        l[e >> 1] += p;
        sc[4 * n + e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < DTP; ++n) {
      o[4 * n] *= corr[0]; o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1]; o[4 * n + 3] *= corr[1];
    }

    // O += P V: A = P from registers, S's accumulator fragments in
    // place (hi, then lo), B = V, MN-major: 16-key steps of 16 rows,
    // column blocks kKBM * 128 bytes apart
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pack_p(sc[8 * j], sc[8 * j + 1], ph[j][0], pl[j][0]);
      pack_p(sc[8 * j + 2], sc[8 * j + 3], ph[j][1], pl[j][1]);
      pack_p(sc[8 * j + 4], sc[8 * j + 5], ph[j][2], pl[j][2]);
      pack_p(sc[8 * j + 6], sc[8 * j + 7], ph[j][3], pl[j][3]);
    }
    reg_fence<DTP * 4>(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = gmma_desc(vt + j * 16 * kRowB, kKBM * kRowB,
                                    8 * kRowB, kLayout);
      wgmma_rs_tile<DP>(o, ph[j], dv, kKBM * kRowB);
      wgmma_rs_tile<DP>(o, pl[j], dv, kKBM * kRowB);
    }
    wg_commit_wait();
    reg_fence<DTP * 4>(o);
  }

  // out [B, Sq, H, D], contiguous; the quad holds each row's sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = qi0 + r * 8;
    if (qi >= s.Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-20f);
    if (lse != nullptr && t == 0)    // m is in unscaled units here
      lse[((long long)b * s.H + h) * s.Sq + qi] =
          (m[r] <= kNegInf / 2 ? 0.f : m[r] * s.scale) +
          logf(fmaxf(lr, 1e-20f));
    bf16* orow = out + (((long long)b * s.Sq + qi) * s.H + h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                o[4 * n + 2 * r + 1] * inv);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, const Shape& s,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(flash_fma_kernel<float, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.Sq + kQB - 1) / kQB, s.H, s.B);
  flash_fma_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, const Shape& s,
                        cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<D>();
  cudaError_t e = allow_smem(flash_wgmma_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tmk, tmv;
  if (!tile_map<D>(&tmk, k, s.B, s.Sk, s.KH, s.k_sb, s.k_ss, s.k_sh) ||
      !tile_map<D>(&tmv, v, s.B, s.Sk, s.KH, s.v_sb, s.v_ss, s.v_sh))
    return cudaErrorInvalidValue;
  dim3 grid((s.Sq + kQBM - 1) / kQBM, s.H, s.B);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(out), lse, s, tmk,
      tmv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, float* lse, const Shape& s,
                   cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, out, lse, s, stream);
  if (dtype == 1) return launch_bf16<D>(q, k, v, out, lse, s, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out share it). q is [B, Sq, H, D], k and v
// [B, Sk, KH, D], each with the given element strides of its first
// three dims and a contiguous last dim; out is a contiguous
// [B, Sq, H, D]. KH divides H; D is 16, 32, 64, 128 or 160. `lse`,
// when not null, receives each row's log-sum-exp of its scaled scores,
// m + log(l), f32 [B, H, Sq] (what the backward kernel of
// flash_attention_bwd.cu recomputes P from); null costs nothing but the
// test in the epilogue. Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse_out,
    int B, int Sq,
    int Sk, int H, int KH, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  Shape s{B, Sq, Sk, H, KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
          v_sb, v_ss, v_sh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 16: return (int)launch<16>(dtype, q, k, v, out, lse, s, st);
    case 32: return (int)launch<32>(dtype, q, k, v, out, lse, s, st);
    case 64: return (int)launch<64>(dtype, q, k, v, out, lse, s, st);
    case 128: return (int)launch<128>(dtype, q, k, v, out, lse, s, st);
    case 160: return (int)launch<160>(dtype, q, k, v, out, lse, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
