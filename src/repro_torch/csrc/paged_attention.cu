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
// G*HD query values and every valid page's T x HD K and V tiles, and
// does 4*G*HD flops per token read — about 2 flops per byte at G = 2,
// far below the ~295 flops per byte where bf16 tensor cores would be
// the limit. The least time is the valid K/V bytes over 3.35 TB/s, so
// what the kernel needs is bytes in flight.
//
// What the design does about it:
//  * The page range of each (b, kh) is cut into `splits` ranges
//    (flash-decoding), one CTA each, sized by the wrapper
//    (`choose_splits`) to fill the card in about one wave.
//  * Each CTA first compacts its range's page list in shared memory:
//    a hole (page_list < 0 or page_valid == 0) costs one int load and
//    writes its LSE as NEG_INF; no byte of it is loaded.
//  * Then each warp walks its own share of the compacted pages (page c
//    to warp c % warps) with a private ring of kRing = 3 page stages:
//    `cp.async.cg` 16-byte copies of page i + 2 are in flight while
//    page i is computed, and a partial page loads only its valid rows.
//    K/V stay in their dtype in shared memory and are widened in
//    registers. The warp owns its pages outright, so the main loop has
//    no block barrier at all, only `__syncwarp`: scores by warp
//    shuffles, the page-local max, sum and LSE and the running (m, l)
//    in registers, the running PV accumulator in the warp's slice of
//    shared memory.
//  * At the end the CTA merges its warps, and the last CTA of each
//    (b, kh) to finish (a ticket from `atomicAdd` after
//    `__threadfence`) merges the splits and writes out, m and l; it
//    puts the ticket counter back to 0, so the next launch — or the
//    next replay of a CUDA graph — finds it zeroed. One launch per
//    call.
//  * The pools are taken as a raw pointer plus element strides. In
//    overlap mode the host tier's pools live in pinned host memory and
//    the wrapper passes their mapped device address
//    (cudaHostGetDevicePointer): the same rings then read them over
//    the link. That path is correct, not designed for the link's
//    latency: 2.32-2.57 ms at N=208, 28-31 GB/s, 2.1-2.3x the pools'
//    valid bytes over the link's 64 GB/s peak, where a large copy_
//    reaches 47-55 GB/s (chip_smoke.py phase 2).
// Measured by chip_smoke.py phase 2 on an NVIDIA H100 80GB HBM3
// (700 W) at B=8, KH=8, G=2, HD=128, 16-token pages: 0.024 ms over
// N=64 pages and 0.052 ms over N=208 — 3.9x and 2.5x the bytes bound,
// below scaled_dot_product_attention over the same keys (0.033 and
// 0.081 ms) (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRing = 3;   // page stages per warp
constexpr int kMaxDevices = 64;

template <typename E> struct Pack;

template <> struct Pack<float> {
  static constexpr int kN = 4;  // elements per 16-byte chunk
  __device__ static void load16(const float* p, float* d) { load4(p, d); }
  // 4 consecutive elements, widened
  __device__ static void load4(const float* p, float* d) {
    float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load16(const __nv_bfloat16* p, float* d) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
  __device__ static void load4(const __nv_bfloat16* p, float* d) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
  }
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

struct Shape {
  int B, KH, G, HD, P, T, N;
  long long k_sb, k_sp, k_st, k_skh;  // element strides of k_pool
  long long v_sb, v_sp, v_st, v_skh;  // element strides of v_pool
  int splits, pages_per_split;
  float scale;
};

// Shared-memory plan, in bytes: ring [warps][kRing][K, V][T][HD] (E) |
// q [G][HD] f32 | acc [warps][G][HD] f32 | m, l [warps][G] f32 |
// compacted page index, slot, valid [pages_per_split] int | count, flag.
// kernels/paged_attention.py `smem_bytes` mirrors it.
__host__ __device__ inline size_t smem_bytes(int warps, int G, int HD, int T,
                                             int es, int per) {
  return (size_t)warps * kRing * 2 * T * HD * es +
         4 * ((size_t)G * HD + (size_t)warps * G * HD + 2 * (size_t)warps * G +
              3 * (size_t)per + 2);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// N (4 or 8) consecutive floats of shared memory, 16-byte aligned.
template <int N>
__device__ inline void load_f(const float* p, float* d) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    d[i] = v.x; d[i + 1] = v.y; d[i + 2] = v.z; d[i + 3] = v.w;
  }
}

template <typename E>
__global__ void paged_split_kernel(
    const E* __restrict__ q, const E* __restrict__ k_pool,
    const E* __restrict__ v_pool, const int* __restrict__ page_list,
    const int* __restrict__ page_valid, E* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ lse, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, Shape s) {
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int G = s.G, HD = s.HD, T = s.T, N = s.N;
  const int per = s.pages_per_split;
  const int page_elems = T * HD;           // one K (or V) page tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ring = reinterpret_cast<E*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(ring + (size_t)warps * kRing * 2 *
                                                   page_elems);
  float* acc_s = q_s + G * HD;             // [warps][G][HD]
  float* m_s = acc_s + warps * G * HD;     // [warps][G]
  float* l_s = m_s + warps * G;
  int* c_idx = reinterpret_cast<int*>(l_s + warps * G);
  int* c_slot = c_idx + per;
  int* c_nv = c_slot + per;
  int* n_valid = c_nv + per;
  int* is_last = n_valid + 1;

  const long long bk = (long long)b * s.KH + kh;
  for (int i = tid; i < G * HD; i += nthreads)
    q_s[i] = Pack<E>::to_f(q[bk * G * HD + i]);
  for (int i = tid; i < warps * G * HD; i += nthreads) acc_s[i] = 0.f;
  for (int i = tid; i < warps * G; i += nthreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // compact the split's page list: holes write their LSE and go
  const int p0 = split * per;
  const int p1 = min(N, p0 + per);
  if (warp == 0) {
    int cnt = 0;
    for (int base = p0; base < p1; base += 32) {
      const int i = base + lane;
      int slot = -1, nv = 0;
      if (i < p1) {
        slot = page_list[(long long)b * N + i];
        nv = page_valid[(long long)b * N + i];
      }
      const bool ok = i < p1 && slot >= 0 && nv > 0;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
        c_idx[pos] = i;
        c_slot[pos] = min(slot, s.P - 1);
        c_nv[pos] = min(nv, T);
      } else if (i < p1) {
        for (int g = 0; g < G; ++g) lse[(bk * G + g) * N + i] = kNegInf;
      }
      cnt += __popc(mask);
    }
    if (lane == 0) *n_valid = cnt;
  }
  __syncthreads();

  // this warp's pages: c = warp, warp + warps, ...
  const int nc = *n_valid;
  const int mine = nc > warp ? (nc - warp + warps - 1) / warps : 0;
  E* my_ring = ring + (size_t)warp * kRing * 2 * page_elems;
  const int vec = HD * (int)sizeof(E) / 16;  // 16-byte chunks per row

  // `tpg` lanes share a token's dot product (T * tpg <= 32); part p
  // of a token reads its chunks p, p + tpg, ...
  int tpg = 1;
  while (tpg * 2 * T <= 32) tpg *= 2;
  const int tok = lane / tpg, part = lane - tok * tpg;
  // K rows are stored swizzled: 16-byte chunk cc of token t sits at
  // cc ^ ((t * tpg) & kmask), so the 8 lanes of a quarter-warp, which
  // read 8 different (token, chunk) pairs, hit distinct banks
  const int kmask = min(vec & -vec, 8) - 1;
  const int kswz = (tok * tpg) & kmask;
  constexpr int kN = Pack<E>::kN;

  auto issue = [&](int i) {
    const int c = warp + i * warps;
    const int slot = c_slot[c], nv = c_nv[c];
    E* kd = my_ring + (size_t)(i % kRing) * 2 * page_elems;
    E* vd = kd + page_elems;
    const E* kp = k_pool + b * s.k_sb + slot * s.k_sp + kh * s.k_skh;
    const E* vp = v_pool + b * s.v_sb + slot * s.v_sp + kh * s.v_skh;
    for (int idx = lane; idx < nv * vec; idx += 32) {
      const int t = idx / vec, cc = idx - t * vec;
      cp_async16(kd + t * HD + (cc ^ ((t * tpg) & kmask)) * kN,
                 kp + t * s.k_st + cc * kN);
      cp_async16(vd + t * HD + cc * kN, vp + t * s.v_st + cc * kN);
    }
  };

#pragma unroll
  for (int i = 0; i < kRing; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();   // one group per stage, empty or not
  }

  float* acc_w = acc_s + warp * G * HD;
  float* m_w = m_s + warp * G;
  float* l_w = l_s + warp * G;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait_ring();   // page i has landed (this lane's copies)
    __syncwarp();           // ... and every lane's
    const int c = warp + i * warps;
    const int pi = c_idx[c], nv = c_nv[c];
    const E* kt = my_ring + (size_t)(i % kRing) * 2 * page_elems;
    const E* vt = kt + page_elems;
    const bool live = tok < nv;
    // the G query rows two at a time: one K or V load feeds both
    for (int g0 = 0; g0 < G; g0 += 2) {
      const bool two = g0 + 1 < G;
      const int gr[2] = {g0, two ? g0 + 1 : g0};
      float sc[2] = {0.f, 0.f};
      if (live) {
        const E* krow = kt + tok * HD;
        float part_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // 4 FMA chains
#pragma unroll 4
        for (int cc = part; cc < vec; cc += tpg) {
          float kv[kN], qa[kN], qb[kN];
          Pack<E>::load16(krow + (cc ^ kswz) * kN, kv);
          load_f<kN>(q_s + gr[0] * HD + cc * kN, qa);
          load_f<kN>(q_s + gr[1] * HD + cc * kN, qb);
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            part_sum[0][j & 1] += qa[j] * kv[j];
            part_sum[1][j & 1] += qb[j] * kv[j];
          }
        }
        sc[0] = part_sum[0][0] + part_sum[0][1];
        sc[1] = part_sum[1][0] + part_sum[1][1];
      }
      // the page-local max, sum and LSE of both rows, their reductions
      // interleaved, then the running (m, l)
      float my[2], mp[2], e[2], lp[2], c_old[2], c_page[2], m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        for (int off = 1; off < tpg; off <<= 1)
          sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
        my[r] = live ? sc[r] * s.scale : kNegInf;
        mp[r] = my[r];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mp[0] = fmaxf(mp[0], __shfl_xor_sync(0xffffffffu, mp[0], off));
        mp[1] = fmaxf(mp[1], __shfl_xor_sync(0xffffffffu, mp[1], off));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        e[r] = live ? expf(my[r] - mp[r]) : 0.f;
        lp[r] = part == 0 ? e[r] : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lp[0] += __shfl_xor_sync(0xffffffffu, lp[0], off);
        lp[1] += __shfl_xor_sync(0xffffffffu, lp[1], off);
      }
      float l_old[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_old = m_w[gr[r]];
        l_old[r] = l_w[gr[r]];
        m_new[r] = fmaxf(m_old, mp[r]);
        c_old[r] = m_old <= kNegInf / 2 ? 0.f : expf(m_old - m_new[r]);
        c_page[r] = expf(mp[r] - m_new[r]);
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r == 1 && !two) break;
          const int g = gr[r];
          lse[(bk * G + g) * N + pi] = mp[r] + logf(fmaxf(lp[r], 1e-37f));
          m_w[g] = m_new[r];
          l_w[g] = l_old[r] * c_old[r] + lp[r] * c_page[r];
        }
      }
      // acc += p v: each lane owns 4 consecutive dims of each 128
      for (int db = 0; db < HD; db += 128) {
        const int d0 = db + lane * 4;
        const bool on = d0 < HD;
        float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
        for (int t = 0; t < nv; ++t) {
          const float e0 = __shfl_sync(0xffffffffu, e[0], t * tpg);
          const float e1 = __shfl_sync(0xffffffffu, e[1], t * tpg);
          if (on) {
            float vv[4];
            Pack<E>::load4(vt + t * HD + d0, vv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pv[0][j] += e0 * vv[j];
              pv[1][j] += e1 * vv[j];
            }
          }
        }
        if (on) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (r == 1 && !two) break;
            float* a = acc_w + gr[r] * HD + d0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[j] = a[j] * c_old[r] + pv[r][j] * c_page[r];
          }
        }
      }
    }
    __syncwarp();   // the stage is read; it may be refilled
    if (i + kRing < mine) issue(i + kRing);
    cp_async_commit();
  }
  __syncthreads();

  // merge the warps into this split's (m, l, acc)
  const int BKH = s.B * s.KH;
  const bool single = s.splits == 1;
  for (int idx = tid; idx < G * HD; idx += nthreads) {
    const int g = idx / HD, d = idx - g * HD;
    float m = kNegInf;
    for (int w = 0; w < warps; ++w) m = fmaxf(m, m_s[w * G + g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float lw = l_s[w * G + g];
      if (lw > 0.f) {
        const float c = expf(m_s[w * G + g] - m);
        l += lw * c;
        a += acc_s[(w * G + g) * HD + d] * c;
      }
    }
    if (single) {
      out[bk * G * HD + idx] = Pack<E>::from_f(a / fmaxf(l, 1e-20f));
      if (d == 0) {
        m_out[bk * G + g] = m;
        l_out[bk * G + g] = l;
      }
    } else {
      const long long row = (long long)split * BKH + bk;
      part_acc[row * G * HD + idx] = a;
      if (d == 0) {
        part_m[row * G + g] = m;
        part_l[row * G + g] = l;
      }
    }
  }
  if (single) return;

  // the last split of (b, kh) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[bk], 1);
    *is_last = ticket == s.splits - 1;
    if (*is_last) tickets[bk] = 0;   // zero again for the next launch
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  for (int idx = tid; idx < G * HD; idx += nthreads) {
    const int g = idx / HD, d = idx - g * HD;
    float m = kNegInf;
    for (int sp = 0; sp < s.splits; ++sp)
      m = fmaxf(m, __ldcg(part_m + ((long long)sp * BKH + bk) * G + g));
    const float m_safe = m <= kNegInf / 2 ? 0.f : m;
    float l = 0.f, a = 0.f;
    for (int sp = 0; sp < s.splits; ++sp) {
      const long long r = (long long)sp * BKH + bk;
      const float ls = __ldcg(part_l + r * G + g);
      if (ls > 0.f) {
        const float c = expf(__ldcg(part_m + r * G + g) - m_safe);
        l += ls * c;
        a += __ldcg(part_acc + r * G * HD + idx) * c;
      }
    }
    out[bk * G * HD + idx] = Pack<E>::from_f(a / fmaxf(l, 1e-20f));
    if (d == 0) {
      m_out[bk * G + g] = m;
      l_out[bk * G + g] = l;
    }
  }
}

// The kernel's dynamic shared-memory limit is one attribute of the
// function, shared by every host thread: a launch sized below it runs,
// one above it fails with cudaErrorInvalidValue. Launches from several
// threads (the ranks of a mesh run as threads of one process) need
// different sizes — a rank's HBM and host tiers differ in pages per
// split — so the limit is raised to the largest size asked for so far
// and never lowered: a thread setting its own, smaller size between
// another's set and launch would fail that launch.
template <typename E>
cudaError_t allow_smem(size_t smem) {
  static std::mutex mu;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (smem <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_split_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) allowed[dev] = smem;
  return e;
}

template <typename E>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_list, const int* page_valid, void* out,
                   float* m_out, float* l_out, float* lse, float* part_m,
                   float* part_l, float* part_acc, int* tickets,
                   const Shape& s, int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(warps, s.G, s.HD, s.T, (int)sizeof(E),
                                 s.pages_per_split);
  if (smem > 48 * 1024) {
    cudaError_t e = allow_smem<E>(smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(s.splits, s.KH, s.B);
  paged_split_kernel<E><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k_pool),
      static_cast<const E*>(v_pool), page_list, page_valid,
      static_cast<E*>(out), m_out, l_out, lse, part_m, part_l, part_acc,
      tickets, s);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16 (q, pools and out share it). q and out are contiguous
// [B, KH, G, HD]; page_list / page_valid contiguous int32 [B, N]; the
// pools are [B, P, T, KH, HD] with the given element strides and a
// contiguous last dim. Partial buffers (read only when splits > 1):
// part_m / part_l [splits, B, KH, G], part_acc [splits, B, KH, G, HD],
// all f32. tickets: int32 [B * KH], zero on entry and left zero.
// warps (1..4) per CTA. Returns a cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_list, const int* page_valid, void* out, float* m_out,
    float* l_out, float* lse, float* part_m, float* part_l, float* part_acc,
    int* tickets, int B, int KH, int G, int HD, int P, int T, int N,
    long long k_sb, long long k_sp, long long k_st, long long k_skh,
    long long v_sb, long long v_sp, long long v_st, long long v_skh,
    int splits, int pages_per_split, int warps, float scale, int dtype,
    void* stream) {
  if (T > 32 || T < 1 || G < 1 || HD < 4 || HD % 4 || splits < 1 || N < 1 ||
      warps < 1 || warps > 4 || pages_per_split < 1)
    return (int)cudaErrorInvalidValue;
  Shape s{B, KH, G, HD, P, T, N, k_sb, k_sp, k_st, k_skh,
          v_sb, v_sp, v_st, v_skh, splits, pages_per_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(q, k_pool, v_pool, page_list, page_valid, out, m_out,
                      l_out, lse, part_m, part_l, part_acc, tickets, s,
                      warps, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k_pool, v_pool, page_list, page_valid, out,
                              m_out, l_out, lse, part_m, part_l, part_acc,
                              tickets, s, warps, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
