// AdamW's update over a whole parameter tree, for Hopper (sm_90a): two
// kernels that each cover every leaf of the tree in one launch.
//
//   grad_sumsq   each leaf's sum of squares of its gradient (bf16 or
//                f32), out: f32 [n_leaves] on the card; the global-norm
//                clip's input (`training/optimizer.py global_norm`).
//   adamw_apply  the step for every element of every leaf:
//                  g  = g * scale                      (the clip)
//                  m' = b1 * m + (1 - b1) * g
//                  v' = b2 * v + (1 - b2) * g * g
//                  u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p
//                  p' = p - lr * u                     (cast to p's type)
//                reading g (bf16 or f32), p (bf16 or f32), m and v
//                (f32) and writing p', m', v' — into the inputs' own
//                buffers (a donated state: in place) or into new ones.
//
// Not a port of a TPU kernel: the reference's train step is one jitted
// function whose state is donated (src/repro/launch/train.py:60-65), and
// XLA fuses its `adamw_update` (src/repro/training/optimizer.py) into one
// elementwise pass per leaf that writes into the donated buffers. The
// same arithmetic as plain PyTorch ops makes a new tensor of every
// intermediate: an f32 copy of each gradient, new m and v beside the
// old, f32 copies of p and u, ~26 bytes a parameter alive at once.
// These kernels hold only what the reference's update holds (p, g, m,
// v: 12 bytes a parameter with bf16 weights) and move each byte once.
// At internlm2-1.8b's 1.889 B bf16 parameters on an NVIDIA H100 80GB
// HBM3 (700.00 W; chip_smoke.py phase 2e) the update takes 14.8 ms in
// place against its 12.4 ms bound and the plain version's 136.3 ms; the
// sums 1.55 ms against 1.13 and 13.3.
//
// What bounds them: bytes. The update reads 2 + 2 + 4 + 4 and writes
// 2 + 4 + 4 bytes a bf16 parameter (22; 28 with f32 weights and
// gradients) and does ~17 f32 operations on them, far below the card's
// ~20 operations a byte; the sums read each gradient once. So the design
// only has to keep HBM busy: every leaf gets a share of the grid's
// blocks in proportion to its elements (`kernels/adamw.py` plans it; a
// block finds its leaf by a binary search of the table's first blocks),
// and each thread walks its leaf in a grid-stride loop of 8 elements a
// step — 16-byte vector loads and stores of every array, where all of
// the leaf's addresses are 16-byte aligned, else one element at a time.
// The leaf table rides in the kernel's parameters (`__grid_constant__`,
// read in place), so a launch needs no copy to the card and no host
// sync; `scale`, `lr`, `bc1` and `bc2` are read from the card.
//
// Bitwise: the update is the plain version's (`kernels/ref.py
// adamw_apply_ref`) exactly, for the same scalars, because every
// operation is one IEEE f32 operation rounded to nearest, in the plain
// version's order (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction, no approximate division or square
// root), as PyTorch's CUDA kernels compute each of those ops, and the
// cast back to bf16 rounds to nearest even as PyTorch's does.
//
// The sums are bitwise reproducible from run to run and use no atomics:
// pass 1 gives every block a fixed set of elements, whose f32 squares
// (the plain version's `g.float().square()`) it adds in f64 in a fixed
// order and reduces in a fixed tree into one f64 partial; pass 2 has one
// block a leaf add that leaf's partials in a fixed tree and round the
// total to f32 once. The f64 sum keeps the result within one f32
// rounding of the exact sum of the squares.
//
// Nothing here sets a function attribute: both kernels use less than
// 48 KB of shared memory, so concurrent launches from several host
// threads (a mesh's ranks as threads) share nothing but the code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// Leaves one launch carries (the table rides in the 4 KB of kernel
// parameters; `kernels/adamw.py` launches a longer tree in groups).
constexpr int kMaxLeaves = 48;
// Threads of a block, and elements a thread moves per step of its loop.
constexpr int kThreads = 256;
constexpr int kVec = 8;

// flags of a leaf
constexpr int kGradBf16 = 1;
constexpr int kParamBf16 = 2;
constexpr int kAligned = 4;   // every address of the leaf 16-byte aligned

struct Leaf {
  const void* g;
  const void* p;
  const float* m;
  const float* v;
  void* p_out;
  float* m_out;
  float* v_out;
  long long n;       // elements
  int block0;        // the leaf's first block; its blocks run to the next's
  int flags;
};

struct UpdateDesc {
  Leaf leaf[kMaxLeaves];
  const float* scale;    // f32 scalars on the card
  const float* lr;       // null: lr_value
  const float* bc1;
  const float* bc2;
  float lr_value, b1, c1, b2, c2, eps, wd;   // c1 = 1 - b1, c2 = 1 - b2
  int n_leaves;
  int blocks;
  int pad;
};

struct SumLeaf {
  const void* g;
  long long n;
  int block0;
  int flags;
};

struct SumDesc {
  SumLeaf leaf[kMaxLeaves];
  double* partial;       // [blocks]
  float* out;            // [n_leaves]
  int n_leaves;
  int blocks;
};

// kernels/adamw.py packs the same bytes (`_UPDATE`, `_SUM`).
static_assert(sizeof(UpdateDesc) == 3528, "UpdateDesc changed: update _UPDATE");
static_assert(sizeof(SumDesc) == 1176, "SumDesc changed: update _SUM");

// The leaf block `b` belongs to: the last whose first block is <= b.
template <typename L>
__device__ __forceinline__ int leaf_of(const L* leaf, int n_leaves, int b) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaf[mid].block0 <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// 8 elements from `base` at vector j (elements 8j .. 8j+7) as f32.
template <bool kBf16>
__device__ __forceinline__ void load8(const void* base, long long j,
                                      float (&x)[kVec]) {
  if constexpr (kBf16) {
    const uint4 raw = reinterpret_cast<const uint4*>(base)[j];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(base) + 2 * j;
    const float4 a = f[0], b = f[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

template <bool kBf16>
__device__ __forceinline__ void store8(void* base, long long j,
                                       const float (&x)[kVec]) {
  if constexpr (kBf16) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __halves2bfloat162(__float2bfloat16_rn(x[2 * k]),
                                __float2bfloat16_rn(x[2 * k + 1]));
    }
    reinterpret_cast<uint4*>(base)[j] = raw;
  } else {
    float4* f = reinterpret_cast<float4*>(base) + 2 * j;
    f[0] = make_float4(x[0], x[1], x[2], x[3]);
    f[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <bool kBf16>
__device__ __forceinline__ float load1(const void* base, long long i) {
  if constexpr (kBf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[i]);
  } else {
    return reinterpret_cast<const float*>(base)[i];
  }
}

template <bool kBf16>
__device__ __forceinline__ void store1(void* base, long long i, float x) {
  if constexpr (kBf16) {
    reinterpret_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  } else {
    reinterpret_cast<float*>(base)[i] = x;
  }
}

struct Scalars {
  float scale, lr, bc1, bc2, b1, c1, b2, c2, eps, wd;
};

// One element's step, operation for operation the plain version's
// (kernels/ref.py adamw_apply_ref), each rounded once.
__device__ __forceinline__ void adamw_element(float g, float& p, float& m,
                                              float& v, const Scalars& s) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.c1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, s.c2), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  u = __fadd_rn(u, __fmul_rn(p, s.wd));
  p = __fsub_rn(p, __fmul_rn(u, s.lr));
}

// Thread `t` of `threads` on one leaf: vectors t, t + threads, ...,
// then the ragged tail one element at a time.
template <bool kGBf16, bool kPBf16>
__device__ void update_leaf(const Leaf& L, long long t, long long threads,
                            const Scalars& s) {
  long long done = 0;
  if (L.flags & kAligned) {
    const long long nv = L.n / kVec;
    for (long long j = t; j < nv; j += threads) {
      float g[kVec], p[kVec], m[kVec], v[kVec];
      load8<kGBf16>(L.g, j, g);
      load8<kPBf16>(L.p, j, p);
      load8<false>(L.m, j, m);
      load8<false>(L.v, j, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adamw_element(g[k], p[k], m[k], v[k], s);
      store8<false>(L.m_out, j, m);
      store8<false>(L.v_out, j, v);
      store8<kPBf16>(L.p_out, j, p);
    }
    done = nv * kVec;
  }
  for (long long i = done + t; i < L.n; i += threads) {
    float p = load1<kPBf16>(L.p, i), m = L.m[i], v = L.v[i];
    adamw_element(load1<kGBf16>(L.g, i), p, m, v, s);
    L.m_out[i] = m;
    L.v_out[i] = v;
    store1<kPBf16>(L.p_out, i, p);
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_apply_kernel(const __grid_constant__ UpdateDesc d) {
  const int l = leaf_of(d.leaf, d.n_leaves, blockIdx.x);
  const Leaf& L = d.leaf[l];
  const int end = l + 1 < d.n_leaves ? d.leaf[l + 1].block0 : d.blocks;
  const long long t = (long long)(blockIdx.x - L.block0) * kThreads +
                      threadIdx.x;
  const long long threads = (long long)(end - L.block0) * kThreads;
  const Scalars s{*d.scale, d.lr ? *d.lr : d.lr_value, *d.bc1, *d.bc2,
                  d.b1, d.c1, d.b2, d.c2, d.eps, d.wd};
  switch (L.flags & (kGradBf16 | kParamBf16)) {
    case 0: update_leaf<false, false>(L, t, threads, s); break;
    case kGradBf16: update_leaf<true, false>(L, t, threads, s); break;
    case kParamBf16: update_leaf<false, true>(L, t, threads, s); break;
    default: update_leaf<true, true>(L, t, threads, s); break;
  }
}

// This thread's f64 sum of the f32 squares of its elements of one leaf,
// in a fixed order.
template <bool kBf16>
__device__ double sumsq_leaf(const SumLeaf& L, long long t,
                             long long threads) {
  double acc = 0.0;
  long long done = 0;
  if (L.flags & kAligned) {
    const long long nv = L.n / kVec;
    for (long long j = t; j < nv; j += threads) {
      float g[kVec];
      load8<kBf16>(L.g, j, g);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc += (double)__fmul_rn(g[k], g[k]);
    }
    done = nv * kVec;
  }
  for (long long i = done + t; i < L.n; i += threads) {
    const float g = load1<kBf16>(L.g, i);
    acc += (double)__fmul_rn(g, g);
  }
  return acc;
}

// The block's sum of each thread's `x`, in a fixed tree: lanes within a
// warp, then the warps' sums by warp 0. Valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sum[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

// Pass 1: one f64 partial a block.
__global__ void __launch_bounds__(kThreads)
grad_sumsq_partial(const __grid_constant__ SumDesc d) {
  const int l = leaf_of(d.leaf, d.n_leaves, blockIdx.x);
  const SumLeaf& L = d.leaf[l];
  const int end = l + 1 < d.n_leaves ? d.leaf[l + 1].block0 : d.blocks;
  const long long t = (long long)(blockIdx.x - L.block0) * kThreads +
                      threadIdx.x;
  const long long threads = (long long)(end - L.block0) * kThreads;
  const double x = (L.flags & kGradBf16) ? sumsq_leaf<true>(L, t, threads)
                                         : sumsq_leaf<false>(L, t, threads);
  const double total = block_sum(x);
  if (threadIdx.x == 0) d.partial[blockIdx.x] = total;
}

// Pass 2: block l adds leaf l's partials and rounds the total to f32.
__global__ void __launch_bounds__(kThreads)
grad_sumsq_final(const __grid_constant__ SumDesc d) {
  const int l = blockIdx.x;
  const int first = d.leaf[l].block0;
  const int end = l + 1 < d.n_leaves ? d.leaf[l + 1].block0 : d.blocks;
  double x = 0.0;
  for (int b = first + threadIdx.x; b < end; b += kThreads) x += d.partial[b];
  const double total = block_sum(x);
  if (threadIdx.x == 0) d.out[l] = __double2float_rn(total);
}

// A table's leaves in ascending first blocks, each with at least one
// block, all within the grid.
template <typename D>
bool valid_table(const D& d) {
  if (d.n_leaves < 1 || d.n_leaves > kMaxLeaves || d.blocks < d.n_leaves) {
    return false;
  }
  for (int l = 0; l < d.n_leaves; ++l) {
    const int end = l + 1 < d.n_leaves ? d.leaf[l + 1].block0 : d.blocks;
    if (d.leaf[l].n < 0 || d.leaf[l].block0 < 0 || end <= d.leaf[l].block0) {
      return false;
    }
  }
  return d.leaf[0].block0 == 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes). `desc` points at an
// UpdateDesc or a SumDesc as kernels/adamw.py packs it: per leaf its
// pointers (contiguous tensors; the outputs may be the inputs), its
// element count, its first block and its flags (bf16 gradient, bf16
// parameter, every address 16-byte aligned); then the scalars. Each
// launches on `stream` and returns a cudaError_t.
extern "C" int adamw_apply_launch(const void* desc, void* stream) {
  UpdateDesc d;
  memcpy(&d, desc, sizeof(UpdateDesc));
  if (!valid_table(d) || !d.scale || !d.bc1 || !d.bc2) {
    return (int)cudaErrorInvalidValue;
  }
  adamw_apply_kernel<<<d.blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(d);
  return (int)cudaGetLastError();
}

extern "C" int grad_sumsq_launch(const void* desc, void* stream) {
  SumDesc d;
  memcpy(&d, desc, sizeof(SumDesc));
  if (!valid_table(d) || !d.partial || !d.out) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  grad_sumsq_partial<<<d.blocks, kThreads, 0, st>>>(d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grad_sumsq_final<<<d.n_leaves, kThreads, 0, st>>>(d);
  return (int)cudaGetLastError();
}
