// Row copy between two KV pools, for Hopper (sm_90a): dst[dst_index[r]]
// = src[src_index[r]] for every row r, where a row is a fixed number of
// contiguous bytes (a whole page [T, KH, HD], or one token [KH, HD]).
//
// Not a port of a TPU kernel: the reference moves pages with XLA
// scatters and gathers (src/repro/kvcache/migrate.py:106 stage_plan and
// :136 commit_staged, and the token writes of kvcache/paged.py). On the
// card the host tier of overlap mode lives in pinned host memory, and
// this kernel is the one way the port moves pages and tokens between
// it and the card from device-resident index lists without a host sync
// per step: PyTorch indexing cannot address a CPU tensor with CUDA
// indices, and `Tensor.copy_` needs the rows on the host. Inline mode,
// with both tiers on the card, moves its pages and tokens through it
// too, so the port has one route for every pool write and gather.
//
// Each side is a base address (device memory, or pinned host memory
// through the device address `cudaHostGetDevicePointer` gives), up to
// four leading index dims with byte strides and bounds, and per dim an
// int32 index per row (or none: the row number itself). A row with an
// index outside [0, bound) on either side is skipped — the reference's
// `mode="drop"` for its out-of-bounds sentinel rows.
//
// What bounds it: bytes. Between the card and pinned host memory the
// link (PCIe Gen5 x16, ~50 GB/s a direction) is the limit; device to
// device, HBM. The design keeps many 16-byte loads in flight to cover
// the link's microseconds of latency: a 2-D grid of (row part, row),
// 256 threads, each loading kUnroll 16-byte vectors before it stores
// any; no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // 16-byte vectors per thread

struct Side {
  const char* base;
  long long stride[4];   // bytes per index step of each dim
  int size[4];           // bound of each index
  const int* idx[4];     // per-row index of each dim; null: the row
  int ndim;
};

// Byte offset of row r on one side; false when an index is out of range.
// (Unrolled, so the arrays stay in the parameter space, not on a stack.)
__device__ inline bool row_offset(const Side& s, int r, long long* off) {
  long long o = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d < s.ndim) {
      const int i = s.idx[d] ? s.idx[d][r] : r;
      if (i < 0 || i >= s.size[d]) return false;
      o += (long long)i * s.stride[d];
    }
  }
  *off = o;
  return true;
}

__global__ void __launch_bounds__(kThreads)
page_copy_kernel(Side dst, Side src, int rows, long long n16) {
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    long long so, dofs;
    if (!row_offset(src, r, &so) || !row_offset(dst, r, &dofs)) continue;
    const uint4* sp = reinterpret_cast<const uint4*>(src.base + so);
    uint4* dp = reinterpret_cast<uint4*>(const_cast<char*>(dst.base) + dofs);
    const long long c0 =
        (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + (long long)u * kThreads;
      if (c < n16) v[u] = sp[c];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + (long long)u * kThreads;
      if (c < n16) dp[c] = v[u];
    }
  }
}

bool make_side(Side* s, const void* base, int ndim, const int* const* idx,
               const int* size, const long long* stride) {
  if (ndim < 1 || ndim > 4) return false;
  s->base = static_cast<const char*>(base);
  s->ndim = ndim;
  for (int d = 0; d < 4; ++d) {
    s->idx[d] = d < ndim ? idx[d] : nullptr;
    s->size[d] = d < ndim ? size[d] : 1;
    s->stride[d] = d < ndim ? stride[d] : 0;
  }
  return true;
}

}  // namespace

// Plain C entry point (loaded with ctypes). For each side (dst, then
// src): its device address (for pinned host memory, the one
// `mapped_address` of csrc/host_memory.cu gives), its number of index
// dims (1..4), and per dim the int32 index list (null: the row
// number), the bound and the byte stride. rows: the number of rows;
// row_bytes: the bytes of one row, a multiple of 16, as every stride
// and both addresses are. Launches on `stream` and returns a
// cudaError_t.
extern "C" int page_copy_launch(
    void* dst, int dst_ndim, const int* di0, const int* di1,
    const int* di2, const int* di3, int dn0, int dn1, int dn2, int dn3,
    long long ds0, long long ds1, long long ds2, long long ds3,
    const void* src, int src_ndim, const int* si0,
    const int* si1, const int* si2, const int* si3, int sn0, int sn1,
    int sn2, int sn3, long long ss0, long long ss1, long long ss2,
    long long ss3, int rows, long long row_bytes, void* stream) {
  if (rows < 0 || row_bytes <= 0 || row_bytes % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  Side d, s;
  const int* di[4] = {di0, di1, di2, di3};
  const int dn[4] = {dn0, dn1, dn2, dn3};
  const long long ds[4] = {ds0, ds1, ds2, ds3};
  const int* si[4] = {si0, si1, si2, si3};
  const int sn[4] = {sn0, sn1, sn2, sn3};
  const long long ss[4] = {ss0, ss1, ss2, ss3};
  if (!make_side(&d, dst, dst_ndim, di, dn, ds) ||
      !make_side(&s, src, src_ndim, si, sn, ss)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n16 = row_bytes / 16;
  const long long per_cta = (long long)kThreads * kUnroll;
  dim3 grid((unsigned)((n16 + per_cta - 1) / per_cta),
            (unsigned)(rows < 65535 ? rows : 65535));
  page_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, s, rows, n16);
  return (int)cudaGetLastError();
}
