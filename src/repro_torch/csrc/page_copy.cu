// Row copies between KV pools, for Hopper (sm_90a): for each of up to
// four (dst, src) pairs and every row r, dst[dst_index(r)] =
// src[src_index(r)], where a row is a fixed number of contiguous bytes
// (a whole page [T, KH, HD], or one token [KH, HD]).
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
// Each side of a pair is one pool or two (a base address — device
// memory, or pinned host memory through the device address
// `cudaHostGetDevicePointer` gives — with up to four leading index dims,
// their byte strides and bounds), and per dim an int32 index per row
// (or none: the row number itself). Two pools split on one index dim
// form the reference's slot space: an index below `split_at` addresses
// pool 0, an index from `split_at` on addresses pool 1 at index -
// split_at (HBM slots, then host slots). A row with an index out of
// range on either side is skipped — the reference's `mode="drop"` for
// its out-of-bounds sentinel rows — and so is a row whose `keep` byte
// is 0. One launch carries a call site's whole move: a decode token
// write is K and V into both tiers with `active` as `keep`; a commit is
// four page lists.
//
// What bounds it: bytes. Between the card and pinned host memory the
// link (PCIe Gen5 x16, 64 GB/s a direction before encoding) is the
// limit; device to device, HBM. On an NVIDIA H100 80GB HBM3 (700 W) one
// large `copy_` by the copy engine crosses the link at 49-55 GB/s each
// way, but every in-kernel read of pinned memory tried — 16-byte SM
// loads with 4-16 in flight a thread, with or without .nc and .L2::256B
// hints, and Hopper's bulk copies of 4-32 KB chunks from 132 to 528
// CTAs — reads it at 25-34 GB/s, in plan order or in address order
// (scripts/kernel_variants.py --copy; PERF.md §6): the cap lies in the
// card's path to host memory, not in the SMs. Writes into pinned
// memory reach the copy engine's rate either way (~52 GB/s). The
// design built here (kDesign = 1) moves rows with the bulk-copy engine:
// persistent CTAs of one warp (kCtasPerSm a SM) walk the (row, pair,
// chunk) items; the warp resolves 32 items' addresses at once, and one
// elected thread issues `cp.async.bulk` global -> shared for a chunk of
// up to kChunk bytes (a whole 32 KB page) into a kStages-deep ring
// (completion on an mbarrier) and `cp.async.bulk` shared -> global for
// the chunk that arrived, so kStages - 1 reads are in flight a CTA
// while one chunk is written. It reads the link as fast as any design
// tried, moves pages on the card and token rows as fast, and holds
// three warps and 24 registers an SM where the vector design fills the
// card, which leaves the SMs to the decode a commit on a side stream
// runs beside. kDesign = 0 is the earlier design (a 2-D grid of (row
// part, item), kThreads threads each loading kUnroll 16-byte vectors
// before it stores any), kept as a variant that
// `scripts/kernel_variants.py --copy` builds and times beside it; a
// library is built with one design, and nothing switches between them
// at run time.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

// The design this library is built with: 1 bulk copies through a shared
// ring, 0 16-byte vector loads and stores.
constexpr int kDesign = 1;
// Design 1: bytes of one bulk copy (a ring stage), ring depth, and
// persistent one-warp CTAs per SM.
constexpr int kChunk = 32768;
constexpr int kStages = 2;
constexpr int kCtasPerSm = 3;
// Design 0: threads of a CTA, 16-byte vectors per thread, and the load:
// 0 plain, 1 ld.global.nc.L1::no_allocate, 2 the same with an L2 fetch
// of 256 bytes (.L2::256B), 3 a plain load with .L2::256B.
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kLoad = 0;

constexpr int kMaxPairs = 4;

struct Layout {          // one pool
  const char* base;
  long long stride[4];   // bytes per index step of each dim
  int size[4];           // bound of each index
};

struct Side {
  Layout pool[2];        // pool[1]: only where split_dim >= 0
  const int* idx[4];     // per-row index of each dim; null: the row
  int ndim;
  int split_dim;         // the dim split between the pools, or -1
  int split_at;
  int pad;
};

struct Pair {
  Side dst, src;
};

struct Desc {
  Pair pair[kMaxPairs];
  const unsigned char* keep;   // bool [rows], or null: every row
  int npairs;
  int rows;
  long long row_bytes;
};

// kernels/page_copy.py packs the same bytes (`_DESC`).
static_assert(sizeof(Desc) == 1304, "Desc layout changed: update _DESC");

// The address of row r on one side, or null when an index is out of
// range. (Unrolled, so nothing is indexed by a run-time dim.)
__device__ inline char* row_address(const Side& s, int r) {
  int ix[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    ix[d] = d < s.ndim ? (s.idx[d] ? __ldg(s.idx[d] + r) : r) : 0;
  }
  int which = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d == s.split_dim && ix[d] >= s.split_at) {
      which = 1;
      ix[d] -= s.split_at;
    }
  }
  const Layout& p = which ? s.pool[1] : s.pool[0];
  long long o = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d < s.ndim) {
      if (ix[d] < 0 || ix[d] >= p.size[d]) return nullptr;
      o += (long long)ix[d] * p.stride[d];
    }
  }
  return const_cast<char*>(p.base) + o;
}

// ---------------------------------------------------------------------
// Design 0: 16-byte vector loads, then stores
// ---------------------------------------------------------------------

__device__ inline uint4 load16(const uint4* p) {
  uint4 v;
  if constexpr (kLoad == 1) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  } else if constexpr (kLoad == 2) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  } else if constexpr (kLoad == 3) {
    asm volatile("ld.global.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
  } else {
    v = *p;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
page_copy_vector(const __grid_constant__ Desc d, long long n16) {
  const long long items = (long long)d.rows * d.npairs;
  for (long long it = blockIdx.y; it < items; it += gridDim.y) {
    const int r = (int)(it / d.npairs);
    const Pair& pr = d.pair[it - (long long)r * d.npairs];
    if (d.keep && !d.keep[r]) continue;
    const char* s = row_address(pr.src, r);
    char* t = row_address(pr.dst, r);
    if (!s || !t) continue;
    const uint4* sp = reinterpret_cast<const uint4*>(s);
    uint4* dp = reinterpret_cast<uint4*>(t);
    const long long c0 =
        (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + (long long)u * kThreads;
      if (c < n16) v[u] = load16(sp + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + (long long)u * kThreads;
      if (c < n16) dp[c] = v[u];
    }
  }
}

// ---------------------------------------------------------------------
// Design 1: Hopper's bulk-copy engine through a shared-memory ring
// ---------------------------------------------------------------------

__device__ inline void bulk_load(uint32_t dst, const void* src,
                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ inline void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          __cvta_generic_to_global(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ inline void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most the newest group's store still reads shared memory.
__device__ inline void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ inline void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
page_copy_bulk(const __grid_constant__ Desc d, int chunks, long long items) {
  extern __shared__ __align__(128) unsigned char ring[];  // kStages chunks
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ char* dst_of[kStages];
  __shared__ uint32_t bytes_of[kStages];
  const int lane = threadIdx.x;
  const uint32_t ring0 = smem_u32(ring);
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // Item k of this CTA (its k-th valid chunk) uses stage k % kStages for
  // the (k / kStages)-th time. `loaded` chunks have been asked for,
  // `stored` written out: the store of chunk `stored` waits for its
  // read, and a load reuses a stage only after the store that emptied
  // it has read it (at most one newer store may still be reading).
  int loaded = 0, stored = 0;
  auto store_next = [&]() {
    const int st = stored % kStages;
    mbar_wait(smem_u32(&full[st]), (stored / kStages) & 1);
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_store(dst_of[st], ring0 + st * kChunk, bytes_of[st]);
      bulk_commit();
    }
    ++stored;
  };
  const long long step = gridDim.x;
  const long long per_row = (long long)d.npairs * chunks;
  for (long long base = blockIdx.x; base < items; base += 32 * step) {
    // lane j resolves item base + j * step
    const long long it = base + lane * step;
    const char* src = nullptr;
    char* dst = nullptr;
    uint32_t n = 0;
    if (it < items) {
      const int r = (int)(it / per_row);
      const int rem = (int)(it - (long long)r * per_row);
      const int p = rem / chunks;
      const long long off = (long long)(rem - p * chunks) * kChunk;
      if (!d.keep || d.keep[r]) {
        src = row_address(d.pair[p].src, r);
        dst = row_address(d.pair[p].dst, r);
        if (src && dst) {
          n = (uint32_t)min((long long)kChunk, d.row_bytes - off);
          src += off;
          dst += off;
        }
      }
    }
    unsigned todo = __ballot_sync(~0u, n != 0);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const char* s = reinterpret_cast<const char*>(__shfl_sync(
          ~0u, reinterpret_cast<unsigned long long>(src), j));
      char* t = reinterpret_cast<char*>(__shfl_sync(
          ~0u, reinterpret_cast<unsigned long long>(dst), j));
      const uint32_t bytes = __shfl_sync(~0u, n, j);
      if (loaded - stored == kStages - 1) store_next();
      const int st = loaded % kStages;
      if (lane == 0) {
        bulk_wait_read_1();
        dst_of[st] = t;
        bytes_of[st] = bytes;
        mbar_expect_tx(smem_u32(&full[st]), bytes);
        bulk_load(ring0 + st * kChunk, s, bytes, smem_u32(&full[st]));
      }
      ++loaded;
    }
  }
  while (stored < loaded) store_next();
  if (lane == 0) bulk_wait_all();
}

bool valid_side(const Side& s) {
  if (s.ndim < 1 || s.ndim > 4) return false;
  if (s.split_dim < -1 || s.split_dim >= s.ndim) return false;
  return s.split_dim < 0 || s.split_at >= 0;
}

int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!count[dev]) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev];
}

}  // namespace

// Plain C entry point (loaded with ctypes). `desc` points at a Desc as
// kernels/page_copy.py packs it: per pair (dst, then src) each side's
// pools (for pinned host memory, the address `mapped_address` of
// csrc/host_memory.cu gives), index pointers, dims and split; the
// optional keep mask; the pair and row counts; the bytes of one row, a
// multiple of 16, as every stride and address are. Launches on
// `stream` and returns a cudaError_t.
extern "C" int page_copy_launch(const void* desc, void* stream) {
  Desc d;
  memcpy(&d, desc, sizeof(Desc));
  if (d.npairs < 1 || d.npairs > kMaxPairs || d.rows < 0 ||
      d.row_bytes <= 0 || d.row_bytes % 16) {
    return (int)cudaErrorInvalidValue;
  }
  for (int p = 0; p < d.npairs; ++p) {
    if (!valid_side(d.pair[p].dst) || !valid_side(d.pair[p].src)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (d.rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kDesign == 1) {
    constexpr int smem = kStages * kChunk;
    static bool attributed = false;
    if (!attributed) {
      const cudaError_t e = cudaFuncSetAttribute(
          page_copy_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      attributed = true;
    }
    const int chunks = (int)((d.row_bytes + kChunk - 1) / kChunk);
    const long long items = (long long)d.rows * d.npairs * chunks;
    const long long ctas = (long long)sm_count() * kCtasPerSm;
    const unsigned grid = (unsigned)(items < ctas ? items : ctas);
    page_copy_bulk<<<grid ? grid : 1, 32, smem, st>>>(d, chunks, items);
  } else {
    const long long n16 = d.row_bytes / 16;
    const long long per_cta = (long long)kThreads * kUnroll;
    const long long items = (long long)d.rows * d.npairs;
    dim3 grid((unsigned)((n16 + per_cta - 1) / per_cta),
              (unsigned)(items < 65535 ? items : 65535));
    page_copy_vector<<<grid, kThreads, 0, st>>>(d, n16);
  }
  return (int)cudaGetLastError();
}
