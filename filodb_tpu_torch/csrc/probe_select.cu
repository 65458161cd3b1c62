// The column-selection probe (K8) for NVIDIA Hopper (sm_90a): the three
// strategies tools/probe_slice.py times for the fused kernel's window
// boundary selections, over x [rows, K] f32 with W selected columns out
// of WP output columns.
//
// Replaces: tools/probe_slice.py::run (:96, pallas_call at :98) over the
// bodies k_dyngather (:41) and k_tiled_gather (:75) -> probe_gather,
// k_two_gathers (:48) and k_tiled_two (:81) -> probe_two_gathers, and
// k_matmul (:89) -> probe_onehot_matmul.
//
// What each computes, for w < W (and 0 in the padding columns w >= W):
//   probe_gather:        y[r, w] = x[r, idx1[w]]
//   probe_two_gathers:   y[r, w] = x[r, idx2[w]] - x[r, idx1[w]]
//   probe_onehot_matmul: y = x @ onehot  ([K, N] f32, every column)
// The TPU kernels needed a tiled form because Mosaic could not lower a
// gather across vreg boundaries (:60-62); on the card the direct and the
// tiled form are the same indexed load, so one kernel serves both.
//
// Bound on the H100: bytes, for all three.  The gathers: selections 6
// slots apart touch every 32-byte sector of a row's selected span (83
// sectors, 2,656 B a row at the probe's shape) and write 512 B a row.  The
// product has to read every byte of x, because a non-finite x[r, k] makes
// x[r, k] * 0 NaN in each column that does not select k, and write y once:
// 4 x (rows x K + K x N + rows x N) = 939,917,312 B at 262,144 x 768 x
// 128, 0.2806 ms at 3.35 TB/s.  The operations it needs are 2 x rows x
// nnz(o), 57.7 MFLOP for the probe's 110 nonzeros (0.001 ms at 67 TFLOP/s),
// not a dense product's 2 x rows x K x N = 51.5 GFLOP, 99.9% of which
// multiply by zero.
//
// Design.  The gathers run one thread per output cell, neighbouring
// threads on neighbouring windows of one row, so a warp's loads fall in
// 24 consecutive sectors.  The product is column-sparse, in two launches:
// 1. column_lists, one block a column of o: its nonzero entries (NaN and
//    +-Inf count, +-0 does not) in ascending k, as [K, N] planes of index
//    and value (entry e of column j at e * N + j) and a count a column;
//    it reads o once, 393 KB at the probe's shape.
// 2. sparse_product, a persistent grid of one 256-thread block an SM: the
//    block streams x through shared memory in tiles of up to 16 whole rows
//    (48 KB at K = 768), each tile one cp.async.bulk copy into a ring of 4
//    stages that completes on the stage's mbarrier; thread 0 expects the
//    bytes of the rows the tile really has (the last tile may be short) and
//    issues the copy, every thread waits on the barrier with the parity of
//    its round (i / 4) & 1, and a __syncthreads after the tile frees the
//    stage for tile i + 4.  Each block first copies every column's count
//    and first 4 entries into shared memory; longer lists are read from L2.
//    One warp a row: (a) its lanes scan the staged row for a non-finite
//    value (16-byte reads, one vote); (b) lane l sums columns l, l + 32,
//    ...: acc = fma(x[k], v, acc) from +0.0f over the column's list in
//    ascending k, and a warp's 32 stores fill 128 contiguous bytes of y;
//    (c) a row with a non-finite value takes the full chain over all K
//    in ascending k, with o read from L2.  Each sum is stored plus +0.0f,
//    which turns -0 into +0 and leaves every other value as it is.  No
//    atomics: one thread writes each cell, so two runs give the same bits.
// Why the sparse sum has the dense product's bits: for a finite x, x * 0
// is +-0, and adding +-0 leaves a non-zero sum as it is and can turn a zero
// sum from -0 into +0 only, never back.  So the sparse and the full chain
// in ascending k differ at most where the sparse sum is -0 (an underflow
// to zero), and + 0.0f makes both +0, as the reference's jnp.dot (interpret
// mode on the CPU) and torch.matmul on the card give there; a non-finite x
// makes x * 0 NaN, and its row takes the full chain.  Where a column's sum
// does not depend on the order (one nonzero, or +1 and -1, as in every
// input of the probe) that is the bits of torch.matmul (FP32, TF32 off).
// The library is built with --fmad=false, so each fused multiply-add is
// written out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_cells(const float* __restrict__ x, long long rows,
                             long long stride, const int* __restrict__ idx1,
                             const int* __restrict__ idx2, int W, int WP,
                             int two, float* __restrict__ y) {
  const long long cells = rows * WP;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < cells; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / WP;
    const int w = (int)(t - r * WP);
    float v = 0.0f;
    if (w < W) {
      const float* row = x + r * stride;
      v = __ldg(row + __ldg(idx1 + w));
      if (two) v = __ldg(row + __ldg(idx2 + w)) - v;
    }
    y[t] = v;
  }
}

// ------------------------------------------------ the column-sparse product

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;            // row tiles in flight a block
constexpr int kMaxTileRows = 16;      // rows of x a tile
constexpr int kListCap = 4;           // list entries a column keeps in smem
constexpr long long kListSmemMax = 32 * 1024;
constexpr long long kMaxSmem = 232448;  // bytes a block may use on sm_90
// What the launcher returns when one row of x does not fit the ring (CUDA's
// error codes are never negative); the wrapper raises ValueError for it.
constexpr int kNoFit = -1;

// Column lists: for column j of o [K, N], its nonzero entries (NaN and
// +-Inf included; +-0 is zero) in ascending k, entry e at lk/lv[e * N + j],
// and their count cnt[j].  One block a column.
__global__ void __launch_bounds__(kThreads)
    column_lists(const float* __restrict__ o, int K, int N,
                 int* __restrict__ lk, float* __restrict__ lv,
                 int* __restrict__ cnt) {
  __shared__ int warp_nnz[kWarps];
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int k0 = 0; k0 < K; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    const float v = k < K ? __ldg(o + (long long)k * N + j) : 0.0f;
    const bool nz = !(v == 0.0f);
    const unsigned m = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) warp_nnz[warp] = __popc(m);
    __syncthreads();
    int at = base, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_nnz[w] : 0;
      total += warp_nnz[w];
    }
    if (nz) {
      const long long e = at + __popc(m & ((1u << lane) - 1u));
      lk[e * N + j] = k;
      lv[e * N + j] = v;
    }
    base += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) cnt[j] = base;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One thread: expect `bytes` on the stage's barrier, then copy them there
// from global memory with one bulk copy that completes on that barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// The full chain over all K in ascending k, o read from L2: the exact
// path for a row holding a non-finite value.
__device__ __forceinline__ float full_chain(const float* xr, int K,
                                            const float* __restrict__ o,
                                            int N, int j) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = __fmaf_rn(xr[k], __ldg(o + (long long)k * N + j), acc);
  }
  return acc;
}

// y [rows, N] = x [rows, K] @ o [K, N] from o's column lists (see the note
// at the top).  Persistent: block b takes row tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 1)
    sparse_product(const float* __restrict__ x, long long rows, int K,
                   const float* __restrict__ o, int N,
                   const int* __restrict__ lk, const float* __restrict__ lv,
                   const int* __restrict__ cnt, int cap, int tile_rows,
                   float* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long tile_floats = (long long)tile_rows * K;
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * tile_floats);
  int* s_cnt = reinterpret_cast<int*>(full + kStages);  // [N] when cap > 0
  int* s_k = s_cnt + N;                                 // [cap, N]
  float* s_v = reinterpret_cast<float*>(s_k + (long long)cap * N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const long long mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  auto issue = [&](long long i) {  // local tile i into stage i % kStages
    const long long row0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const long long n = rows - row0 < tile_rows ? rows - row0 : tile_rows;
    bulk_load(ring + (i % kStages) * tile_floats, x + row0 * K,
              (unsigned)(n * K * 4), &full[i % kStages]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long i = 0; i < kStages && i < mine; ++i) issue(i);
  }
  if (cap) {
    for (int i = tid; i < N; i += kThreads) s_cnt[i] = __ldg(cnt + i);
    for (long long i = tid; i < (long long)cap * N; i += kThreads) {
      s_k[i] = __ldg(lk + i);
      s_v[i] = __ldg(lv + i);
    }
  }
  __syncthreads();

  for (long long i = 0; i < mine; ++i) {
    const long long row0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const int nr = (int)(rows - row0 < tile_rows ? rows - row0 : tile_rows);
    bar_wait(&full[i % kStages], (unsigned)((i / kStages) & 1));
    const float* tile = ring + (i % kStages) * tile_floats;
    for (int rr = warp; rr < nr; rr += kWarps) {
      const float* xr = tile + (long long)rr * K;
      // (a) does the row hold a non-finite value?
      bool bad = false;
      for (int k = lane * 4; k < K; k += 128) {
        const float4 v = *reinterpret_cast<const float4*>(xr + k);
        bad |= nonfinite(v.x) | nonfinite(v.y) | nonfinite(v.z) |
               nonfinite(v.w);
      }
      bad = __any_sync(0xffffffffu, bad);
      float* yr = y + (row0 + rr) * N;
      for (int j = lane; j < N; j += 32) {
        float acc = 0.0f;
        if (!bad) {
          // (b) the column's list, the first cap entries from smem
          const int c = cap ? s_cnt[j] : __ldg(cnt + j);
          int e = 0;
          for (; e < c && e < cap; ++e) {
            acc = __fmaf_rn(xr[s_k[e * N + j]], s_v[e * N + j], acc);
          }
          for (; e < c; ++e) {
            const long long at = (long long)e * N + j;
            acc = __fmaf_rn(xr[__ldg(lk + at)], __ldg(lv + at), acc);
          }
        }
        // (c) the exact slow path for a row holding a non-finite value
        if (bad) acc = full_chain(xr, K, o, N, j);
        yr[j] = __fadd_rn(acc, 0.0f);  // -0 becomes +0
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && i + kStages < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + kStages);
    }
  }
}

unsigned gather_blocks(long long cells) {
  const long long b = (cells + 255) / 256;
  return (unsigned)(b < 1048576 ? (b > 0 ? b : 1) : 1048576);
}

}  // namespace

extern "C" {

// probe_gather: y [rows, WP] f32 from x [rows, stride] f32 and idx1 [W]
// int32 column indices.  Returns cudaGetLastError().
int probe_gather_launch(const float* x, long long rows, long long stride,
                        const int* idx1, int W, int WP, float* y,
                        void* stream) {
  if (rows * WP == 0) return 0;
  gather_cells<<<gather_blocks(rows * WP), 256, 0, (cudaStream_t)stream>>>(
      x, rows, stride, idx1, idx1, W, WP, 0, y);
  return (int)cudaGetLastError();
}

// probe_two_gathers: y = x[:, idx2] - x[:, idx1] in the first W columns.
int probe_two_gathers_launch(const float* x, long long rows, long long stride,
                             const int* idx1, const int* idx2, int W, int WP,
                             float* y, void* stream) {
  if (rows * WP == 0) return 0;
  gather_cells<<<gather_blocks(rows * WP), 256, 0, (cudaStream_t)stream>>>(
      x, rows, stride, idx1, idx2, W, WP, 1, y);
  return (int)cudaGetLastError();
}

// probe_onehot_matmul: y [rows, N] = x [rows, K] @ o [K, N], all f32
// row-major, x contiguous; K and N multiples of 4, x and o 16-byte aligned.
// lk, lv [K, N] and cnt [N] are scratch for o's column lists.  Returns
// cudaGetLastError(), or kNoFit (-1) when one row of x does not fit the
// ring of shared memory (K above about 14,000).
int probe_onehot_matmul_launch(const float* x, long long rows, int K,
                               const float* o, int N, int* lk, float* lv,
                               int* cnt, float* y, void* stream) {
  if (rows == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 0) return (int)cudaMemsetAsync(y, 0, rows * N * 4, st);
  int cap = kListCap;  // K is a multiple of 4, so at least kListCap
  long long list_bytes = (long long)N * (4 + 8LL * cap);
  if (list_bytes > kListSmemMax) cap = 0, list_bytes = 0;
  const long long fixed = 8LL * kStages + list_bytes;
  long long tile_rows = (kMaxSmem - fixed) / (kStages * 4LL * K);
  if (tile_rows > kMaxTileRows) tile_rows = kMaxTileRows;
  if (tile_rows < 1) return kNoFit;
  const long long smem = kStages * tile_rows * K * 4 + fixed;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sparse_product,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  column_lists<<<N, kThreads, 0, st>>>(o, K, N, lk, lv, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  sparse_product<<<(unsigned)(tiles < sms ? tiles : sms), kThreads,
                   smem, st>>>(x, rows, K, o, N, lk, lv, cnt, cap,
                               (int)tile_rows, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
