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
// Bound on the H100.  The gathers are memory-bound: selections 6 slots
// apart touch every 32-byte sector of a row's selected span (83 sectors,
// 2,656 B a row at the probe's shape) and write 512 B a row.  The product
// is arithmetic-bound: 2 x rows x K x N FP32 operations (51.5 GFLOP at
// 262,144 x 768 x 128, 0.77 ms at 67 TFLOP/s) against 0.28 ms to read x.
//
// Design.  The gathers run one thread per output cell, neighbouring
// threads on neighbouring windows of one row, so a warp's loads fall in
// 24 consecutive sectors.  The product is a classic shared-memory SGEMM:
// 128 x 128 output tiles, 16-deep slabs of x and the one-hot matrix
// staged in shared memory with 16-byte loads, each of 256 threads
// accumulating an 8 x 8 micro-tile with explicit fused multiply-adds
// (the library is built with --fmad=false, so contraction must be asked
// for), FP32 throughout, no tensor cores.  With a one-hot matrix every
// output is one product x * 1 plus zeros, so any summation order gives
// the same bits as the plain version (torch.matmul with TF32 off).
// What is left for later: double-buffered slabs, and a product that
// skips the zero rows of the one-hot matrix.

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

constexpr int BM = 128;  // output rows of a tile
constexpr int BN = 128;  // output columns of a tile
constexpr int BK = 16;   // depth of a staged slab
constexpr int kThreads = 256;

// y [rows, N] = x [rows, K] @ o [K, N]; K and N multiples of 4, x and o
// 16-byte aligned (the launcher checks).  Thread (tr, tc) of the 16 x 16
// grid owns rows {tr*4 .. +3, 64 + tr*4 .. +3} and columns {tc*4 .. +3,
// 64 + tc*4 .. +3} of the tile, so its shared-memory reads are 16-byte
// and conflict-free.
__global__ void __launch_bounds__(kThreads)
    onehot_matmul(const float* __restrict__ x, long long rows, int K,
                  const float* __restrict__ o, int N, float* __restrict__ y) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slab: 128 rows x 16 columns as 512 float4, two a thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * kThreads;
      const int m = i / 4, kq = (i % 4) * 4;
      const long long r = row0 + m;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && k0 + kq < K) {
        v = __ldg(reinterpret_cast<const float4*>(x + r * K + k0 + kq));
      }
      As[kq + 0][m] = v.x;
      As[kq + 1][m] = v.y;
      As[kq + 2][m] = v.z;
      As[kq + 3][m] = v.w;
    }
    // one-hot slab: 16 rows x 128 columns as 512 float4, two a thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * kThreads;
      const int k = i / 32, nq = (i % 32) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + k < K && col0 + nq < N) {
        v = __ldg(reinterpret_cast<const float4*>(
            o + (long long)(k0 + k) * N + col0 + nq));
      }
      *reinterpret_cast<float4*>(&Bs[k][nq]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tr * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tc * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k][64 + tc * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + (i < 4 ? tr * 4 + i : 64 + tr * 4 + i - 4);
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tc * 4;
      if (c < N) {
        *reinterpret_cast<float4*>(y + r * N + c) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      }
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
// row-major; K and N multiples of 4, x and o 16-byte aligned.
int probe_onehot_matmul_launch(const float* x, long long rows, int K,
                               const float* o, int N, float* y,
                               void* stream) {
  if (rows == 0 || N == 0) return 0;
  const dim3 grid((unsigned)((rows + BM - 1) / BM), (N + BN - 1) / BN);
  onehot_matmul<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, rows, K, o,
                                                             N, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
