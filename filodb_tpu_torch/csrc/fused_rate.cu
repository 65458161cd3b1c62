// Fused windowed rate + group sum over one shared scrape grid (K1 dense,
// K3 ragged) for NVIDIA Hopper (sm_90a).
//
// Replaces: filodb_tpu/ops/pallas_fused.py::_kernel, the rate-family
// branches with gather selections and no in-kernel drops — the dense
// gather branch (:595-609, _gather_cols :443) and the ragged branch
// (:544-593 without with_drops), each followed by the extrapolation
// (:626-646) and the _epilogue (:652) in both modes: group sums
// (:666-684) and per-series output (K6, :661-665).
//
// Bound on the H100: memory.  Per (series, window) the kernel reads two
// values (K1) or the window's slots (K3) and does ~30 f32 operations.
// The bytes are the part of each row the windows span: about S x 690
// x 4 B, 2.9 GB at 1,048,576 series x 720 samples with 5 m windows on a
// 1 m grid, so about 0.86 ms at 3.35 TB/s; the operations (~3.5 G f32)
// take about 0.05 ms at 67 TFLOP/s.
//
// K1 (dense_chunks, dense_series).  The group sum must give the same bits
// on every run, so there are no float atomics.  The wrapper hands a
// stable CSR order of rows by group (ascending row inside a group) cut
// into chunks of at most 256 rows.  One block per chunk, one thread per
// window (looping over windows when W exceeds the block); the thread
// walks the chunk's rows in order, reads the row's boundary slots
// straight from device memory (neighbouring threads read neighbouring
// windows of the same row, so a warp's loads fall in a few sectors of
// one row), computes the rate and adds it to its sum.  group_reduce then
// adds each group's chunk partials in chunk order.  Rows are unrolled by
// four so each thread keeps eight loads in flight before its ordered
// adds.  Per series: one thread per (series, window) cell.  What is left
// for later: one pass with no partials.
//
// K3 (rate_stage.cuh, shared with K2).  Each row is read once for all its
// windows: a block of 128 threads stages 4 rows at a time, one warp a
// row, with 16-byte cp.async copies of the slots the live windows span —
// from the smallest idx1 of a window of two or more slots, rounded down
// to 4, to the largest idx2 + 1, rounded up to 4 (the wrapper passes both;
// windows of fewer than two slots are absent and read nothing) — into a
// ring of two batches, the next batch's copies in flight while this one
// computes.  The warp indexes its row per 32-slot tile (valid mask, count
// before, last valid before, first valid after), so a window is O(1): nv
// = cnt(i2 + 1) - cnt(i1), j1 = nxt(i1), j2 = prv(i2) — the samples and
// count a slot-by-slot scan selects, as the plain version
// (ops/fused._ragged_rates) does.  Every thread then takes one window
// over the batch's rows (110 of 128 at the main path's W), with the
// window's rate terms for a row without NaN in it precomputed in
// registers (a row that moves j1 or j2, or has a hole inside, recomputes
// only those terms, with the same operations); in group mode it adds the
// rows' cells in row order (the chunk order K1 keeps), per series it
// stores out[r, w] and pres[r, w] side by side.  The grid's ts offsets of
// the staged range sit in shared memory.  Rows too long for shared memory
// are walked in slot tiles of 8,192 (or the widest window's) slots, each
// holding whole windows, with tables local to the tile, so K3 takes any
// row length; only a window wider than shared memory is refused (the
// launcher returns kNoFit, the wrapper raises ValueError).
// Built with --fmad=false: the plain versions compute the same operations
// unfused, so kernel and plain agree to the last bit.  72 registers, 7
// blocks an SM.  What is left for later: TMA bulk copies, and one pass
// with no partials.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "rate_common.cuh"
#include "rate_stage.cuh"

namespace {

__global__ void dense_chunks(const float* __restrict__ vals,
                             long long stride,
                             const float* __restrict__ vbase,
                             const int* __restrict__ order,
                             const int* __restrict__ chunk_lo,
                             const int* __restrict__ chunk_hi,
                             WindowRows wr, int W, int is_counter,
                             int is_rate, float* __restrict__ partial) {
  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int i1 = wr.idx1[w];
    const int i2 = wr.idx2[w];
    const float t1 = wr.t1[w], t2 = wr.t2[w], n = wr.n[w];
    const float ws = wr.ws[w], we = wr.we[w];
    float acc = 0.0f;
    int i = lo;
    for (; i + 4 <= hi; i += 4) {
      float a[4], b[4], vb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r = order[i + u];
        const float* row = vals + r * stride;
        a[u] = row[i1];
        b[u] = row[i2];
        vb[u] = vbase[r];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc += rate_one(a[u], b[u], t1, t2, n, ws, we, vb[u], is_counter,
                        is_rate);
      }
    }
    for (; i < hi; ++i) {
      const long long r = order[i];
      const float* row = vals + r * stride;
      acc += rate_one(row[i1], row[i2], t1, t2, n, ws, we, vbase[r],
                      is_counter, is_rate);
    }
    partial[(long long)c * W + w] = acc;
  }
}

// K6 over K1: out[r, w] for rows 0..num_rows-1
__global__ void dense_series(const float* __restrict__ vals,
                             long long stride,
                             const float* __restrict__ vbase,
                             long long num_rows, WindowRows wr, int W,
                             int is_counter, int is_rate,
                             float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_rows * W) return;
  const long long r = t / W;
  const int w = (int)(t - r * W);
  const float* row = vals + r * stride;
  out[t] = rate_one(row[wr.idx1[w]], row[wr.idx2[w]], wr.t1[w], wr.t2[w],
                    wr.n[w], wr.ws[w], wr.we[w], vbase[r], is_counter,
                    is_rate);
}

}  // namespace

extern "C" {

// K1.  vals [rows, stride] f32, vbase [rows] f32, order [N] int32 CSR
// rows, chunk_lo/chunk_hi [n_chunks] int32, gco [Gp + 1] int32, the
// window rows [W] (idx int32, the rest f32), partial [n_chunks, W] f32
// scratch, out [Gp, W] f32.  Returns cudaGetLastError().
int fused_rate_dense_launch(const float* vals, long long stride,
                            const float* vbase, const int* order,
                            const int* chunk_lo, const int* chunk_hi,
                            long long n_chunks, const int* gco, int Gp,
                            const int* idx1, const int* idx2,
                            const float* t1, const float* t2, const float* n,
                            const float* ws, const float* we, int W,
                            int is_counter, int is_rate, float* partial,
                            float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, nullptr};
  if (n_chunks > 0) {
    dense_chunks<<<(unsigned)n_chunks, block_for(W), 0, s>>>(
        vals, stride, vbase, order, chunk_lo, chunk_hi, wr, W, is_counter,
        is_rate, partial);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce(partial, n_chunks, gco, Gp, W, 1, out, s);
}

// K3.  As K1, plus tsrow [stride] f32 (the shared grid's ts offsets),
// vals 16-byte aligned with stride a multiple of 4, and the slots the
// windows of two or more slots span: lo (the smallest idx1, rounded down
// to 4), hi (the largest idx2 + 1, rounded up to 4, at most stride) and
// width (the most slots one such window spans); partial is [2, n_chunks,
// W] and out [2, Gp, W]: plane 0 the rate sums, plane 1 the presence
// counts (windows with at least two valid samples).  Returns
// cudaGetLastError(), or kNoFit (-1) when the widest window does not fit
// in shared memory.
int fused_rate_ragged_launch(const float* vals, long long stride,
                             const float* vbase, const int* order,
                             const int* chunk_lo, const int* chunk_hi,
                             long long n_chunks, const int* gco, int Gp,
                             const int* idx1, const int* idx2,
                             const float* ws, const float* we,
                             const float* tsrow, int W, int lo, int hi,
                             int width, int is_counter, int is_rate,
                             float* partial, float* out, void* stream) {
  WindowRows wr{idx1, idx2, nullptr, nullptr, nullptr, ws, we, tsrow};
  StagePlan p;
  if (!plan_ragged(lo, hi, width, &p)) {
    return kNoFit;
  }
  return launch_staged_chunks<false, true>(
      vals, stride, vbase, order, chunk_lo, chunk_hi, n_chunks, gco, Gp, wr,
      W, p, is_counter, is_rate, partial, out, (cudaStream_t)stream);
}

// K6 over K1.  out [num_rows, W] f32; the other operands as K1.
int fused_rate_dense_series_launch(const float* vals, long long stride,
                                   const float* vbase, long long num_rows,
                                   const int* idx1, const int* idx2,
                                   const float* t1, const float* t2,
                                   const float* n, const float* ws,
                                   const float* we, int W, int is_counter,
                                   int is_rate, float* out, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, nullptr};
  const long long cells = num_rows * W;
  if (cells == 0) return 0;
  dense_series<<<series_blocks(cells), 256, 0, (cudaStream_t)stream>>>(
      vals, stride, vbase, num_rows, wr, W, is_counter, is_rate, out);
  return (int)cudaGetLastError();
}

// K6 over K3.  out and pres [num_rows, W] f32; the other operands as K3.
int fused_rate_ragged_series_launch(const float* vals, long long stride,
                                    const float* vbase, long long num_rows,
                                    const int* idx1, const int* idx2,
                                    const float* ws, const float* we,
                                    const float* tsrow, int W, int lo,
                                    int hi, int width, int is_counter,
                                    int is_rate, float* out, float* pres,
                                    void* stream) {
  WindowRows wr{idx1, idx2, nullptr, nullptr, nullptr, ws, we, tsrow};
  StagePlan p;
  if (!plan_ragged(lo, hi, width, &p)) {
    return kNoFit;
  }
  return launch_staged_series<false, true>(vals, stride, vbase, num_rows, wr,
                                           W, p, is_counter, is_rate, out,
                                           pres, (cudaStream_t)stream);
}

}  // extern "C"
