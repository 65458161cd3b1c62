// Fused windowed rate with in-kernel counter reset correction (K2) over
// one shared scrape grid, dense and ragged, in group-sum mode and in
// per-series mode (K6 over K2), for NVIDIA Hopper (sm_90a).
//
// Replaces: filodb_tpu/ops/pallas_fused.py::_kernel with with_drops=True
// — the dense gather form (:598-605), the dense matmul form (:613-623,
// where K7 adds d @ l1 and d @ l2) and the ragged form (:554-562) — each
// followed by the extrapolation (:626-646) and the _epilogue (:652) in
// group mode (:666-684) or per-series mode (:661-665).
//
// What it computes.  Per row, the drops d[j] = prev + vb where the sample
// v[j] is below the previous sample prev (ragged: the previous VALID
// sample, carried across NaN holes), else 0, with d = 0 where there is no
// previous sample; the corrected row c[j] = v[j] + (d[0] + ... + d[j]);
// then the rate family on c exactly as K1 (dense: c at the plan's
// idx1/idx2) or K3 (ragged: the first and last valid sample of c inside
// the window, presence when there are at least two).
//
// Bound on the H100: memory.  The correction at a window's first slot
// depends on every slot before it, so each row is read from slot 0 to the
// last window's last slot (`span`, 720 slots on the main path's grid):
// 3.0 GB at 1,048,576 series, 0.90 ms at 3.35 TB/s.  The operations are a
// compare, a select and an add per slot (three passes over the row in
// shared memory) plus the ~26 of the rate epilogue per window.
//
// Design (rate_stage.cuh).  A block of 128 threads stages 4 rows at a
// time, one warp a row, with 16-byte cp.async copies of slots [0,
// ceil4(span)) into a ring of two row batches, so the next batch's copies
// are in flight while this batch computes.  Each warp rewrites its row in
// place as the corrected row: lane l owns L = ceil(span / 32) slots, sums
// its drops in slot order from +0 (only the drops: adding a zero leaves
// the sum's bits), and the lanes' totals are prefixed in lane order by
// shuffles — the association the plain version ops/fused._drop_corrected
// repeats, so built with --fmad=false the two agree to the bit.  A
// ragged row is
// indexed first, per 32-slot tile (valid mask, count before, last valid
// before, first valid after; the correction leaves NaN slots NaN, so they
// are the corrected row's too): a lane's carry is then one table lookup,
// and each window three O(1) lookups instead of a scan of its ~31 slots.
// Every thread of the block then takes one window (110 of 128 at the main
// path's W) over the batch's rows, with the window's plan rows and the
// window part of its rate in registers, adding each row's cell into its
// sum in row order (group mode; group_reduce in fused_common.cuh adds each
// group's chunk partials in chunk order) or storing out[r, w] and pres[r,
// w], neighbouring threads on neighbouring windows (per series).  Matching
// the block to W measured faster than 256 threads filling a shared (row,
// window) tile; ptxas gives 64 registers dense (8 blocks an SM) and 80 for
// the ragged group kernel (6 an SM), per `-Xptxas -v` as chip_smoke.py
// prints it.  FP32 throughout, no tensor cores, no atomics.  Rows whose
// span does not fit stage fewer per block, then one per block with one
// stage; beyond one row of 58,112 slots dense (51,648 ragged, whose tile
// tables take 0.5 B a slot) the launcher returns kNoFit and the wrapper
// raises ValueError.  What is left
// for later: TMA bulk copies in place of cp.async, and the lanes' prefix
// (31 shuffles, the bit contract) overlapped with the window phase.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "rate_common.cuh"
#include "rate_stage.cuh"

namespace {

template <bool RAGGED>
int launch_chunks(const float* vals, long long stride, const float* vbase,
                  const int* order, const int* chunk_lo, const int* chunk_hi,
                  long long n_chunks, const int* gco, int Gp, WindowRows wr,
                  int W, int span, int is_counter, int is_rate,
                  float* partial, float* out, void* stream) {
  StagePlan p;
  if (!plan_drops(span, RAGGED, &p)) {
    return kNoFit;
  }
  return launch_staged_chunks<true, RAGGED>(
      vals, stride, vbase, order, chunk_lo, chunk_hi, n_chunks, gco, Gp, wr,
      W, p, is_counter, is_rate, partial, out, (cudaStream_t)stream);
}

template <bool RAGGED>
int launch_series(const float* vals, long long stride, const float* vbase,
                  long long num_rows, WindowRows wr, int W, int span,
                  int is_counter, int is_rate, float* out, float* pres,
                  void* stream) {
  StagePlan p;
  if (!plan_drops(span, RAGGED, &p)) {
    return kNoFit;
  }
  return launch_staged_series<true, RAGGED>(vals, stride, vbase, num_rows,
                                            wr, W, p, is_counter, is_rate,
                                            out, pres, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// K2 dense, group mode.  vals [rows, stride] f32 (stride a multiple of 4,
// vals 16-byte aligned), vbase [rows] f32, order
// [N] int32 CSR rows, chunk_lo/chunk_hi [n_chunks] int32, gco [Gp + 1]
// int32, the window rows [W] (idx int32, the rest f32; tsrow [stride] is
// not read), span = the slots read from each row (max idx2 + 1, at most
// stride), partial [n_chunks, W] f32 scratch, out [Gp, W] f32.  Returns
// cudaGetLastError(), or kNoFit (-1) when one row's span, with its tables
// when ragged, does not fit in shared memory.
int fused_rate_drops_dense_launch(
    const float* vals, long long stride, const float* vbase,
    const int* order, const int* chunk_lo, const int* chunk_hi,
    long long n_chunks, const int* gco, int Gp, const int* idx1,
    const int* idx2, const float* t1, const float* t2, const float* n,
    const float* ws, const float* we, const float* tsrow, int W, int span,
    int is_counter, int is_rate, float* partial, float* out, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_chunks<false>(vals, stride, vbase, order, chunk_lo, chunk_hi,
                              n_chunks, gco, Gp, wr, W, span, is_counter,
                              is_rate, partial, out, stream);
}

// K2 ragged, group mode.  As the dense entry point (t1, t2 and n are not
// read); partial is [2, n_chunks, W] and out [2, Gp, W]: plane 0 the rate
// sums, plane 1 the presence counts (windows with two valid samples).
int fused_rate_drops_ragged_launch(
    const float* vals, long long stride, const float* vbase,
    const int* order, const int* chunk_lo, const int* chunk_hi,
    long long n_chunks, const int* gco, int Gp, const int* idx1,
    const int* idx2, const float* t1, const float* t2, const float* n,
    const float* ws, const float* we, const float* tsrow, int W, int span,
    int is_counter, int is_rate, float* partial, float* out, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_chunks<true>(vals, stride, vbase, order, chunk_lo, chunk_hi,
                             n_chunks, gco, Gp, wr, W, span, is_counter,
                             is_rate, partial, out, stream);
}

// K6 over K2 dense.  out [num_rows, W] f32 (pres is not written); the
// other operands as the group-mode entry points.
int fused_rate_drops_dense_series_launch(
    const float* vals, long long stride, const float* vbase,
    long long num_rows, const int* idx1, const int* idx2, const float* t1,
    const float* t2, const float* n, const float* ws, const float* we,
    const float* tsrow, int W, int span, int is_counter, int is_rate,
    float* out, float* pres, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_series<false>(vals, stride, vbase, num_rows, wr, W, span,
                              is_counter, is_rate, out, pres, stream);
}

// K6 over K2 ragged.  out and pres [num_rows, W] f32.
int fused_rate_drops_ragged_series_launch(
    const float* vals, long long stride, const float* vbase,
    long long num_rows, const int* idx1, const int* idx2, const float* t1,
    const float* t2, const float* n, const float* ws, const float* we,
    const float* tsrow, int W, int span, int is_counter, int is_rate,
    float* out, float* pres, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_series<true>(vals, stride, vbase, num_rows, wr, W, span,
                             is_counter, is_rate, out, pres, stream);
}

}  // extern "C"
