// Shared by the fused kernels (fused_rate.cu, fused_over_time.cu): the
// deterministic second pass of the group sum and the launch helpers.
// Each source includes it into its own anonymous namespace, so every
// shared library carries its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

// out[p][g, w] = sum over g's chunks, in chunk order, of partial[p][c, w]
__global__ void group_reduce(const float* __restrict__ partial,
                             long long n_chunks,
                             const int* __restrict__ gco, int Gp, int W,
                             int planes, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cells = (long long)Gp * W;
  if (t >= cells * planes) return;
  const int p = (int)(t / cells);
  const long long gw = t - (long long)p * cells;
  const int g = (int)(gw / W);
  const int w = (int)(gw - (long long)g * W);
  const float* src = partial + (long long)p * n_chunks * W;
  float acc = 0.0f;
  for (int c = gco[g]; c < gco[g + 1]; ++c) {
    acc += src[(long long)c * W + w];
  }
  out[t] = acc;
}

// threads per block for the chunk kernels: one per window, up to 256
int block_for(int W) {
  int b = ((W + 31) / 32) * 32;
  return b > 256 ? 256 : b;
}

int launch_reduce(const float* partial, long long n_chunks, const int* gco,
                  int Gp, int W, int planes, float* out,
                  cudaStream_t stream) {
  const long long total = (long long)Gp * W * planes;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  group_reduce<<<(unsigned)blocks, threads, 0, stream>>>(
      partial, n_chunks, gco, Gp, W, planes, out);
  return (int)cudaGetLastError();
}

// blocks of 256 threads covering `cells` (series, window) cells
unsigned series_blocks(long long cells) {
  return (unsigned)((cells + 255) / 256);
}

}  // namespace
