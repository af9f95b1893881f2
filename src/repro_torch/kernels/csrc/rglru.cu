// RG-LRU linear recurrence, forward, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru.py::rglru_scan (body
// _rglru_kernel). Same contract:
//   a, b [B, S, W] f32; h0 [B, W] f32 (or null for zeros) ->
//   h [B, S, W] f32 with h_t = a_t * h_{t-1} + b_t, and h_last [B, W] = the
//   state after step S-1 (h0 itself when S == 0).
//
// Design. The Pallas kernel walks time blocks as the innermost sequential
// grid axis and carries the state in VMEM scratch between grid steps. CUDA
// blocks run in no order, so here one thread owns one (b, w) channel for
// the whole sequence and carries h in a register; neighbouring threads take
// neighbouring channels, so every load of a and b and every store of h is
// coalesced. Any S and any W are taken as they are: no padding, and h_last
// is the state after the true last step.
//
// What bounds it on an H100. Each element is read twice (a, b) and written
// once (h): 12 bytes and one FMA, so the function is bound by device memory
// (at [1, 2048, 4096]: 100.7 MB, 0.030 ms at 3.35 TB/s). The loads of a and
// b do not depend on h, so each thread issues UNROLL steps of loads before
// it runs their FMAs, keeping 2 * UNROLL loads in flight to cover memory
// latency. At B = 1 there are only W threads (4,096 at full width), too few
// to reach the memory rate; a chunked scan over time (partial products per
// chunk, then a pass that carries states across chunks) is the way there.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success), or -1 for bad sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads per block (channels)
constexpr int UNROLL = 16;  // time steps whose loads are issued together

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const int bi = blockIdx.y;
  const size_t base = (size_t)bi * S * W + w;
  float hv = h0 ? h0[(size_t)bi * W + w] : 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = __ldg(a + base + (size_t)(t + u) * W);
      bv[u] = __ldg(b + base + (size_t)(t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      h[base + (size_t)(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = fmaf(__ldg(a + base + (size_t)t * W), hv,
              __ldg(b + base + (size_t)t * W));
    h[base + (size_t)t * W] = hv;
  }
  h_last[(size_t)bi * W + w] = hv;
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* h, void* h_last, int B, int S, int W,
                              void* stream) {
  if (B <= 0 || S < 0 || W <= 0) return -1;
  dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W);
  return (int)cudaGetLastError();
}
