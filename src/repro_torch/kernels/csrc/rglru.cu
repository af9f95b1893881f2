// RG-LRU linear recurrence, forward, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru.py::rglru_scan (body
// _rglru_kernel). Same contract:
//   a, b [B, S, W] f32; h0 [B, W] f32 (or null for zeros) ->
//   h [B, S, W] f32 with h_t = a_t * h_{t-1} + b_t, and h_last [B, W] = the
//   state after step S-1 (h0 itself when S == 0). Any B, S and W: no
//   padding.
//
// What bounds it on an H100. Each element is read twice (a, b) and written
// once (h): 12 bytes and one FMA, so the function is bound by device memory
// (at [1, 2048, 4096]: 100.7 MB, 0.030 ms at 3.35 TB/s). Reaching that rate
// takes every SM busy and megabytes of loads in flight across the card.
// The first version gave one thread to each channel for all S steps: at
// B = 1, 32 blocks of 128 threads on 32 of the 132 SMs, each thread with
// 32 loads in flight, at 16% of the bound.
//
// Design: the time axis is split inside the block, with the associative
// form of the step. A run of steps is the pair (A, B) with h_out = A * h_in
// + B, and (A2, B2) after (A1, B1) is (A2 * A1, A2 * B1 + B2). The Pallas
// kernel carries the state in VMEM across its sequential time blocks; CUDA
// blocks carry nothing to each other, so here one block owns CH = 32
// channels of one batch row for the whole sequence (W / 32 x B blocks: 128
// at full width, one wave on 132 SMs). A lane owns a channel, so every row
// load and store is 128 coalesced bytes; warp s owns segment s, K steps,
// of a round of nw x K steps. Per round:
//  (1) each thread folds its K (a, b) from registers into its segment's
//      pair from a zero state (A = the product of its a's, B = its state);
//  (2) through shared memory, each channel's nw segment pairs are scanned
//      by nw lanes of one warp (32 / nw channels a warp, a shuffle scan of
//      log2(nw) steps), the carried state is applied, and each segment's
//      start state and the next carry are written;
//  (3) each thread replays its K steps from its start state and writes h.
// The next round's loads are issued before this round's fold and barriers,
// so 2 x K loads a thread (a round, 64 KB a block) stay in flight across
// them. a and b are read once and h written once, the function's bytes and
// no more: no scratch and no waits between blocks. Products of a only, no
// logarithms, so a = 0 and a = 1 are exact. Steps past S are the identity
// (a = 1, b = 0) and channels past W load nothing; neither is stored.
// nw is the least power of two with nw x K >= S, at most NW = 32: a short
// prefill launches few warps, and its scan has few steps (a first try
// scanned one channel a warp, 16 channels in series at S = 16, and lost
// 2.5 us there).
//
// Non-finite states. Where a product of a over a span of segments
// underflows to 0, a pair applied to an infinite state gives NaN (0 * Inf)
// where the sequential step keeps Inf (tiny * Inf); in the model's range of
// a, exp(-8 softplus(lam) r), that happens within a round. So the scan
// votes on NaN at the round's second barrier, and a channel whose start
// states or next carry hold a NaN has its round walked again in series by
// one thread, from the carry, before the replay (as gmm recomputes a tile
// that holds a NaN). A NaN that the steps themselves make (Inf meets -Inf,
// a = 0 times Inf) comes out of that walk again. On finite data the vote
// costs what the barrier it replaces did.
//
// Variants tried, timed with a cold L2 on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2b while it swept them; ms at [1, 2048, 4096], then
// [4, 2048, 4096]): K = 4 with 32 warps 0.0429-0.0432, 0.1470-0.1473;
// K = 8 with 32 (kept) 0.0423-0.0425, 0.1448-0.1452; K = 8 with 16
// 0.0428, 0.1464-0.1468; K = 16 with 16 0.0421-0.0425, 0.1441; K = 16
// with 8 0.0445, 0.1455-0.1459. All lie within 2% of one another except
// 8 warps of K = 16 at B = 1 (half the loads in flight, 6% slower). K = 8
// with 32 warps runs within 6% of PyTorch's elementwise a + b over the
// same bytes: what is left to the bound is the memory rate a streaming
// kernel reaches, not the scan. Four channels a lane (float4 loads) would
// give 128 channels a block and 32 blocks at B = 1, the first version's
// idle card, and is not built; nor is a split of time across blocks (a
// decoupled look-back), since one wave already streams at the elementwise
// rate.
//
// Interface: plain C, launched on the caller's stream; allocates nothing;
// returns the CUDA error code after the launch (0 on success), or -1 for
// bad sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;  // channels a block: one a lane
constexpr int K = 8;    // steps a segment: one warp's share of a round
constexpr int NW = 32;  // segments (warps) a round, at most

// steps t0 .. t0 + K - 1 of one channel; the identity past S or W
__device__ __forceinline__ void load_segment(
    const float* __restrict__ a, const float* __restrict__ b, size_t base,
    int t0, int S, int W, bool live, float (&av)[K], float (&bv)[K]) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int t = t0 + u;
    const bool in = live && t < S;
    av[u] = in ? __ldg(a + base + (size_t)t * W) : 1.f;
    bv[u] = in ? __ldg(b + base + (size_t)t * W) : 0.f;
  }
}

__global__ void __launch_bounds__(NW * 32)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  // [segment][channel], rows padded by one so a warp reading one channel's
  // segments (a column) hits 32 banks
  __shared__ float sA[NW][CH + 1];
  __shared__ float sB[NW][CH + 1];
  __shared__ float sH[NW][CH + 1];  // each segment's start state
  __shared__ float carry[CH];       // the state after the last round
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;  // a power of two
  const int round = nw * K;
  // in the scan, lane = (channel sc, segment sj): warp seg scans the 32 /
  // nw channels from seg * 32 / nw on, nw lanes each
  const int sj = lane & (nw - 1);
  const int sc = seg * (CH / nw) + lane / nw;
  const int w = blockIdx.x * CH + lane;
  const bool live = w < W;
  const size_t row = (size_t)blockIdx.y * W + w;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const float hinit =
      (threadIdx.x < CH && h0 != nullptr && live) ? __ldg(h0 + row) : 0.f;
  float an[K], bn[K];  // the next round's steps, loads in flight
  load_segment(a, b, base, seg * K, S, W, live, an, bn);
  // stored after the first loads are issued, so they wait on it together
  if (threadIdx.x < CH) carry[lane] = hinit;
  for (int t0 = 0; t0 < S; t0 += round) {
    float ac[K], bc[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    if (t0 + round < S)
      load_segment(a, b, base, t0 + round + seg * K, S, W, live, an, bn);
    // (1) this segment's pair from a zero state
    float pa = ac[0], pb = bc[0];
#pragma unroll
    for (int u = 1; u < K; ++u) {
      pa *= ac[u];
      pb = fmaf(ac[u], pb, bc[u]);
    }
    sA[seg][lane] = pa;
    sB[seg][lane] = pb;
    __syncthreads();
    // (2) each channel's nw segment pairs, scanned in log2(nw) shuffle
    //     steps within its group of nw lanes
    float end;
    {
      float ca = sA[sj][sc], cb = sB[sj][sc];
      for (int off = 1; off < nw; off <<= 1) {
        const float ua = __shfl_up_sync(0xffffffffu, ca, off, nw);
        const float ub = __shfl_up_sync(0xffffffffu, cb, off, nw);
        if (sj >= off) {
          cb = fmaf(ca, ub, cb);
          ca *= ua;
        }
      }
      const float hc = carry[sc];
      end = fmaf(ca, hc, cb);  // the state after segment sj
      const float start = __shfl_up_sync(0xffffffffu, end, 1, nw);
      sH[sj][sc] = sj == 0 ? hc : start;
      if (sj == nw - 1) carry[sc] = end;
    }
    // a NaN in some lane's end, so maybe in a start state or the carry:
    // walk each such channel's round again in series from the carry in,
    // sH[0]
    if (__syncthreads_or(isnan(end))) {
      bool redo = false;
      if (threadIdx.x < CH && live) {
        redo = isnan(carry[lane]);
        for (int s = 0; s < nw; ++s) redo |= isnan(sH[s][lane]);
      }
      if (redo) {
        float hv = sH[0][lane];
        for (int s = 0; s < nw; ++s) {
          sH[s][lane] = hv;
          for (int u = 0; u < K; ++u) {
            const int t = t0 + s * K + u;
            if (t < S)
              hv = fmaf(__ldg(a + base + (size_t)t * W), hv,
                        __ldg(b + base + (size_t)t * W));
          }
        }
        carry[lane] = hv;
      }
      __syncthreads();
    }
    // (3) replay the segment from its start state
    float hv = sH[seg][lane];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      hv = fmaf(ac[u], hv, bc[u]);
      const int t = t0 + seg * K + u;
      if (live && t < S) h[base + (size_t)t * W] = hv;
    }
  }
  // the last round's carry was written before its second barrier (or, at
  // S = 0, by this same thread)
  if (threadIdx.x < CH && live) h_last[row] = carry[lane];
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* h, void* h_last, int B, int S, int W,
                              void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || W <= 0) return -1;
  // the least power of two of segments that covers S, at most NW
  int nw = 1;
  while (nw < NW && nw * K < S) nw *= 2;
  dim3 grid((W + CH - 1) / CH, B);
  rglru_scan_kernel<<<grid, nw * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W);
  return (int)cudaGetLastError();
}
