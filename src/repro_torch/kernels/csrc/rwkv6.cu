// RWKV-6 WKV recurrence (data-dependent decay), forward, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rwkv6.py::wkv_scan (body
// _wkv_kernel). Same contract, per batch row b and head h, with an N x N
// f32 state S (S[i][j] accumulates k_i * v_j):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//   r, k, v, w [B, T, H, N] f32 (the model's layout: the Pallas kernel's
//   [B, H, T, N] is a transpose the wrapper would have to make); u [H, N];
//   s0 [B, H, N, N] (or null for zeros) -> y [B, T, H, N], s_final
//   [B, H, N, N].
//
// Design. The Pallas kernel walks time blocks as the innermost sequential
// grid axis and keeps S in VMEM scratch between grid steps. Here a block
// owns one (b, h) and CB = 32 of its N state columns for the whole
// sequence; the columns are independent (the update of S[:, j] needs only
// v_t[j]), so the N / CB blocks of a head share nothing. Within a block,
// RG = 4 neighbouring lanes split one column's N rows: each holds N / RG
// entries of S[:, j] in registers, sums its part of y_t[j], and two
// shuffles add the four parts. Time steps are staged in shared memory
// CHUNK at a time with cp.async, double-buffered, so the next chunk's loads
// fly while this one is computed; every lane of a row group reads the
// same r_t, k_t, w_t entries (a broadcast), and the rows are padded by 4
// floats per group so the four groups' 16-byte reads hit distinct banks.
//
// What bounds it on an H100. At [1, 2048, 64, 64] the function moves about
// 170 MB (r, k, v, w, y, and the two states), 0.051 ms at 3.35 TB/s, and
// does about 2.7 GFLOP (5 N^2 per step and head), 0.040 ms at 67 TFLOP/s
// f32, so it is bound by bytes. The kernel is bound by neither: its time
// is the sequential chain of T steps per block, each about N / RG
// shared-memory reads and FMAs per lane plus a two-shuffle reduction, with
// 2 * B * H blocks of four warps on the card (128 blocks at B = 1).
// Splitting the sequence into chunks whose states are combined afterwards
// (the chunked form of models/rwkv6.py) is the way past that chain.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success), or -1 for an N other than 64
// (the head size of every configuration the port serves).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Tile {
  static constexpr int N = 64;            // head size
  static constexpr int RG = 4;            // lanes that split one column
  static constexpr int RPT = N / RG;      // rows of S per lane
  static constexpr int CB = 32;           // columns per block
  static constexpr int NT = CB * RG;      // threads per block
  static constexpr int CHUNK = 16;        // time steps per staged chunk
  static constexpr int NP = N + RG * 4;   // padded staged row
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

__global__ void __launch_bounds__(Tile::NT)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out, int T,
                int H) {
  using C = Tile;
  constexpr int N = C::N;
  __shared__ __align__(16) float sr[2][C::CHUNK][C::NP];
  __shared__ __align__(16) float sk[2][C::CHUNK][C::NP];
  __shared__ __align__(16) float sw[2][C::CHUNK][C::NP];
  __shared__ __align__(16) float sv[2][C::CHUNK][C::CB];
  __shared__ __align__(16) float su[C::NP];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int hh = bh % H;
  const int j0 = blockIdx.y * C::CB;
  const int tid = threadIdx.x;
  const int c = tid / C::RG;  // column within the block
  const int g = tid % C::RG;  // row group: rows g * RPT .. + RPT - 1
  const int j = j0 + c;
  const size_t step = (size_t)H * N;                // one time step
  const size_t base = ((size_t)b * T * H + hh) * N;  // (b, 0, h, 0)
  const int mine = g * (C::RPT + 4);                // my rows, padded

  for (int i = tid; i < N; i += C::NT)
    su[i + (i / C::RPT) * 4] = u[(size_t)hh * N + i];

  float S[C::RPT];
  const float* s0b = s0 ? s0 + (size_t)bh * N * N : nullptr;
#pragma unroll
  for (int q = 0; q < C::RPT; ++q)
    S[q] = s0b ? s0b[(size_t)(g * C::RPT + q) * N + j] : 0.f;

  // stage chunk ``ch`` of r, k, w (whole rows) and v (this block's
  // columns) into buffer ``buf``; steps past T are not read
  auto stage = [&](int ch, int buf) {
    const int t0 = ch * C::CHUNK;
    for (int e = tid; e < C::CHUNK * N / 4; e += C::NT) {
      const int t = e / (N / 4), i = (e % (N / 4)) * 4;
      if (t0 + t < T) {
        const size_t gi = base + (size_t)(t0 + t) * step + i;
        const int si = i + (i / C::RPT) * 4;
        cp_async16(&sr[buf][t][si], r + gi);
        cp_async16(&sk[buf][t][si], k + gi);
        cp_async16(&sw[buf][t][si], w + gi);
      }
    }
    for (int e = tid; e < C::CHUNK * C::CB / 4; e += C::NT) {
      const int t = e / (C::CB / 4), jj = (e % (C::CB / 4)) * 4;
      if (t0 + t < T)
        cp_async16(&sv[buf][t][jj], v + base + (size_t)(t0 + t) * step + j0 + jj);
    }
    cp_async_commit();
  };

  const int nch = (T + C::CHUNK - 1) / C::CHUNK;
  if (nch > 0) stage(0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nch) {
      stage(ch + 1, buf ^ 1);
      cp_async_wait<1>();  // chunk ch has landed; ch + 1 may still fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tc = min(C::CHUNK, T - ch * C::CHUNK);
    for (int t = 0; t < tc; ++t) {
      const float vj = sv[buf][t][c];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float ruk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < C::RPT; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[buf][t][mine + q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[buf][t][mine + q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[buf][t][mine + q]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[mine + q]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] = fmaf(rr[e], S[q + e], acc[e]);
          ruk[e] = fmaf(rr[e] * uu[e], kk[e], ruk[e]);
          S[q + e] = fmaf(ww[e], S[q + e], kk[e] * vj);
        }
      }
      // y_t[j] = sum over the four row groups of (r.S + v_j * r.u.k)
      float part = fmaf(vj, (ruk[0] + ruk[1]) + (ruk[2] + ruk[3]),
                        (acc[0] + acc[1]) + (acc[2] + acc[3]));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (g == 0) y[base + (size_t)(ch * C::CHUNK + t) * step + j] = part;
    }
    __syncthreads();  // the next iteration stages into this buffer
  }

  float* so = s_out + (size_t)bh * N * N;
#pragma unroll
  for (int q = 0; q < C::RPT; ++q) so[(size_t)(g * C::RPT + q) * N + j] = S[q];
}

}  // namespace

// All pointers must be 16-byte aligned (cp.async copies 16 bytes; rows of
// N floats then stay aligned). Returns -1 for an unsupported N or sizes.
extern "C" int wkv_scan_fwd(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, int B, int T, int H, int N,
                            void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || N != Tile::N) return -1;
  dim3 grid(B * H, Tile::N / Tile::CB);
  wkv_scan_kernel<<<grid, Tile::NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T, H);
  return (int)cudaGetLastError();
}
