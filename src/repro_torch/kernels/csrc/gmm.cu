// Grouped matmul (the MoE expert compute), forward, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/gmm.py::gmm (body _gmm_kernel).
// Same contract:
//   x [E, C, d] f32, w [E, d, f] f32 -> out [E, C, f] f32,
//   out[e] = x[e] @ w[e], summed in f32 on the CUDA cores (no TF32).
// Any E, C, d and f are taken as they are: every edge is bounds-checked
// where the JAX wrapper zero-pads C to 128 and d, f to 256 / 128.
//
// What bounds it on an H100, and the two paths. C is the capacity of an
// expert: 8 in a decode step (at up to 8 slots), 320 in a 2,048-token
// prefill at Phi-3.5-MoE's widths (E = 16, top-2, factor 1.25).
// - C <= 16, bound by the weight stream: at [16, 8, 4096] @ [16, 4096,
//   6400] w is 1.68 GB and x 2 MB (0.50 ms at 3.35 TB/s). gmm_small_c
//   reads each weight element once per call. A block owns 128 output
//   columns of one expert; its 8 warps split the contraction rows, each
//   lane loading 16 bytes of a weight row (512 contiguous bytes a warp),
//   eight rows of loads issued before their FMAs; each warp stages x's
//   matching rows in shared memory (read back as broadcasts), and the 8
//   partial sums meet in shared memory at the end.
// - C > 16, bound by operations (2 C d f per expert: 268 GFLOP, 4.0 ms at
//   67 TFLOP/s, for the prefill's gate). gmm_tiled is a tiled SIMT GEMM:
//   a 128 x 128 output tile per block of 256 threads, 8 x 8 outputs per
//   thread in registers, 16-deep slices of x (stored transposed, rows
//   padded against bank conflicts) and w double-buffered in shared memory
//   and read back as float4, two blocks per SM (128 registers at most).
//   Tensor cores (TF32 or bf16 weights) would change the reference
//   numerics and wait.
// Both paths sum every output element in one fixed order whatever row of
// the expert's capacity it sits in and whatever the other rows hold, so a
// token's result does not depend on its co-batch.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success), or -1 for bad sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void fma4(float (&acc)[4], float s,
                                     const float4& v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}

// ---------------------------------------------------------------------------
// C <= 16: one pass over the weights
// ---------------------------------------------------------------------------

constexpr int SW = 8;         // warps per block, splitting the rows of w
constexpr int SCOLS = 128;    // output columns per block: 32 lanes x 4
constexpr int SROWS = 32;     // rows of w per staging step of a warp
constexpr int SUNROLL = 8;    // rows of loads issued before their FMAs

// Four columns of weight row ``row``: contiguous (one 16-byte load) when
// VEC, else strided by 32 across the lanes; zeros past f.
template <bool VEC>
__device__ __forceinline__ float4 load_w4(const float* __restrict__ row,
                                          const int (&col)[4], int f) {
  if (VEC) {
    return col[0] < f ? __ldg(reinterpret_cast<const float4*>(row + col[0]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(col[0] < f ? __ldg(row + col[0]) : 0.f,
                     col[1] < f ? __ldg(row + col[1]) : 0.f,
                     col[2] < f ? __ldg(row + col[2]) : 0.f,
                     col[3] < f ? __ldg(row + col[3]) : 0.f);
}

template <int CT, bool VEC>
__global__ void __launch_bounds__(SW * 32)
gmm_small_c(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int C, int d, int f) {
  static_assert(SROWS == 32 && CT % 4 == 0, "one staged row per lane");
  constexpr int XS = CT + 4;  // padded staged row, still 16-byte aligned
  __shared__ __align__(16) float xs[SW][SROWS][XS];
  __shared__ float red[SW][SCOLS];
  const int e = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * SCOLS;
  x += (size_t)e * C * d;
  w += (size_t)e * d * f;
  out += (size_t)e * C * f;
  int local[4], col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    local[j] = VEC ? lane * 4 + j : lane + 32 * j;
    col[j] = n0 + local[j];
  }
  // each warp walks its own rows of the contraction, a multiple of SROWS
  const int per_warp = ((d + SW - 1) / SW + SROWS - 1) / SROWS * SROWS;
  const int k_begin = warp * per_warp;
  const int k_end = min(d, k_begin + per_warp);
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += SROWS) {
    // stage x[:, k0 : k0 + 32] as xs[warp][row][c]; zeros past C and d
    __syncwarp();
    const int k = k0 + lane;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      xs[warp][lane][c] = (c < C && k < k_end)
                              ? __ldg(x + (size_t)c * d + k) : 0.f;
    __syncwarp();
    const int rows = min(SROWS, k_end - k0);
    for (int r0 = 0; r0 < rows; r0 += SUNROLL) {
      float4 wv[SUNROLL];
#pragma unroll
      for (int u = 0; u < SUNROLL; ++u)
        wv[u] = r0 + u < rows
                    ? load_w4<VEC>(w + (size_t)(k0 + r0 + u) * f, col, f)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < SUNROLL; ++u) {
        const float* xr = xs[warp][r0 + u];
#pragma unroll
        for (int c4 = 0; c4 < CT; c4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + c4);
          fma4(acc[c4 + 0], xv.x, wv[u]);
          fma4(acc[c4 + 1], xv.y, wv[u]);
          fma4(acc[c4 + 2], xv.z, wv[u]);
          fma4(acc[c4 + 3], xv.w, wv[u]);
        }
      }
    }
  }

  // the 8 warps' partial sums, row by row, in warp order
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c < C) {                                   // uniform over the block
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][local[j]] = acc[c][j];
      __syncthreads();
      if (threadIdx.x < SCOLS) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < SW; ++i) s += red[i][threadIdx.x];
        const int n = n0 + threadIdx.x;
        if (n < f) out[(size_t)c * f + n] = s;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// C > 16: tiled SIMT GEMM
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 16, NT = 256;
constexpr int LP = BK / 8;    // load passes per tile: 8 rows of k each

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
gmm_tiled(const float* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ out, int C, int d, int f) {
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  x += (size_t)e * C * d;
  w += (size_t)e * d * f;
  out += (size_t)e * C * f;
  const int tid = threadIdx.x;
  // per load pass (8 rows of the tile's k): 4 k's of one x row, 4
  // columns of one w row
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;
  const int ty = tid >> 4, tx = tid & 15;            // 16 x 16 threads
  float ra[LP][4], rb[LP][4];

  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < LP; ++p) {
      const int m = m0 + a_row, ka = k0 + a_k + 8 * p;
      if (VEC) {
        const float4 v = (m < C && ka < d)
            ? __ldg(reinterpret_cast<const float4*>(x + (size_t)m * d + ka))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        ra[p][0] = v.x; ra[p][1] = v.y; ra[p][2] = v.z; ra[p][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ra[p][i] = (m < C && ka + i < d)
                         ? __ldg(x + (size_t)m * d + ka + i) : 0.f;
      }
      const int kb = k0 + b_k + 8 * p, n = n0 + b_col;
      if (VEC) {
        const float4 v = (kb < d && n < f)
            ? __ldg(reinterpret_cast<const float4*>(w + (size_t)kb * f + n))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        rb[p][0] = v.x; rb[p][1] = v.y; rb[p][2] = v.z; rb[p][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rb[p][i] = (kb < d && n + i < f)
                         ? __ldg(w + (size_t)kb * f + n + i) : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < LP; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i) As[buf][a_k + 8 * p + i][a_row] = ra[p][i];
      *reinterpret_cast<float4*>(&Bs[buf][b_k + 8 * p][b_col]) =
          make_float4(rb[p][0], rb[p][1], rb[p][2], rb[p][3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (d + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= C) continue;
    float* orow = out + (size_t)m * f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (VEC && n < f) {
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < f) orow[n + j] = acc[i][4 * h + j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int gmm_fwd(const void* x, const void* w, void* out, int E, int C,
                       int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || d < 0 || f <= 0 || E > 65535) return -1;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte loads and stores need rows that are whole float4s
  const bool vec = d % 4 == 0 && f % 4 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  const dim3 block_s(SW * 32), block_t(NT);
  if (C <= 16) {
    const dim3 grid((f + SCOLS - 1) / SCOLS, E);
    if (C <= 8 && vec)
      gmm_small_c<8, true><<<grid, block_s, 0, s>>>(xp, wp, op, C, d, f);
    else if (C <= 8)
      gmm_small_c<8, false><<<grid, block_s, 0, s>>>(xp, wp, op, C, d, f);
    else if (vec)
      gmm_small_c<16, true><<<grid, block_s, 0, s>>>(xp, wp, op, C, d, f);
    else
      gmm_small_c<16, false><<<grid, block_s, 0, s>>>(xp, wp, op, C, d, f);
  } else {
    if ((C + BM - 1) / BM > 65535) return -1;
    const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
    if (vec)
      gmm_tiled<true><<<grid, block_t, 0, s>>>(xp, wp, op, C, d, f);
    else
      gmm_tiled<false><<<grid, block_t, 0, s>>>(xp, wp, op, C, d, f);
  }
  return (int)cudaGetLastError();
}
