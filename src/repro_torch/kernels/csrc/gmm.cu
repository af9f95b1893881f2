// Grouped matmul (the MoE expert compute), forward, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/gmm.py::gmm (body _gmm_kernel).
// Same contract:
//   x [E, C, d] f32, w [E, d, f] f32 -> out [E, C, f] f32,
//   out[e] = x[e] @ w[e], to f32 accuracy (no one-pass TF32 product).
// Any E, C, d and f are taken as they are: every edge is bounds-checked
// where the JAX wrapper zero-pads C to 128 and d, f to 256 / 128.
//
// C is the capacity of an expert: 8 in a decode step (at up to 8 slots),
// 24-320 in a prefill of 128-2,048 tokens at Phi-3.5-MoE's widths (E = 16,
// top-2, factor 1.25). Per call the weights are 1.68 GB (0.50 ms at 3.35
// TB/s) and the product is 2 C d f per expert. Two paths:
// - C <= 16, bound by the weight stream: gmm_small_c reads each weight
//   element once per call, on the CUDA cores. A block owns 128 output
//   columns of one expert; its 8 warps split the contraction rows, each
//   lane loading 16 bytes of a weight row (512 contiguous bytes a warp),
//   eight rows of loads issued before their FMAs; each warp stages x's
//   matching rows in shared memory (read back as broadcasts), and the 8
//   partial sums meet in shared memory at the end.
// - C > 16, gmm_tc, on the tensor cores in 3xTF32 (tf32_mma.cuh): each
//   element v of x and w is split as it is read for a fragment into hi =
//   tf32(v), rounded to nearest, ties away, and lo = v - hi, and each
//   product is a_lo b_hi + a_hi b_lo + a_hi b_hi: three
//   mma.sync.m16n8k8 TF32 issues with f32 accumulation, the small terms
//   first. Its bound is the larger of the weight bytes at 3.35 TB/s and
//   3 x 2 C d f at the 495 TFLOP/s TF32 peak: bytes up to C ~ 100 at these
//   widths, operations above. The design:
//   * Row tiles sized to C: BM = 32 rows up to C = 32, else 64, and a warp
//     skips its m16 row tiles wholly past C (C = 24 computes 32 rows, 40
//     48, 80 80). The row tiles of one column tile are neighbours in the
//     grid (blockIdx.x), so a weight tile that several of them read comes
//     from device memory once and from L2 after.
//   * A ring of 4 stages of 32-deep k slices of x and w in dynamic shared
//     memory, filled by cp.async (16-byte copies with VEC, 4-byte ones for
//     ragged rows): three slices in flight while one is multiplied. Rows
//     of the staged x are padded to 36 floats and of w to 136, so the
//     fragment loads (LDS.32: ldmatrix is for 16-bit types) hit 32
//     different banks. Past C, d or f a copy has src-size 0 (zeros, never
//     read) and its source address points inside the expert's array.
//   * 4 warps, each a 32 x 32 (BM = 32) or 32 x 64 (BM = 64) tile of m16n8
//     accumulators; each slice accumulates on the tensor cores from zero
//     and is added into the f32 sum (mma_slice, gmm_tc's note).
//   * Non-finite inputs: the split makes an Inf input NaN in every output
//     it reaches. After its main loop each block tests its accumulators
//     for NaN and votes (__syncthreads_or); only a block that votes yes
//     recomputes its tile on the CUDA cores in plain f32, in k order, from
//     x and w in device memory. So every output is +Inf, -Inf or NaN
//     exactly where the f32 product's is (phase 2c of chip_smoke.py holds
//     the three classes), at the cost of a compare per accumulator and a
//     vote in the common case.
//   Accuracy: against the product in f64 this path is closer than the
//   plain version's f32 product (chip_smoke.py phase 2c prints both at
//   every served shape): each slice's 12 MMAs truncate only a 32-term
//   partial sum, and the slices meet in rounded f32 adds.
//   mma.sync and not wgmma: wgmma takes a TF32 B only K-major in shared
//   memory, and w[e] is [d, f] with f contiguous (MN-major); transposing it
//   while staging is left for later.
// Both paths sum every output element in one fixed order, the k slices in
// turn and inside an MMA in the hardware's order, whatever row of the
// expert's capacity it sits in and whatever the other rows hold, so a
// token's result does not depend on its co-batch. It depends on C only
// through the path: C <= 16 and C > 16 sum differently (the row tile does
// not change the order).
// Registers and spills (-Xptxas -v, sm_90a): gmm_tc 140-141 (BM = 32) and
// 215-216 (BM = 64), the repair included; gmm_small_c 80-128 with 16,384
// or 24,576 bytes of shared memory; no spills.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success), or -1 for bad sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

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
// C > 16: tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int TBN = 128;      // output columns per block
constexpr int TBK = 32;       // k slice per stage
constexpr int AS = TBK + 4;   // staged x row (floats): banks 4g + t
constexpr int BS = TBN + 8;   // staged w row (floats): banks 8t + g

constexpr int TNT = 128;      // threads per block: 4 warps
constexpr int STAGES = 4;     // k slices in the ring

// BM = 32: 1 x 4 warps of 32 x 32; BM = 64: 2 x 2 warps of 32 x 64
template <int BM>
constexpr int tile_smem() {
  return STAGES * (BM * AS + TBK * BS) * (int)sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a cp.async of BYTES (16 or 4); nothing is read when !ok, and the
// destination is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const float* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One staged k slice on the tensor cores, added into `part`, for the
// warp's first MI m16 row tiles (those that hold a row below C): every
// product a b as a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first.
template <int MI, int NJ>
__device__ __forceinline__ void mma_slice(const float* as, const float* bs,
                                          float (&part)[2][NJ][4], int g,
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < TBK; kk += 8) {
    uint32_t ahi[MI][4], alo[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {           // rows g and g + 8, cols t, t + 4
      const float* a = as + (i * 16 + g) * AS + kk + t;
      split_tf32(a[0], ahi[i][0], alo[i][0]);
      split_tf32(a[8 * AS], ahi[i][1], alo[i][1]);
      split_tf32(a[4], ahi[i][2], alo[i][2]);
      split_tf32(a[8 * AS + 4], ahi[i][3], alo[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {           // k rows t, t + 4; column g
      const float* bp = bs + (kk + t) * BS + j * 8 + g;
      uint32_t bhi[2], blo[2];
      split_tf32(bp[0], bhi[0], blo[0]);
      split_tf32(bp[4 * BS], bhi[1], blo[1]);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_tf32(part[i][j], alo[i], bhi);
        mma_tf32(part[i][j], ahi[i], blo);
        mma_tf32(part[i][j], ahi[i], bhi);
      }
    }
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(TNT, 2)
gmm_tc(const float* __restrict__ x, const float* __restrict__ w,
       float* __restrict__ out, int C, int d, int f) {
  constexpr int WARPS_N = TNT / 32 / (BM / 32);
  constexpr int WN = TBN / WARPS_N;          // warp tile columns
  constexpr int NJ = WN / 8;                 // n8 tiles per warp
  constexpr int A_STAGE = BM * AS, B_STAGE = TBK * BS;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][AS]
  float* Bs = smem + STAGES * A_STAGE;       // [STAGES][TBK][BS]

  const int e = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * TBN;
  x += (size_t)e * C * d;
  w += (size_t)e * d * f;
  out += (size_t)e * C * f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;     // fragment row / column

  // x[m0 : m0 + BM, k0 : k0 + 32] and w[k0 : k0 + 32, n0 : n0 + 128]
  // into stage `slot`; zeros past C, d and f
  auto load = [&](int slot, int k0) {
    float* as = As + slot * A_STAGE;
    float* bs = Bs + slot * B_STAGE;
    constexpr int V = VEC ? 4 : 1;           // floats per copy
    for (int c = tid; c < BM * (TBK / V); c += TNT) {
      const int r = c / (TBK / V), kc = c % (TBK / V) * V;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < C && k < d;
      cp_async<4 * V>(as + r * AS + kc, ok ? x + (size_t)m * d + k : x, ok);
    }
    for (int c = tid; c < TBK * (TBN / V); c += TNT) {
      const int r = c / (TBN / V), nc = c % (TBN / V) * V;
      const int k = k0 + r, n = n0 + nc;
      const bool ok = k < d && n < f;
      cp_async<4 * V>(bs + r * BS + nc, ok ? w + (size_t)k * f + n : w, ok);
    }
  };

  // acc: the f32 sum of the slices so far; part: this slice's, on the
  // tensor cores from zero. An MMA adds into its accumulator with
  // truncation, a biased error of up to an ulp of the accumulator each
  // time: over a whole contraction (512-800 MMAs on one sum at these
  // widths) it breaks the f32 tolerance. A slice is 12 MMAs on a partial
  // sum of 32 terms, and the slices meet in rounded f32 adds.
  float acc[2][NJ][4], part[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  // m16 row tiles of this warp that hold a row below C (warp-uniform)
  const int live = min(2, max(0, (C - m0 - wm * 32 + 15) / 16));

  const int nk = (d + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * TBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // slice kt has landed (this thread's part)
    __syncthreads();               // ... every thread's; slice kt - 1 is done
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES,
                                   (kt + STAGES - 1) * TBK);
    cp_async_commit();
    if (live == 0) continue;
    const float* as = As + (kt % STAGES) * A_STAGE + wm * 32 * AS;
    const float* bs = Bs + (kt % STAGES) * B_STAGE + wn * WN;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
    if (live == 2)
      mma_slice<2, NJ>(as, bs, part, g, t);
    else
      mma_slice<1, NJ>(as, bs, part, g, t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();

  // Non-finite repair, off the hot loop: the split turns an Inf input into
  // NaN (tf32_mma.cuh), and a NaN is the only sign of it. A block whose
  // accumulators hold one recomputes its tile on the CUDA cores in plain
  // f32, in k order, from x and w in device memory, so every output is
  // +Inf, -Inf or NaN where the f32 product is. The common case costs a
  // compare per accumulator and one vote.
  bool nan_seen = false;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) nan_seen |= isnan(acc[i][j][r]);
  if (__syncthreads_or(nan_seen)) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    for (int k = 0; k < d; ++k) {
      float xv[2][2], wv[NJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
          xv[i][h] = m < C ? x[(size_t)m * d + k] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WN + j * 8 + 2 * t + e;
          wv[j][e] = n < f ? w[(size_t)k * f + n] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] = fmaf(xv[i][r >> 1], wv[j][r & 1], acc[i][j][r]);
    }
  }

  // accumulator (i, j): rows g and g + 8 of the i-th m16, columns 2t, 2t + 1
  // of the j-th n8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= C) continue;
      float* orow = out + (size_t)m * f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (VEC) {                 // f % 4 == 0: n < f means n + 1 < f
          if (n < f) *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < f) orow[n] = v0;
          if (n + 1 < f) orow[n + 1] = v1;
        }
      }
    }
}

template <int BM, bool VEC>
int launch_tc(const float* x, const float* w, float* out, int E, int C,
              int d, int f, cudaStream_t s) {
  // above 48 KB of dynamic shared memory a kernel has to ask, once per
  // device
  static bool asked[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return -1;
  if (!asked[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_tc<BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tile_smem<BM>());
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
  const dim3 grid((C + BM - 1) / BM, (f + TBN - 1) / TBN, E);
  gmm_tc<BM, VEC><<<grid, TNT, tile_smem<BM>(), s>>>(x, w, out, C, d, f);
  return (int)cudaGetLastError();
}

// 32-row tiles up to C = 32, then 64-row ones (their m16 tiles past C
// skipped)
template <bool VEC>
int dispatch_tc(const float* x, const float* w, float* out, int E, int C,
                int d, int f, cudaStream_t s) {
  return C <= 32 ? launch_tc<32, VEC>(x, w, out, E, C, d, f, s)
                 : launch_tc<64, VEC>(x, w, out, E, C, d, f, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int gmm_fwd(const void* x, const void* w, void* out, int E, int C,
                       int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || d < 0 || f <= 0 || E > 65535 ||
      (f + TBN - 1) / TBN > 65535)
    return -1;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte loads and stores need rows that are whole float4s
  const bool vec = d % 4 == 0 && f % 4 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  if (C > 16)
    return vec ? dispatch_tc<true>(xp, wp, op, E, C, d, f, s)
               : dispatch_tc<false>(xp, wp, op, E, C, d, f, s);
  const dim3 grid((f + SCOLS - 1) / SCOLS, E), block(SW * 32);
  if (C <= 8 && vec)
    gmm_small_c<8, true><<<grid, block, 0, s>>>(xp, wp, op, C, d, f);
  else if (C <= 8)
    gmm_small_c<8, false><<<grid, block, 0, s>>>(xp, wp, op, C, d, f);
  else if (vec)
    gmm_small_c<16, true><<<grid, block, 0, s>>>(xp, wp, op, C, d, f);
  else
    gmm_small_c<16, false><<<grid, block, 0, s>>>(xp, wp, op, C, d, f);
  return (int)cudaGetLastError();
}
