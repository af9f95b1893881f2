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
//   [B, H, N, N]. Any T (no padding), N = 64, any w in [0, 1]: decays
//   enter the state as the recurrence has them (products of w, no
//   logarithms and no clamp), so w = 0 and w = 1 are exact and an
//   underflow goes to the true tiny value.
//
// What bounds it on an H100. At [1, 2048, 64, 64] the function moves about
// 170 MB (r, k, v, w, y, and the two states), 0.051 ms at 3.35 TB/s, and
// does about 2.7 GFLOP (5 N^2 per step and head), 0.040 ms at 67 TFLOP/s
// f32, so it is bound by bytes. The first version walked all T steps in
// one block per (b, h, 32 columns): 128 blocks at B = 1, each a chain of
// T dependent steps of ~215 ns, so latency and not bytes set its time.
//
// Design: a chunked scan in three launches over chunks of L = 64 steps.
//  (a) wkv_chunk_local, one block per (b, h, chunk c): the sequential step
//      over the chunk's steps from S = 0 (chunk 0 from s0), giving y_loc
//      (y with the chunk's own contributions: S_loc and the u term), the
//      chunk's state dS_c = S_loc at its end, and the per-row decay
//      product D_c[i] = prod_t w_t[i].
//  (b) wkv_chunk_states, per (b, h) and one state entry a thread, in
//      order over the chunks: S_{c+1} = D_c * S_c + dS_c from S_1 = dS_0,
//      eight chunks' loads issued ahead; each start state S_c overwrites
//      dS_c in the scratch, and the last is s_final.
//  (c) wkv_chunk_apply, one block per (b, h, chunk c >= 1): y_t += sum_i
//      r_t[i] W_t[i] S_c[i][j], with W_t[i] = prod over the chunk's
//      steps before t of w[i] (a running product, kept step by step), an
//      [L x N] x [N x N] product per chunk.
//  The serial chain falls from T steps to L steps plus T / L cheap state
//  steps, and the card gets T / L times more blocks (2,048 at B = 1, T =
//  2048). The scratch (dS and D, about 32 MB at T = 2048) comes from the
//  wrapper. The price is bytes: the three passes move about 430 MB at
//  that shape (the inputs twice, y and the scratch states twice each)
//  where the function needs 170 MB.
//  Pass (a)'s step, per thread of 64: 16 rows x 4 columns of S in
//  registers, so each r, k, w value read from shared memory serves four
//  columns (a warp's 16-byte read of four rows costs the shared-memory
//  pipe as much however few columns it serves); rows padded by 4 floats
//  per group of 16, so the four row groups' reads hit distinct banks.
//  Each row group's part of y_t goes to shared memory, and the parts are
//  summed after the staged steps, one 16-byte store of y a thread (no
//  shuffles in the step); the step's u term r.(u*k), one scalar per step,
//  is summed once per staged step by 8 lanes, not per column.
//  Steps are staged 8 at a time with cp.async, double-buffered.
// Registers and spills (-Xptxas -v, sm_90a): wkv_chunk_local 128
// registers, 29,024 bytes of shared memory; wkv_chunk_states 29;
// wkv_chunk_apply 72 (50,176 bytes of dynamic shared memory); no spills.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launches (0 on success), or -1 for an N other than
// 64 (the head size of every configuration the port serves) or a chunk
// length other than the kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;          // head size
constexpr int L = 64;          // time steps per chunk
constexpr int NT = 128;        // threads per block of passes (b) and (c)
// pass (a)
constexpr int NTA = 64;        // threads per block
constexpr int RG = 4;          // lanes that split a column quad's rows
constexpr int RPT = N / RG;    // rows of S per lane
constexpr int CPT = 4;         // columns of S per lane
constexpr int SUB = 8;         // steps per staged sub-chunk
constexpr int NP = N + RG * 4; // padded staged row
constexpr int YP = N + 8;      // padded row of a step's partial y sums
constexpr int UL = NTA / SUB;  // lanes per staged step's u term
// pass (c)
constexpr int AP = N + 4;      // staged row of r, then of r * W

static_assert(NTA == (N / CPT) * RG, "pass (a): a lane per 4 columns x 16 rows");
static_assert(NTA == N, "pass (a): a lane per row for u and the decay product");
static_assert(N % UL == 0 && UL <= 32, "pass (a): u term lanes in a warp");

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

__device__ __forceinline__ int pad(int i) { return i + (i / RPT) * 4; }

__global__ void __launch_bounds__(NTA)
wkv_chunk_local(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ dS,
                float* __restrict__ D, int T, int H) {
  __shared__ __align__(16) float sr[2][SUB][NP];
  __shared__ __align__(16) float sk[2][SUB][NP];
  __shared__ __align__(16) float sw[2][SUB][NP];
  __shared__ __align__(16) float sv[2][SUB][N];
  __shared__ __align__(16) float yp[SUB][RG][YP];  // row groups' y parts
  __shared__ float sruk[SUB];
  __shared__ float su[NP];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int hh = bh % H;
  const int c = blockIdx.y, nc = gridDim.y;
  const int t0 = c * L, tc = min(L, T - t0);
  const int tid = threadIdx.x;
  const int g = tid % RG;           // row group: rows g * RPT .. + RPT - 1
  const int j0 = tid / RG * CPT;    // columns j0 .. j0 + 3
  const int mine = g * (RPT + 4);   // my rows, padded
  const size_t step = (size_t)H * N;                           // one step
  const size_t base = ((size_t)b * T + t0) * step + (size_t)hh * N;

  su[pad(tid)] = u[(size_t)hh * N + tid];

  float S[RPT][CPT];
  const float* s0b = (c == 0 && s0) ? s0 + (size_t)bh * N * N : nullptr;
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      S[q][e] = s0b ? s0b[(size_t)(g * RPT + q) * N + j0 + e] : 0.f;
  float dprod = 1.f;  // prod of w[.][tid] over the chunk

  // stage steps [ts, ts + SUB) of the chunk into buffer ``buf``; steps past
  // the chunk are not read
  auto stage = [&](int ts, int buf) {
    for (int e = tid; e < SUB * N / 4; e += NTA) {
      const int t = e / (N / 4), i = (e % (N / 4)) * 4;
      if (ts + t < tc) {
        const size_t gi = base + (size_t)(ts + t) * step + i;
        cp_async16(&sr[buf][t][pad(i)], r + gi);
        cp_async16(&sk[buf][t][pad(i)], k + gi);
        cp_async16(&sw[buf][t][pad(i)], w + gi);
        cp_async16(&sv[buf][t][i], v + gi);
      }
    }
    cp_async_commit();
  };

  const int nsub = (tc + SUB - 1) / SUB;
  stage(0, 0);
  for (int sc = 0; sc < nsub; ++sc) {
    const int buf = sc & 1;
    cp_async_wait<0>();   // sub-chunk sc has landed: this thread's part
    __syncthreads();      // ... every thread's; all are past sub-chunk sc - 1
    if (sc + 1 < nsub) stage((sc + 1) * SUB, buf ^ 1);
    const int n = min(SUB, tc - sc * SUB);
    {  // each staged step's u term r.(u*k): UL lanes of N / UL rows a step
      const int tt = tid / UL, part = tid % UL;
      float acc = 0.f;
      if (tt < n) {
#pragma unroll
        for (int q = 0; q < N / UL; ++q) {
          const int i = pad(part * (N / UL) + q);
          acc = fmaf(sr[buf][tt][i] * su[i], sk[buf][tt][i], acc);
        }
      }
#pragma unroll
      for (int off = 1; off < UL; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) sruk[tt] = acc;
    }
    for (int tt = 0; tt < n; ++tt) dprod *= sw[buf][tt][pad(tid)];
    for (int tt = 0; tt < n; ++tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(&sv[buf][tt][j0]);
      const float vv[CPT] = {v4.x, v4.y, v4.z, v4.w};
      float ya[CPT] = {0.f, 0.f, 0.f, 0.f}, yb[CPT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < RPT; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[buf][tt][mine + q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[buf][tt][mine + q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[buf][tt][mine + q]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < CPT; ++e) {   // two partial sums per column
          ya[e] = fmaf(rr[0], S[q][e], ya[e]);
          yb[e] = fmaf(rr[1], S[q + 1][e], yb[e]);
          ya[e] = fmaf(rr[2], S[q + 2][e], ya[e]);
          yb[e] = fmaf(rr[3], S[q + 3][e], yb[e]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int e = 0; e < CPT; ++e)
            S[q + x][e] = fmaf(ww[x], S[q + x][e], kk[x] * vv[e]);
      }
      // this row group's part of y_t, summed over the groups below
      *reinterpret_cast<float4*>(&yp[tt][g][j0]) =
          make_float4(ya[0] + yb[0], ya[1] + yb[1], ya[2] + yb[2],
                      ya[3] + yb[3]);
    }
    __syncthreads();
    // y_t = the four row groups' parts + v_t * r.(u*k), 4 columns a thread
    for (int e = tid; e < n * N / 4; e += NTA) {
      const int tt = e / (N / 4), j = (e % (N / 4)) * 4;
      float4 acc = *reinterpret_cast<const float4*>(&yp[tt][0][j]);
#pragma unroll
      for (int gg = 1; gg < RG; ++gg) {
        const float4 p4 = *reinterpret_cast<const float4*>(&yp[tt][gg][j]);
        acc.x += p4.x;
        acc.y += p4.y;
        acc.z += p4.z;
        acc.w += p4.w;
      }
      const float4 v4 = *reinterpret_cast<const float4*>(&sv[buf][tt][j]);
      const float ruk = sruk[tt];
      *reinterpret_cast<float4*>(&y[base + (size_t)(sc * SUB + tt) * step + j]) =
          make_float4(fmaf(v4.x, ruk, acc.x), fmaf(v4.y, ruk, acc.y),
                      fmaf(v4.z, ruk, acc.z), fmaf(v4.w, ruk, acc.w));
    }
  }

  float* ds = dS + ((size_t)bh * nc + c) * N * N;
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    *reinterpret_cast<float4*>(&ds[(size_t)(g * RPT + q) * N + j0]) =
        make_float4(S[q][0], S[q][1], S[q][2], S[q][3]);
  D[((size_t)bh * nc + c) * N + tid] = dprod;
}

// S_1 = dS_0; S_{c+1} = D_c * S_c + dS_c, each S_c written over dS_c;
// s_final = S_nc (s0, or zeros, when nc == 0). A thread owns one entry and
// loads 8 chunks ahead.
__global__ void __launch_bounds__(NT)
wkv_chunk_states(const float* __restrict__ s0, float* __restrict__ dS,
                 const float* __restrict__ D, float* __restrict__ s_out,
                 int nc) {
  constexpr int NN = N * N;
  const int bh = blockIdx.x;
  const int e = blockIdx.y * NT + threadIdx.x;
  const int row = e / N;
  float* ds = dS + (size_t)bh * nc * NN + e;
  const float* db = D + (size_t)bh * nc * N + row;
  float S;
  if (nc > 0)
    S = ds[0];
  else
    S = s0 ? s0[(size_t)bh * NN + e] : 0.f;
  for (int c0 = 1; c0 < nc; c0 += 8) {
    float x[8], d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < nc) {
        x[j] = ds[(size_t)(c0 + j) * NN];
        d[j] = db[(size_t)(c0 + j) * N];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < nc) {
        ds[(size_t)(c0 + j) * NN] = S;
        S = fmaf(d[j], S, x[j]);
      }
  }
  s_out[(size_t)bh * NN + e] = S;
}

// Chunk c = blockIdx.y + 1: y_t[j] += sum_i r_t[i] W_t[i] S_c[i][j].
// Thread (tg, jg) owns steps tg + 16 q (q < 4) and columns 4 jg + 32 hf + e
// (hf < 2, e < 4): the staged a = r * W is read as broadcasts from rows 68
// floats apart (4 tg + i: distinct banks), S as 128 contiguous bytes.
constexpr size_t APPLY_SMEM = sizeof(float) * (N * N + L * AP + L * N);

__global__ void __launch_bounds__(NT)
wkv_chunk_apply(const float* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ dS, float* __restrict__ y, int T,
                int H, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                 // [N][N]: the chunk's start state
  float* sa = sS + N * N;           // [L][AP]: r, then r * W
  float* sw = sa + L * AP;          // [L][N]
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int c = blockIdx.y + 1;
  const int t0 = c * L, tc = min(L, T - t0);
  const int tid = threadIdx.x;
  const size_t step = (size_t)H * N;
  const size_t base = ((size_t)b * T + t0) * step + (size_t)hh * N;

  const float* ds = dS + ((size_t)bh * nc + c) * N * N;
  for (int e = tid; e < N * N / 4; e += NT) cp_async16(sS + 4 * e, ds + 4 * e);
  for (int e = tid; e < L * N / 4; e += NT) {
    const int t = e / (N / 4), i = (e % (N / 4)) * 4;
    if (t < tc) {
      cp_async16(sa + t * AP + i, r + base + (size_t)t * step + i);
      cp_async16(sw + t * N + i, w + base + (size_t)t * step + i);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < N) {                    // the running product, step by step
    float W = 1.f;
#pragma unroll 8
    for (int t = 0; t < tc; ++t) {
      sa[t * AP + tid] *= W;
      W *= sw[t * N + tid];
    }
  }
  __syncthreads();

  const int tg = tid / 8, jg = tid % 8;
  float acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
#pragma unroll 4
  for (int i = 0; i < N; ++i) {
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = sa[(tg + 16 * q) * AP + i];
    const float4 s_lo = *reinterpret_cast<const float4*>(sS + i * N + 4 * jg);
    const float4 s_hi =
        *reinterpret_cast<const float4*>(sS + i * N + 32 + 4 * jg);
    const float sv[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w,
                         s_hi.x, s_hi.y, s_hi.z, s_hi.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(a[q], sv[e], acc[q][e]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = tg + 16 * q;
    if (t >= tc) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float4* yp = reinterpret_cast<float4*>(
          y + base + (size_t)t * step + 32 * hf + 4 * jg);
      float4 o = *yp;
      o.x += acc[q][4 * hf + 0];
      o.y += acc[q][4 * hf + 1];
      o.z += acc[q][4 * hf + 2];
      o.w += acc[q][4 * hf + 3];
      *yp = o;
    }
  }
}

}  // namespace

// r, k, v, w, y and dS must be 16-byte aligned (16-byte copies, loads and
// stores; rows of N floats then stay aligned). dS holds B * H * max(nc, 1)
// states of N x N and D as many rows of N, nc = ceil(T / chunk): scratch
// the caller allocates. Returns -1 for an unsupported N, chunk or sizes.
extern "C" int wkv_scan_fwd(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, void* dS, void* D, int B,
                            int T, int H, int n, int chunk, void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || n != N || chunk != L) return -1;
  const int nc = (T + L - 1) / L;
  if (nc > 65535) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const float*>(r);
  const auto* wp = static_cast<const float*>(w);
  auto* yp = static_cast<float*>(y);
  auto* dsp = static_cast<float*>(dS);
  auto* dp = static_cast<float*>(D);
  if (nc > 0)
    wkv_chunk_local<<<dim3(B * H, nc), NTA, 0, s>>>(
        rp, static_cast<const float*>(k), static_cast<const float*>(v), wp,
        static_cast<const float*>(u), static_cast<const float*>(s0), yp, dsp,
        dp, T, H);
  wkv_chunk_states<<<dim3(B * H, N * N / NT), NT, 0, s>>>(
      static_cast<const float*>(s0), dsp, dp, static_cast<float*>(s_out), nc);
  if (nc > 1) {
    // above 48 KB of dynamic shared memory a kernel has to ask, once per
    // device
    static bool asked[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64) return -1;
    if (!asked[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          wkv_chunk_apply, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)APPLY_SMEM);
      if (err != cudaSuccess) return (int)err;
      asked[dev] = true;
    }
    wkv_chunk_apply<<<dim3(B * H, nc - 1), NT, APPLY_SMEM, s>>>(
        rp, wp, dsp, yp, T, H, nc);
  }
  return (int)cudaGetLastError();
}
