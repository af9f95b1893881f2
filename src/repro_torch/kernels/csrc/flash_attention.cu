// Causal / sliding-window GQA flash attention, forward only, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel). Same contract:
//   q [B, H, Sq, hd]; k, v [B, KV, Skv, hd] -> o [B, H, Sq, hd]
//   query head h reads KV head h / (H / KV); query row i sits at position
//   q_offset + i; key column j is visible when j < kv_len, and (causal)
//   q_pos >= j, and (window > 0) q_pos - j < window. Online softmax in f32.
//   A row with no visible key writes zeros (kernels/ref.py semantics).
//
// Design. The Pallas kernel walks the KV blocks as the innermost sequential
// grid axis and carries (m, l, acc) in VMEM between grid steps. CUDA blocks
// run in no order, so here one block owns a BQ x hd query tile and loops
// over the KV tiles itself, keeping (m, l, acc) in registers. The loop
// visits only the KV tiles that the causal and window masks can leave
// unmasked for this query tile.
//
// What bounds it on an H100. The main path feeds f32 (f32 parameters);
// tensor cores would take f32 only as TF32, which keeps about three
// decimal digits, so this first version stays on the CUDA cores in full
// f32 and is bound by FMA issue and shared-memory reads (about 2 shared
// loads per 4x4 micro-tile step of 16 FMAs), not by device memory: at
// Sq = Skv = 2048, H = 32, hd = 128 the work is ~34 GFLOP against ~100 MB
// of inputs and outputs. bf16 inputs are widened to f32 in shared memory.
//
// Tiles: BQ = BKV = 64, 256 threads as a 16 x 16 grid; thread (ty, tx)
// owns query rows ty*4 + i (i < 4) and, for the scores, key columns
// tx + 16*j (j < 4), for the output, head-dim columns tx + 16*j
// (j < hd/16). Rows of Q and K are padded by one float in shared memory so
// the column-strided reads do not collide on a bank.
//
// Head dims 64, 128 and 256 (RecurrentGemma's local attention: 16 query
// heads on one KV head). At hd 256 the f32 tiles take 213,760 bytes of
// shared memory (of the 232,448 a block may opt into), so one block runs
// per SM, and each thread keeps 4 x 16 output accumulators in registers.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes() {
  // sQ [BQ][HD+1], sK [BKV][HD+1], sV [BKV][HD], sP [BQ][BKV+1]
  return sizeof(float) * (size_t)(BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int KV, int Sq, int Skv, int causal, int window,
                 int q_offset, int kv_len, float scale) {
  constexpr int HDP = HD + 1;
  constexpr int CJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * HDP;
  float* sV = sK + BKV * HDP;
  float* sP = sV + BKV * HD;

  const int bh = blockIdx.x;          // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int G = H / KV;
  const int kvh = h / G;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qb = q + ((size_t)bh * Sq + q0) * HD;
  const T* kb = k + (size_t)(b * KV + kvh) * Skv * HD;
  const T* vb = v + (size_t)(b * KV + kvh) * Skv * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    int r = idx / HD, d = idx % HD;
    sQ[r * HDP + d] = to_f32(qb[(size_t)r * HD + d]);
  }

  // KV tiles that can hold a visible key for query positions
  // [qpos_lo, qpos_hi]
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + q0 + BQ - 1;
  int kv_hi = kv_len;                                   // exclusive
  if (causal) kv_hi = min(kv_hi, qpos_hi + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int t_begin = kv_lo / BKV;
  const int t_end = kv_hi > kv_lo ? (kv_hi + BKV - 1) / BKV : t_begin;

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < BKV * HD; idx += NT) {
      int r = idx / HD, d = idx % HD;
      sK[r * HDP + d] = to_f32(kb[(size_t)(k0 + r) * HD + d]);
      sV[r * HD + d] = to_f32(vb[(size_t)(k0 + r) * HD + d]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * HDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * HDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < kv_len;
        if (causal) ok = ok && (qpos >= kpos);
        if (window > 0) ok = ok && (qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 threads sharing a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      alpha[i] = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * (BKV + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha[i] + psum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = sV[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + ((size_t)bh * Sq + q0) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = (l[i] == 0.f) ? 0.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      from_f32(acc[i][j] * inv, &ob[(size_t)(ty * 4 + i) * HD + tx + 16 * j]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Skv, int causal, int window, int q_offset,
           int kv_len, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, Sq / BQ);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Skv, causal, window, q_offset, kv_len,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value, or -1 for
// an unsupported (hd, dtype) or shape (Sq, Skv must be multiples of 64,
// H a multiple of KV).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KV, int Sq, int Skv,
                                   int hd, int dtype, int causal, int window,
                                   int q_offset, int kv_len, void* stream) {
  if (Sq % BQ != 0 || Skv % BKV != 0 || KV <= 0 || H % KV != 0) return -1;
  if (kv_len > Skv) kv_len = Skv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 256)
    return launch<float, 256>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, kv_len, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, kv_len, s);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, kv_len, s);
  if (dtype == 1 && hd == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, kv_len, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, kv_len, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, kv_len, s);
  return -1;
}
