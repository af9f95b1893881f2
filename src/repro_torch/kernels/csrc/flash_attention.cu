// Causal / sliding-window GQA flash attention, forward only, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel). Same contract:
//   q [B, H, Sq, hd]; k, v [B, KV, Skv, hd] -> o [B, H, Sq, hd], f32 or
//   bf16, hd 64, 128 or 256, Sq and Skv multiples of 64. Query head h
//   reads KV head h / (H / KV); query row i sits at position q_offset + i;
//   key column j is visible when j < kv_len, and (causal) q_pos >= j, and
//   (window > 0) q_pos - j < window. Online softmax in f32. A row with no
//   visible key writes zeros (kernels/ref.py semantics).
//
// What bounds it on an H100. At q [1, 32, 2048, 128], k/v [1, 8, 2048, 128]
// causal the function is 34.4 GFLOP (4 hd per visible pair and head)
// against ~100 MB of inputs and outputs: bound by operations. The product
// has to be f32-accurate (the main path feeds f32). On the CUDA cores that
// is 0.51 ms at 67 TFLOP/s; on the tensor cores in 3xTF32 (tf32_mma.cuh:
// three TF32 MMAs per product) it is 3 x 34.4 GFLOP at 495 TFLOP/s, 0.21
// ms. The first version of this kernel ran on the CUDA cores, with P
// through shared memory and synchronous K/V staging, at 35% of the
// CUDA-core bound.
//
// Design. The Pallas kernel walks the KV blocks as the innermost
// sequential grid axis and carries (m, l, acc) in VMEM between grid steps.
// CUDA blocks run in no order, so here a block owns a 64-row query tile of
// one head and loops over the KV tiles itself:
// * Both products on the tensor cores, mma.sync.m16n8k8 TF32 in 3xTF32:
//   S = Q K^T and O += P V, each operand split into hi + lo as a fragment
//   is read, each product a_lo b_hi + a_hi b_lo + a_hi b_hi. Each 32-deep
//   slice of a contraction accumulates from zero and the slices meet in
//   f32 adds (the MMA truncates as it accumulates; gmm_tc's note): S over
//   hd in slices of 32, and P V over each 32-key tile. Within a slice the
//   two small terms and the big one go to separate accumulators (two
//   dependent chains where one would be three times as long), added small
//   ones first. bf16 inputs convert to TF32 exactly (lo = 0), so S takes
//   one MMA per product there and P V two (P, in f32, is still split).
// * Warps own query rows: 4 warps, each 16 rows of the tile and every
//   output column. A warp's scores stay in its m16n8 accumulators; the
//   softmax (m, l, the rescale) runs there in base 2 (log2 e folded into
//   the scale, one exp2 a score), row maxima by quad shuffles, each lane
//   keeping a partial l that the quad sums once at the end; the output is
//   rescaled only when a row's maximum moved (a warp vote).
//   P goes to the second MMA from the same registers: the accumulator
//   holds columns 2t, 2t + 1 of each n8 tile where an A fragment wants
//   columns t, t + 4; the sum over keys does not care about order, so the
//   lane's two columns are read as k = t and k = t + 4, and V's B
//   fragment is loaded from key rows 2t and 2t + 1 to match. No shuffle,
//   no shared buffer for P.
// * K and V arrive ahead of use: a ring of two stages of 32-key tiles in
//   dynamic shared memory, filled by cp.async, so tile t + 1 loads while
//   tile t is multiplied (one barrier a tile). Q is staged once. Staged
//   rows are padded by 16 bytes (hd + 4 floats, hd + 8 bf16), so every
//   fragment load (LDS.32; ldmatrix is for 16-bit types) of Q, K and V
//   hits 32 distinct banks or shares a word.
// * Register budget: at hd 256 a warp's 16 x 256 f32 output is 128
//   registers a thread; a 32-key tile keeps the scores to 16 and P's
//   split fragments to 32, and Q is split from shared memory as it is
//   read rather than held in registers.
// * The loop visits only the KV tiles that the causal and window masks can
//   leave visible, and applies the masks only on tiles that straddle the
//   diagonal, the window's edge or kv_len. Query tiles run in reverse
//   order (blockIdx.y from the end), so the longest causal rows start
//   first.
// * mma.sync and not wgmma: wgmma takes a TF32 B only K-major in shared
//   memory, so V would have to be transposed while staging; mma.sync keeps
//   one staged layout for K and V and the P fragments in registers.
// Shared memory, f32: 52,224 bytes at hd 64, 101,376 at hd 128 (two
// blocks an SM), 199,680 at hd 256 (one block); bf16: 27,648, 52,224 and
// 101,376.
// Registers and spills (-Xptxas -v, sm_90a), f32 / bf16: hd 64 165 / 128,
// hd 128 253 / 168, hd 256 255 / 255; no spills.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block: 4 warps x 16
constexpr int BKV = 32;     // keys per staged tile: one 32-deep P V slice
constexpr int NT = 128;
constexpr int STAGES = 2;   // K/V tiles in the ring (the loop alternates two)

template <typename T, int HD>
struct Tile {
  static constexpr int LD = HD + 16 / (int)sizeof(T);  // staged row
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BKV * LD;           // one K or V tile
  static constexpr size_t SMEM =
      sizeof(T) * (size_t)(Q_ELEMS + 2 * STAGES * KV_ELEMS);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// a staged element as TF32 hi + lo: f32 split in two; a bf16 value is
// exact in TF32 (lo = 0, never read)
__device__ __forceinline__ void frag(float v, uint32_t& hi, uint32_t& lo) {
  split_tf32(v, hi, lo);
}
__device__ __forceinline__ void frag(__nv_bfloat16 v, uint32_t& hi,
                                     uint32_t& lo) {
  hi = (uint32_t)__bfloat16_as_ushort(v) << 16;
  lo = 0u;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows x HD elements from device memory (row stride HD) into shared memory
// (row stride LD), 16 bytes a copy
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows) {
  constexpr int LD = Tile<T, HD>::LD;
  constexpr int PER_ROW = HD * (int)sizeof(T) / 16;
  constexpr int V = 16 / (int)sizeof(T);
  for (int c = threadIdx.x; c < rows * PER_ROW; c += NT) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * V;
    cp_async16(dst + r * LD + col, src + (size_t)r * HD + col);
  }
}

// s = Q K^T for the warp's 16 rows and the tile's 32 keys (n8 tile j holds
// keys 8j .. 8j + 7), each 32-deep slice of hd from zero
template <typename T, int HD>
__device__ __forceinline__ void scores(const T* qs, const T* ks,
                                       float (&s)[BKV / 8][4], int g, int t) {
  constexpr int LD = Tile<T, HD>::LD;
  constexpr bool SPLIT = sizeof(T) == 4;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < HD; d0 += 32) {
    float part[BKV / 8][4], small[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[j][r] = small[j][r] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      const int kk = d0 + 8 * k8;
      uint32_t ahi[4], alo[4];               // rows g, g + 8; cols t, t + 4
      const T* a = qs + g * LD + kk + t;
      frag(a[0], ahi[0], alo[0]);
      frag(a[8 * LD], ahi[1], alo[1]);
      frag(a[4], ahi[2], alo[2]);
      frag(a[8 * LD + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {    // B[d][key] = K[key][d]
        const T* bp = ks + (j * 8 + g) * LD + kk + t;
        uint32_t bhi[2], blo[2];
        frag(bp[0], bhi[0], blo[0]);
        frag(bp[4], bhi[1], blo[1]);
        if (SPLIT) {
          mma_tf32(small[j], alo, bhi);
          mma_tf32(small[j], ahi, blo);
        }
        mma_tf32(part[j], ahi, bhi);
      }
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] += small[j][r] + part[j][r];
  }
}

// o += P V for the warp's 16 rows: P (f32, in the score accumulators) as A
// fragments, the lane's key columns 2t, 2t + 1 of n8 tile kk read as
// k = t, t + 4, and V's B fragment from key rows 8kk + 2t, 8kk + 2t + 1
template <typename T, int HD>
__device__ __forceinline__ void pv(const float (&p)[BKV / 8][4], const T* vs,
                                   float (&o)[HD / 8][4], int g, int t) {
  constexpr int LD = Tile<T, HD>::LD;
  constexpr bool SPLIT = sizeof(T) == 4;
  uint32_t phi[BKV / 8][4], plo[BKV / 8][4];
#pragma unroll
  for (int kk = 0; kk < BKV / 8; ++kk) {
    split_tf32(p[kk][0], phi[kk][0], plo[kk][0]);   // row g,     k = t
    split_tf32(p[kk][2], phi[kk][1], plo[kk][1]);   // row g + 8, k = t
    split_tf32(p[kk][1], phi[kk][2], plo[kk][2]);   // row g,     k = t + 4
    split_tf32(p[kk][3], phi[kk][3], plo[kk][3]);   // row g + 8, k = t + 4
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk) {
      const T* bp = vs + (kk * 8 + 2 * t) * LD + n * 8 + g;
      uint32_t bhi[2], blo[2];
      frag(bp[0], bhi[0], blo[0]);
      frag(bp[LD], bhi[1], blo[1]);
      mma_tf32(small, plo[kk], bhi);
      if (SPLIT) mma_tf32(small, phi[kk], blo);
      mma_tf32(part, phi[kk], bhi);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] += small[r] + part[r];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int KV, int Sq, int Skv, int causal, int window,
                 int q_offset, int kv_len, float scale) {
  using C = Tile<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + C::Q_ELEMS;                    // [STAGES][BKV][LD]
  T* sV = sK + STAGES * C::KV_ELEMS;          // [STAGES][BKV][LD]

  const int bh = blockIdx.x;                  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* qb = q + ((size_t)bh * Sq + q0) * HD;
  const T* kb = k + (size_t)(b * KV + kvh) * Skv * HD;
  const T* vb = v + (size_t)(b * KV + kvh) * Skv * HD;

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

  stage_rows<T, HD>(sQ, qb, BQ);
  if (t_begin < t_end) {
    stage_rows<T, HD>(sK, kb + (size_t)t_begin * BKV * HD, BKV);
    stage_rows<T, HD>(sV, vb + (size_t)t_begin * BKV * HD, BKV);
  }
  cp_async_commit();

  // lane rows: g and g + 8 of the warp's 16 (r = 0, 1); accumulator entry
  // e of an n8 tile is row g + 8 (e >> 1), column 2t + (e & 1)
  const float scale_log2 = scale * 1.4426950408889634f;
  const T* qs = sQ + warp * 16 * C::LD;
  const int qrow = qpos_lo + warp * 16 + g;
  float o_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = t_begin; it < t_end; ++it) {
    const int stage = (it - t_begin) & 1;
    cp_async_wait_all();   // tile it (and Q) has landed: this thread's part
    __syncthreads();       // ... every thread's; every warp is past tile it-1
    if (it + 1 < t_end) {
      const size_t off = (size_t)(it + 1) * BKV * HD;
      stage_rows<T, HD>(sK + (stage ^ 1) * C::KV_ELEMS, kb + off, BKV);
      stage_rows<T, HD>(sV + (stage ^ 1) * C::KV_ELEMS, vb + off, BKV);
    }
    cp_async_commit();

    float s[BKV / 8][4];
    scores<T, HD>(qs, sK + stage * C::KV_ELEMS, s, g, t);

    // masks only where the tile is not visible to every row of the block
    const int k0 = it * BKV;
    const bool edge = !(k0 + BKV <= kv_len &&
                        (!causal || k0 + BKV - 1 <= qpos_lo) &&
                        (window <= 0 || qpos_hi - k0 < window));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = qrow + 8 * (e >> 1);
          bool ok = kpos < kv_len;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // the quad t = 0..3 shares a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.f : exp2f(x - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;             // this lane's part of the row sum
      }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
    }

    pv<T, HD>(s, sV + stage * C::KV_ELEMS, o_acc, g, t);
  }
  cp_async_wait_all();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[r] = lt == 0.f ? 0.f : 1.f / lt;
  }
  T* ob = o + ((size_t)bh * Sq + q0 + warp * 16 + g) * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    store2(ob + n * 8, o_acc[n][0] * inv[0], o_acc[n][1] * inv[0]);
    store2(ob + 8 * HD + n * 8, o_acc[n][2] * inv[1], o_acc[n][3] * inv[1]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Skv, int causal, int window, int q_offset,
           int kv_len, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel has to ask, once per
  // device
  static bool asked[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return -1;
  const size_t smem = Tile<T, HD>::SMEM;
  if (!asked[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
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
  if (Sq % BQ != 0 || Skv % 64 != 0 || KV <= 0 || H % KV != 0) return -1;
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
