// Decode attention: one query token per sequence against a contiguous KV
// cache or a paged KV pool, for sm_90a.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel) and
// repro/kernels/decode_attention.py::paged_decode_attention (body
// _paged_decode_kernel). Contiguous contract:
//   q [B, H, hd]; k, v [B, S, KV, hd]; lengths [B] int32 -> o [B, H, hd]
//   cache entries at positions >= lengths[b] are invisible and are never
//   read: the Pallas kernel skips blocks wholly past the length, and this
//   one ends its loop at the length and zero-fills the ragged tail, so
//   whatever lies past a length (stale or poisoned entries) cannot reach
//   the output. A length of 0 writes zeros.
//
// Design. The sequence is split: grid (B, KV, nsplit), and each block
// takes one (b, kv_head) and one run of `split_len` cache positions, a
// multiple of the 64-position tile. The wrapper picks nsplit from B, KV
// and S alone so that the grid gives every SM four blocks, and the launch
// bounds keep the registers low enough for four to stay resident. A block
// holds all G = H / KV query heads of its GQA group, as the Pallas program
// does, so each cache tile is read once for the whole group. Each block
// reads lengths[b] itself, on the device: a block whose run starts at or
// past the length writes an empty partial (m = -inf, l = 0) and returns,
// so nothing on the host sizes the grid by the lengths and a decode step
// never waits for the device. Tiles are staged in shared memory as bf16
// (the cache's type) with 16-byte loads and widened to f32 in registers;
// q stays f32 on the main path (the Pallas kernel's casts). Scores: one
// warp per cache position, each lane holding hd/32 elements of every query
// head, reduced with shuffles, the heads' reductions interleaved. Online
// softmax per head in f32. P.V gives each thread one head-dim column of
// its heads, one independent f32 chain per head. Each block writes its
// unnormalised partial (m, l, acc) to a workspace that the wrapper
// allocates; a second kernel, one block per (b, head), rescales the
// partials to their common maximum and writes o = acc / l.
//
// What bounds it on an H100: device memory. Per launch it must read the
// valid part of k and v, e.g. 33.6 MB at B = 4, KV = 8, hd = 128 and a
// context of 2048, against ~0.13 GFLOP of arithmetic; the workspace adds
// B * H * nsplit * (hd + 2) floats written and read once (1.1 MB there,
// nsplit = 16). The kernel is well above that bound: its time follows the
// tiles each block walks, one at a time, through a shuffle reduction per
// (position, head) and a P.V loop over shared memory, with one tile in
// flight (no cp.async pipeline).
//
// Paged variant (paged_decode_attention_fwd): the same kernel with only the
// row addressing changed. The cache is a shared pool k, v [N, P, KV, hd] of
// N pages of P positions, and block_table [B, nb] maps page i of sequence b
// to a pool page; position t of sequence b lives at row t % P of page
// block_table[b, t / P], with the same KV * hd row stride inside a page as
// the contiguous cache. P need not divide the 64-position tile: before each
// tile the block computes its 64 row offsets into shared memory (one table
// read per row), so a tile may span several pages (four at P = 16) or part
// of one. A table entry outside [0, N) is a sentinel and is clamped before
// it is dereferenced; such entries only ever cover positions at or past the
// length, which are never read anyway, so poisoned unallocated pages cannot
// reach the output. The split grid covers the table's nb * P positions and
// is sized from B, KV and nb * P alone, like the contiguous one. Bound on
// an H100: the same bytes as the contiguous kernel (the valid pages of k
// and v), plus B * nb table entries.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // cache positions per tile
constexpr int NT = 128;      // 4 warps
constexpr int NW = NT / 32;
constexpr int MAXG = 8;      // query heads per KV head
constexpr int MIN_BLOCKS = 4;  // resident split blocks per SM (BLOCKS_PER_SM
                               // in decode_attention.py sizes the grid so)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

// Partial attention of one (b, kv_head, split). Writes, for each head g of
// the group, ml = (running max m, sum l) and acc[HD] = sum_t exp(s_t - m) v_t
// over the split's positions below the length.
//
// PAGED: k and v are pools [N, P, KV, HD] reached through
// block_table [B, nb] (S = nb * P); otherwise they are [B, S, KV, HD] and
// block_table, N and P are unused.
template <typename QT, typename CT, int HD, bool PAGED>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
decode_partial(const QT* __restrict__ q, const CT* __restrict__ k,
               const CT* __restrict__ v, const int* __restrict__ lengths,
               const int* __restrict__ block_table,
               float* __restrict__ ws_acc, float* __restrict__ ws_ml,
               int H, int KV, int S, int N, int P, int split_len,
               float scale) {
  constexpr int VEC = 16 / sizeof(CT);       // cache elements per 16-byte load
  constexpr int ROWV = HD / VEC;             // 16-byte vectors per cache row
  constexpr int PL = HD / 32;                // head-dim elements per lane
  __shared__ __align__(16) CT sK[TILE * HD];
  __shared__ __align__(16) CT sV[TILE * HD];
  __shared__ float sP[MAXG][TILE];
  __shared__ float sAlpha[MAXG];
  __shared__ size_t sOff[PAGED ? TILE : 1];   // row offsets of a paged tile

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // partials of head g of this group live at (b * H + kvh * G + g, split)
  const size_t part0 = ((size_t)b * H + kvh * G) * nsplit + split;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, len);
  if (t_begin >= t_end) {            // nothing of this run is visible
    if (tid < G) {
      ws_ml[(part0 + (size_t)tid * nsplit) * 2] = -INFINITY;
      ws_ml[(part0 + (size_t)tid * nsplit) * 2 + 1] = 0.f;
    }
    return;
  }

  // this lane's slice of every query head of the group
  float qr[MAXG][PL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < PL; ++e)
      qr[g][e] = g < G ? to_f32(q[((size_t)b * H + kvh * G + g) * HD + lane * PL + e]) : 0.f;

  // softmax state: warp w owns heads w, w + NW, ...
  float m_own[MAXG / NW], l_own[MAXG / NW];
#pragma unroll
  for (int i = 0; i < MAXG / NW; ++i) { m_own[i] = -INFINITY; l_own[i] = 0.f; }

  // P.V ownership: head-dim column d of heads g0, g0 + GSTEP, ...
  constexpr int GSTEP = NT / HD;   // 1 for hd 128, 2 for hd 64
  constexpr int NACC = MAXG / GSTEP;
  const int d = tid % HD;
  const int g0 = tid / HD;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const size_t row_stride = (size_t)KV * HD;                  // elements
  // contiguous: sequence b's rows start here; paged: page offsets are
  // added per row (sOff)
  const size_t seq0 = PAGED ? 0 : (size_t)b * S * row_stride;
  const CT* kb = k + seq0 + (size_t)kvh * HD;
  const CT* vb = v + seq0 + (size_t)kvh * HD;
  const int* bt = PAGED ? block_table + (size_t)b * (S / P) : nullptr;

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    __syncthreads();   // the previous tile's readers are done
    if constexpr (PAGED) {
      // one table read per row; a sentinel (>= N) is clamped, and only
      // rows below t_end (inside allocated pages) are ever loaded
      for (int r = tid; r < TILE; r += NT) {
        const int t = min(t0 + r, t_end - 1);
        int page = bt[t / P];
        page = page < 0 ? 0 : (page >= N ? N - 1 : page);
        sOff[r] = ((size_t)page * P + t % P) * row_stride;
      }
      __syncthreads();
    }
    // rows at or past t_end are zero-filled and never read from memory
    for (int idx = tid; idx < TILE * ROWV; idx += NT) {
      const int r = idx / ROWV, c = idx % ROWV;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (t0 + r < t_end) {
        const size_t off = PAGED ? sOff[r] : (size_t)(t0 + r) * row_stride;
        kv4 = *reinterpret_cast<const uint4*>(kb + off + c * VEC);
        vv4 = *reinterpret_cast<const uint4*>(vb + off + c * VEC);
      }
      *reinterpret_cast<uint4*>(&sK[r * HD + c * VEC]) = kv4;
      *reinterpret_cast<uint4*>(&sV[r * HD + c * VEC]) = vv4;
    }
    __syncthreads();

    // scores: warp w takes positions w, w + NW, ...; the G heads' shuffle
    // reductions run interleaved, G independent chains
    for (int r = warp; r < TILE; r += NW) {
      float kr[PL];
#pragma unroll
      for (int e = 0; e < PL; ++e) kr[e] = to_f32(sK[r * HD + lane * PL + e]);
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        part[g] = 0.f;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < PL; ++e) part[g] = fmaf(qr[g][e], kr[e], part[g]);
        }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      const bool valid = t0 + r < t_end;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)   // every lane holds every sum
        if (g < G && lane == g) sP[g][r] = valid ? part[g] * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp per head
#pragma unroll
    for (int i = 0; i < MAXG / NW; ++i) {
      const int g = warp + i * NW;
      if (g < G) {
        const float s0 = sP[g][lane], s1 = sP[g][lane + 32];
        float tmax = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_own[i], tmax);   // finite: position t0 < t_end
        const float alpha = expf(m_own[i] - m_new);
        const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
        const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
        float psum = p0 + p1;
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l_own[i] = l_own[i] * alpha + psum;
        m_own[i] = m_new;
        sP[g][lane] = p0;
        sP[g][lane + 32] = p1;
        if (lane == 0) sAlpha[g] = alpha;
      }
    }
    __syncthreads();

    // P.V over the whole tile: rows past t_end have p = 0 and v = 0
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int g = g0 + i * GSTEP;
      if (g < G) acc[i] *= sAlpha[g];
    }
#pragma unroll 8
    for (int r = 0; r < TILE; ++r) {
      const float vr = to_f32(sV[r * HD + d]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int g = g0 + i * GSTEP;
        if (g < G) acc[i] = fmaf(sP[g][r], vr, acc[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAXG / NW; ++i) {
    const int g = warp + i * NW;
    if (g < G && lane == 0) {
      ws_ml[(part0 + (size_t)g * nsplit) * 2] = m_own[i];
      ws_ml[(part0 + (size_t)g * nsplit) * 2 + 1] = l_own[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int g = g0 + i * GSTEP;
    if (g < G) ws_acc[(part0 + (size_t)g * nsplit) * HD + d] = acc[i];
  }
}

// One block per (b, head): o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
// over the non-empty partials s, M their largest m. No visible position
// (length 0) gives zeros.
template <typename QT, int HD>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
               QT* __restrict__ o, int nsplit) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws_ml + (size_t)bh * nsplit * 2;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float l = 0.f, a = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float m = ml[2 * s];
      if (m == -INFINITY) continue;   // an empty split wrote no acc
      const float w = expf(m - M);
      l = fmaf(w, ml[2 * s + 1], l);
      a = fmaf(w, ws_acc[((size_t)bh * nsplit + s) * HD + d], a);
    }
  }
  from_f32(l == 0.f ? 0.f : a / l, &o[(size_t)bh * HD + d]);
}

template <typename QT, typename CT, int HD, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const int* block_table, void* o, float* ws, int B, int H, int KV,
           int S, int N, int P, int split_len, int nsplit, cudaStream_t stream) {
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)B * H * nsplit * HD;
  decode_partial<QT, CT, HD, PAGED><<<dim3(B, KV, nsplit), NT, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      lengths, block_table, ws_acc, ws_ml, H, KV, S, N, P, split_len,
      1.0f / sqrtf((float)HD));
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  decode_combine<QT, HD><<<B * H, HD, 0, stream>>>(ws_acc, ws_ml, static_cast<QT*>(o),
                                                     nsplit);
  return (int)cudaGetLastError();
}

template <typename QT, bool PAGED>
int dispatch_hd(const void* q, const void* k, const void* v, const int* lengths,
                const int* block_table, void* o, float* ws, int B, int H, int KV,
                int S, int N, int P, int hd, int split_len, int nsplit,
                cudaStream_t s) {
  if (hd == 128)
    return launch<QT, __nv_bfloat16, 128, PAGED>(q, k, v, lengths, block_table, o, ws,
                                                 B, H, KV, S, N, P, split_len, nsplit, s);
  if (hd == 64)
    return launch<QT, __nv_bfloat16, 64, PAGED>(q, k, v, lengths, block_table, o, ws,
                                                B, H, KV, S, N, P, split_len, nsplit, s);
  return -1;
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* block_table,
             const void* lengths, void* o, void* ws, int B, int H, int KV, int S,
             int N, int P, int hd, int q_dtype, int split_len, int nsplit,
             void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG) return -1;
  if (split_len <= 0 || split_len % TILE != 0 || nsplit <= 0 ||
      (long long)split_len * nsplit < S || nsplit > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int* bt = static_cast<const int*>(block_table);
  float* w = static_cast<float*>(ws);
  if (q_dtype == 0)
    return dispatch_hd<float, PAGED>(q, k, v, lens, bt, o, w, B, H, KV, S, N, P, hd,
                                     split_len, nsplit, s);
  if (q_dtype == 1)
    return dispatch_hd<__nv_bfloat16, PAGED>(q, k, v, lens, bt, o, w, B, H, KV, S, N,
                                             P, hd, split_len, nsplit, s);
  return -1;
}

}  // namespace

// The cache is bf16 (the model's cache type); q_dtype: 0 = float32,
// 1 = bfloat16. `ws` is f32 scratch of B * H * nsplit * (hd + 2) floats;
// `split_len` (a multiple of 64) times `nsplit` must cover S. Returns a
// cudaError_t value, or -1 for an unsupported head_dim, type, group size or
// split.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, void* ws, int B,
                                    int H, int KV, int S, int hd, int q_dtype,
                                    int split_len, int nsplit, void* stream) {
  return dispatch<false>(q, k, v, nullptr, lengths, o, ws, B, H, KV, S, 1, 1, hd,
                         q_dtype, split_len, nsplit, stream);
}

// Paged: k_pool, v_pool [N, P, KV, hd] bf16; block_table [B, nb] int32
// (entries outside [0, N) are sentinels); the split covers nb * P
// positions. Same scratch, types and return values as decode_attention_fwd.
extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pool,
                                          const void* v_pool, const void* block_table,
                                          const void* lengths, void* o, void* ws,
                                          int B, int H, int KV, int N, int P, int nb,
                                          int hd, int q_dtype, int split_len,
                                          int nsplit, void* stream) {
  if (N <= 0 || P <= 0 || nb <= 0) return -1;
  return dispatch<true>(q, k_pool, v_pool, block_table, lengths, o, ws, B, H, KV,
                        nb * P, N, P, hd, q_dtype, split_len, nsplit, stream);
}
