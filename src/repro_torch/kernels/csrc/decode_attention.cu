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
// What bounds it on an H100: device memory. A call must read the valid
// part of k and v, e.g. 33.6 MB at B = 4, KV = 8, hd = 128 and a context of
// 2048 (10.0 us at 3.35 TB/s), against ~0.13 GFLOP of arithmetic. So the
// design keeps many loads in flight and the arithmetic off their path, in
// one launch:
// - Grid (B, KV, nsplit): a block takes one (b, kv_head) and one run of
//   `split_len` positions (a multiple of the 32-position TILE). It holds all
//   G = H / KV query heads of its GQA group, so each cache row is read once
//   for the whole group, as the Pallas program does. The wrapper picks
//   nsplit from B, KV and S alone (decode_splits; never from the lengths,
//   so a decode step does not wait for the device): each block reads
//   lengths[b] itself, and a run at or past the length does no work.
// - The block walks its run in tiles of 32 positions through a ring of 4
//   stages of K and V rows in shared memory, filled by cp.async: three
//   tiles in flight while one is computed. Rows at or past the length are
//   zero-filled by a copy of src-size 0 and never read. A staged row is
//   stored whole, its 16-byte chunks permuted in odd rows, so the score
//   reads below hit 32 different banks.
// - 8 warps: warps w and w + 4 own head w (and w + 4 when G > 4), each
//   over one half of every tile, with q held in registers in f32 (the
//   Pallas kernel's casts). Scores: 4 lanes per position, each dotting a
//   quarter of the row (8 bf16 elements at a time, widened to f32); two
//   shuffles join the quarters. Online softmax per head in f32 over the
//   half's 16 positions (three shuffles), then P.V in registers: each
//   lane owns hd / 32 columns of its heads and reads each V row once; a
//   row's probability comes from the lanes that scored it by one shuffle,
//   never through shared memory. A warp's dependent chain per tile is 16
//   positions long, and 16 warps per SM hide it.
// - At the end the two halves of each head meet in shared memory. With
//   nsplit > 1 each block writes its partial (m, l, acc) to the
//   workspace; the last block of each (b, kv_head) to arrive, found by an
//   atomic counter in the workspace (which that block resets to 0),
//   combines the partials in split order and writes o. The result is the
//   same whichever block arrives last, and no second launch is needed.
//
// Paged variant (paged_decode_attention_fwd): the same kernel with only the
// row addressing changed. The cache is a shared pool k, v [N, P, KV, hd] of
// N pages of P positions, and block_table [B, nb] maps page i of sequence b
// to a pool page; position t of sequence b lives at row t % P of page
// block_table[b, t / P], with the same KV * hd row stride inside a page as
// the contiguous cache. Any P works: each thread reads the pages of the
// rows it copies of the next tile while the block computes the tile before
// it (the table read is off the copies' path). A table
// entry outside [0, N) is a sentinel and is clamped before it is
// dereferenced; such entries only ever cover positions at or past the
// length, which are never read anyway, so poisoned unallocated pages cannot
// reach the output. The split covers the table's nb * P positions. Bound on
// an H100: the same bytes as the contiguous kernel (the valid pages of k and
// v), plus B * nb table entries.
//
// Interface: plain C, launched on the caller's stream; returns the CUDA
// error code after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;              // warps per block
constexpr int NT = NW * 32;
constexpr int HEADS = 4;           // head slots: warps w and w + 4 share one
constexpr int TILE = 32;           // cache positions per stage; split_len unit
constexpr int HALF = TILE / 2;     // positions of a tile per warp
constexpr int STAGES = 4;          // ring depth
constexpr int LPP = 4;             // lanes per position in the scores
constexpr int PASS = 32 / LPP;     // positions per pass of a warp
constexpr int MAXG = 8;            // query heads per KV head
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one instance: a ring of K and V tiles. A staged row is
// stored whole, its 16-byte chunk c at c ^ 4 in odd rows, so the score
// reads below hit 32 different banks.
template <int HD>
struct Layout {
  static constexpr int CHUNKS = HD / 8;      // 16-byte chunks per cache row
  static constexpr int CPL = CHUNKS / LPP;   // chunks per lane in the scores
  static constexpr int EPL = HD / 32;        // P.V columns per lane
  static constexpr int STAGE = TILE * HD;    // bf16 elements of one stage
  static constexpr int ROWS = TILE * CHUNKS / NT;   // rows a thread copies
  static constexpr int BYTES = 2 * STAGES * STAGE * 2;
  static_assert(STAGES * STAGE * 2 >= HEADS * (MAXG / HEADS) * (HD + 2) * 4,
                "the halves meet in a ring");
};

__device__ __forceinline__ int swz(int row, int chunk) { return chunk ^ ((row & 1) << 2); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16 to f32: the low half of a 32-bit word is the first element
__device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Attention of one (b, kv_head, split). Warps w and w + HEADS own query
// heads w, w + HEADS, ... of the group (GT of them, the last ones past G
// computed on zeros and dropped), each over its half of every tile. Workspace (nsplit > 1): B * H int counters, zero on entry and
// left zero; then acc [B, H, nsplit, HD] and (m, l) [B, H, nsplit, 2] in
// f32.
//
// PAGED: k and v are pools [N, P, KV, HD] reached through
// block_table [B, nb] (S = nb * P); otherwise they are [B, S, KV, HD] and
// block_table, N and P are unused.
template <typename QT, int HD, int GT, bool PAGED>
__global__ void __launch_bounds__(NT, 2)
decode_kernel(const QT* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
              const int* __restrict__ block_table, QT* __restrict__ o,
              float* __restrict__ ws, int H, int KV, int S, int N, int P,
              int split_len, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + STAGES * L::STAGE;
  __shared__ bool s_last;

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.x, nsplit = gridDim.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh0 = (size_t)b * H + (size_t)kvh * G;   // first head of the group

  // this warp's heads: q in registers, chunks j, j + 4, ... (f32; zeros for
  // a head past G), loaded first: nothing below waits for them
  const int hs = warp % HEADS, half = warp / HEADS;
  const int p = lane / LPP, j = lane % LPP;   // scores: position p, quarter j
  bool has[GT];
  float qr[GT][L::CPL][8];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    const int g = hs + HEADS * h;
    has[h] = g < G;
#pragma unroll
    for (int cc = 0; cc < L::CPL; ++cc)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qr[h][cc][e] = has[h] ? to_f32(q[(bh0 + g) * HD + (j + LPP * cc) * 8 + e]) : 0.f;
  }
  const bool busy = has[0];          // warp-uniform: a warp with no head idles

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, len);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + TILE - 1) / TILE : 0;

  const size_t row_stride = (size_t)KV * HD;
  const size_t seq0 = PAGED ? 0 : (size_t)b * S * row_stride;
  const __nv_bfloat16* kb = k + seq0 + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + seq0 + (size_t)kvh * HD;
  const int* bt = PAGED ? block_table + (size_t)b * (S / P) : nullptr;

  // A thread copies 16-byte chunk tid % CHUNKS of rows tid / CHUNKS + i *
  // (NT / CHUNKS) of every tile. Paged: the pool pages of those rows for
  // the next tile are read while the tile before it is computed (clamped to
  // the last visible position, whose page is allocated; sentinels clamped).
  const int my_col = tid % L::CHUNKS;
  int pages[L::ROWS], pages_next[L::ROWS];
  auto fetch_pages = [&](int t) {
#pragma unroll
    for (int i = 0; i < L::ROWS; ++i) {
      const int r = tid / L::CHUNKS + i * (NT / L::CHUNKS);
      const int pos = min(t_begin + t * TILE + r, t_end - 1);
      const int page = bt[pos / P];
      pages_next[i] = page < 0 ? 0 : (page >= N ? N - 1 : page);
    }
  };
  if (PAGED && ntiles > 0) fetch_pages(0);

  // tile t into stage t % STAGES; one commit group per call, empty or not
  auto issue = [&](int t) {
    if (t < ntiles) {
      if constexpr (PAGED) {
#pragma unroll
        for (int i = 0; i < L::ROWS; ++i) pages[i] = pages_next[i];
        if (t + 1 < ntiles) fetch_pages(t + 1);
      }
      const int t0 = t_begin + t * TILE;
      __nv_bfloat16* dk = sK + (t % STAGES) * L::STAGE;
      __nv_bfloat16* dv = sV + (t % STAGES) * L::STAGE;
#pragma unroll
      for (int i = 0; i < L::ROWS; ++i) {
        const int r = tid / L::CHUNKS + i * (NT / L::CHUNKS);
        const bool ok = t0 + r < t_end;
        const int pos = ok ? t0 + r : t_end - 1;
        const size_t off = PAGED ? ((size_t)pages[i] * P + pos % P) * row_stride
                                 : (size_t)pos * row_stride;
        const int at = r * HD + swz(r, my_col) * 8;
        cp_async16(dk + at, kb + off + my_col * 8, ok);
        cp_async16(dv + at, vb + off + my_col * 8, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float m_run[GT], l_run[GT], acc[GT][L::EPL];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
#pragma unroll
    for (int e = 0; e < L::EPL; ++e) acc[h][e] = 0.f;
  }

  const int vcol = lane * L::EPL;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile t landed
    __syncthreads();               // ... and every thread's; tile t - 1 is done
    issue(t + STAGES - 1);         // into the stage tile t - 1 used
    if (!busy) continue;
    const __nv_bfloat16* ck = sK + (t % STAGES) * L::STAGE;
    const __nv_bfloat16* cv = sV + (t % STAGES) * L::STAGE;
    const int t0 = t_begin + t * TILE;

    // q . k for positions p, p + 8 of the warp's half of the tile, each over
    // this lane's chunks; the quarters meet over lanes xor 1, 2
    float sc[HALF / PASS][GT];
#pragma unroll
    for (int pp = 0; pp < HALF / PASS; ++pp) {
      const int r = HALF * half + p + PASS * pp;
      float s[GT];
#pragma unroll
      for (int h = 0; h < GT; ++h) s[h] = 0.f;
#pragma unroll
      for (int cc = 0; cc < L::CPL; ++cc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ck + r * HD + swz(r, j + LPP * cc) * 8);
        const float kf[8] = {lo_f32(raw.x), hi_f32(raw.x), lo_f32(raw.y), hi_f32(raw.y),
                             lo_f32(raw.z), hi_f32(raw.z), lo_f32(raw.w), hi_f32(raw.w)};
#pragma unroll
        for (int h = 0; h < GT; ++h)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[h] = fmaf(qr[h][cc][e], kf[e], s[h]);
      }
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        s[h] += __shfl_xor_sync(FULL, s[h], 1);
        s[h] += __shfl_xor_sync(FULL, s[h], 2);
        sc[pp][h] = t0 + r < t_end ? s[h] * scale : -INFINITY;
      }
    }

    // online softmax over the half's positions (lanes xor 4, 8, 16 hold the
    // other p); a half wholly past the length changes nothing. sc[pp][h]
    // becomes the probability of position p + PASS * pp, in every lane
    // of the position.
    float alpha[GT];
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      float mx = sc[0][h];
#pragma unroll
      for (int pp = 1; pp < HALF / PASS; ++pp) mx = fmaxf(mx, sc[pp][h]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = m_new == -INFINITY ? 1.f : expf(m_run[h] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int pp = 0; pp < HALF / PASS; ++pp) {
        sc[pp][h] = sc[pp][h] == -INFINITY ? 0.f : expf(sc[pp][h] - m_new);
        ps += sc[pp][h];
      }
      ps += __shfl_xor_sync(FULL, ps, 4);
      ps += __shfl_xor_sync(FULL, ps, 8);
      ps += __shfl_xor_sync(FULL, ps, 16);
      l_run[h] = l_run[h] * alpha[h] + ps;
      m_run[h] = m_new;
    }

    // P.V: columns lane * EPL ... of this warp's heads; row rr's
    // probability is shuffled from lane LPP * (rr % PASS); rows past the
    // length have p = 0 and v = 0
#pragma unroll
    for (int h = 0; h < GT; ++h)
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) acc[h][e] *= alpha[h];
#pragma unroll
    for (int rr = 0; rr < HALF; ++rr) {
      const int r = HALF * half + rr;
      const __nv_bfloat16* vr = cv + r * HD + swz(r, vcol / 8) * 8 + vcol % 8;
      float vf[L::EPL];
      if constexpr (L::EPL == 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(vr);
        vf[0] = lo_f32(raw.x);
        vf[1] = hi_f32(raw.x);
        vf[2] = lo_f32(raw.y);
        vf[3] = hi_f32(raw.y);
      } else {
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(vr);
        vf[0] = lo_f32(raw);
        vf[1] = hi_f32(raw);
      }
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        const float ph = __shfl_sync(FULL, sc[rr / PASS][h], LPP * (rr % PASS));
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) acc[h][e] = fmaf(ph, vf[e], acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();

  // the two halves of each head meet in shared memory (over the K ring):
  // the second half's (m, l, acc), then the first half adds it in
  __syncthreads();
  float* cAcc = reinterpret_cast<float*>(smem);           // [HEADS][GT][HD]
  float* cML = cAcc + HEADS * GT * HD;                     // [HEADS][GT][2]
  if (half == 1 && busy) {
#pragma unroll
    for (int h = 0; h < GT; ++h) {
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) cAcc[(hs * GT + h) * HD + vcol + e] = acc[h][e];
      if (lane == 0) {
        cML[(hs * GT + h) * 2] = m_run[h];
        cML[(hs * GT + h) * 2 + 1] = l_run[h];
      }
    }
  }
  __syncthreads();

  // this block's result for each of the slot's heads: o itself, or its
  // partial for the combine
  int* counters = reinterpret_cast<int*>(ws);
  float* ws_acc = ws + (size_t)B * H;
  float* ws_ml = ws_acc + (size_t)B * H * nsplit * HD;
  if (half == 0 && busy) {
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      if (!has[h]) continue;
      const float m1 = cML[(hs * GT + h) * 2], l1 = cML[(hs * GT + h) * 2 + 1];
      const float M = fmaxf(m_run[h], m1);
      const float w0 = m_run[h] == -INFINITY ? 0.f : expf(m_run[h] - M);
      const float w1 = m1 == -INFINITY ? 0.f : expf(m1 - M);
      const float l = l_run[h] * w0 + l1 * w1;
      const size_t head = bh0 + hs + HEADS * h;
      const size_t part = head * nsplit + split;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        const float a = acc[h][e] * w0 + cAcc[(hs * GT + h) * HD + vcol + e] * w1;
        if (nsplit == 1)
          from_f32(l == 0.f ? 0.f : a / l, &o[head * HD + vcol + e]);
        else
          ws_acc[part * HD + vcol + e] = a;
      }
      if (nsplit > 1 && lane == 0) {
        ws_ml[part * 2] = M;
        ws_ml[part * 2 + 1] = l;
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (b, kv_head) combines the splits, in order
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)b * KV + kvh;
  if (tid == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD, dd = idx % HD;
    const size_t part0 = (bh0 + g) * nsplit;
    float M = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, __ldcg(ws_ml + (part0 + sp) * 2));
    float l = 0.f, a = 0.f;
    if (M != -INFINITY) {
      for (int sp = 0; sp < nsplit; ++sp) {
        const float m = __ldcg(ws_ml + (part0 + sp) * 2);
        if (m == -INFINITY) continue;      // an empty split
        const float wt = expf(m - M);
        l = fmaf(wt, __ldcg(ws_ml + (part0 + sp) * 2 + 1), l);
        a = fmaf(wt, __ldcg(ws_acc + (part0 + sp) * HD + dd), a);
      }
    }
    from_f32(l == 0.f ? 0.f : a / l, &o[(bh0 + g) * HD + dd]);
  }
  if (tid == 0) *counter = 0;
}

template <typename QT, int HD, int GT, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const int* block_table, void* o, float* ws, int B, int H, int KV,
           int S, int N, int P, int split_len, int nsplit, cudaStream_t stream) {
  auto* kernel = decode_kernel<QT, HD, GT, PAGED>;
  // above 48 KB of dynamic shared memory a kernel has to ask, once per
  // device
  static bool asked[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return -1;
  if (!asked[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::BYTES);
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
  kernel<<<dim3(B, KV, nsplit), NT, Layout<HD>::BYTES, stream>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, block_table,
      static_cast<QT*>(o), ws, H, KV, S, N, P, split_len, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// one head per warp pair up to G = 4, two up to 8
template <typename QT, int HD, bool PAGED>
int dispatch_g(const void* q, const void* k, const void* v, const int* lengths,
               const int* block_table, void* o, float* ws, int B, int H, int KV,
               int S, int N, int P, int split_len, int nsplit, cudaStream_t s) {
  if (H / KV <= HEADS)
    return launch<QT, HD, 1, PAGED>(q, k, v, lengths, block_table, o, ws, B, H, KV,
                                    S, N, P, split_len, nsplit, s);
  return launch<QT, HD, MAXG / HEADS, PAGED>(q, k, v, lengths, block_table, o, ws, B, H,
                                          KV, S, N, P, split_len, nsplit, s);
}

template <typename QT, bool PAGED>
int dispatch_hd(const void* q, const void* k, const void* v, const int* lengths,
                const int* block_table, void* o, float* ws, int B, int H, int KV,
                int S, int N, int P, int hd, int split_len, int nsplit,
                cudaStream_t s) {
  if (hd == 128)
    return dispatch_g<QT, 128, PAGED>(q, k, v, lengths, block_table, o, ws, B, H,
                                      KV, S, N, P, split_len, nsplit, s);
  if (hd == 64)
    return dispatch_g<QT, 64, PAGED>(q, k, v, lengths, block_table, o, ws, B, H,
                                     KV, S, N, P, split_len, nsplit, s);
  return -1;
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* block_table,
             const void* lengths, void* o, void* ws, int B, int H, int KV, int S,
             int N, int P, int hd, int q_dtype, int split_len, int nsplit,
             void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || KV > 65535 || H % KV != 0 ||
      H / KV > MAXG)
    return -1;
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
// 1 = bfloat16. `ws` is scratch of B * H * (1 + nsplit * (hd + 2)) 4-byte
// words whose first B * H (the split counters) are zero, and are zero
// again when the kernel ends; with nsplit 1 it is not touched. `split_len`
// (a multiple of 32) times `nsplit` must cover S. Returns a cudaError_t
// value, or -1 for an unsupported head_dim, type, group size or split.
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
