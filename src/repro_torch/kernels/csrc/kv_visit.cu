// Block-visit decode attention for Hopper (sm_90a): zone-map-pruned KV.
//
// Replaces the Pallas TPU kernel kv_visit_attention
// (src/repro/kernels/kv_visit.py), the decode attention of the model's
// kv_block_prune branch.
//
// What it computes: for each (batch b, kv head h), one token's G grouped
// query rows attend over only the key blocks listed in ids[b, h, :]
// (-1 = padding: reads block 0, masked). Key t of listed block blk is valid
// when blk >= 0 and blk * bs + t <= pos[b]; a masked key scores the finite
// fill `neg` (0.7 * the most negative bfloat16), not -inf, so a list with no
// valid key at all gives the uniform average of its values, as the
// reference's softmax does. Scores and softmax in float32 for both input
// types; the output (B, KV, G, hd) takes q's type.
//
// What bounds it on this card: device-memory bytes. Each (b, h) reads
// n_visit * bs key rows and as many value rows of hd elements; the
// arithmetic is 4 * G * hd flops per key, far below the card's rate at
// G <= 8 (too few rows for wgmma: CUDA-core FMAs).
//
// Design.
// - The cache is read in place. The model's cache is token-major
//   (B, S, KV, hd); the caller passes its block-major view (B, KV, nb, bs,
//   hd) with 64-bit element strides per axis; the last axis must be
//   contiguous and each row 16-byte aligned. No copy of the cache, selected
//   or not, is ever made.
// - Occupancy: the TPU grid walks one (b, h)'s visits in order on one core.
//   Here the visit list is split flash-decoding style: one thread block per
//   (b, h, visit, tile of `tile` keys) computes a partial (m, l, acc) in
//   float32, and a second kernel (one block per (b, h, g), one thread per
//   element) merges the partials in split order. No float atomics: repeated
//   calls are bit-identical. At the long-context shape (B = 4, KV = 8, 16
//   visits of 512 keys, tiles of 128) that is 2,048 blocks instead of 32.
// - Bytes in flight: a block first issues cp.async copies of its tile's live
//   K and V rows into shared memory (up to 2 x 32 KB, 16 bytes a request,
//   consecutive threads on consecutive bytes), so three blocks per SM keep
//   ~190 KB of loads in flight and no register waits on a row.
// - Arithmetic: see kv_visit_split_kernel (a transposing butterfly scores 32
//   (key, row) pairs per warp with 31 shuffles). The warps' (m, l, acc)
//   merge through shared memory.
// - Valid keys of a tile are a prefix (slots grow with t), so only they are
//   read; the rest weigh exactly exp(neg - m) = 0 once any key is valid.
//   A tile with no valid key reads nothing and adds nothing, unless no key
//   of the whole list is valid: then every listed key scores `neg` and its
//   value row is read, as in the reference.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_BYTES = 32 * 1024;  // K (or V) rows of one thread block

struct Strides {
  long long b, h, n, t;  // elements between batches, heads, blocks, keys
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy rows [0, rows) of hd elements (stride `ts` elements) into smem,
// 16 bytes per thread and request: consecutive threads, consecutive bytes.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long ts, int rows,
                                           int hd) {
  const int per_row = hd * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = i % per_row;
    cp_async16(reinterpret_cast<char*>(dst + r * hd) + 16 * c,
               reinterpret_cast<const char*>(src + r * ts) + 16 * c);
  }
}

// Transposing butterfly over a warp: every lane holds 32 partial sums, and
// afterwards lane l holds in pv[0] the full sum over the warp of entry l
// (16 + 8 + 4 + 2 + 1 = 31 shuffles, against 5 per entry reduced alone).
template <int O>
__device__ __forceinline__ void butterfly(float (&pv)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int jj = 0; jj < O; ++jj) {
    const float send = up ? pv[jj] : pv[jj + O];
    const float keep = up ? pv[jj + O] : pv[jj];
    pv[jj] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) butterfly<O / 2>(pv, lane);
}

// part: (n_split, B * KV, G, hd + 2) float32 — acc[hd], then m, then l.
//
// A warp takes chunks of KC = 32 / GMAX keys: each lane holds EPL = hd / 32
// elements of every query row and forms the KC x GMAX partial dot products
// over its slice of the staged key rows; one transposing butterfly (31
// shuffles) leaves the full product (key i, row g) in lane i * GMAX + g, so
// each lane scores one (key, row) pair. The lanes of a row then reduce max
// and sum over the chunk's keys, and the probabilities reach every lane
// through shared memory for the value update.
template <typename T, int EPL, int GMAX>
__global__ void __launch_bounds__(THREADS)
kv_visit_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ ids,
                      const int* __restrict__ pos, float* __restrict__ part,
                      int kv_heads, int g_n, int nb, int bs, int n_visit, int tile,
                      int tiles, Strides ks, Strides vs, float scale, float neg) {
  constexpr int HD = EPL * 32;
  constexpr int KC = 32 / GMAX;  // keys per warp chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + tile * HD;
  float* sp = reinterpret_cast<float*>(sv + tile * HD);  // (WARPS, 32) probabilities
  float* sc = sp + WARPS * 32;                          // (WARPS, GMAX) corrections

  const int split = blockIdx.x;  // visit * tiles + tile index
  const int bk = blockIdx.y;     // b * kv_heads + h
  const int b = bk / kv_heads, h = bk % kv_heads;
  const int j = split / tiles, t0 = (split % tiles) * tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* my_ids = ids + static_cast<int64_t>(bk) * n_visit;
  const long long p = pos[b];

  // Is any key of the whole list valid? It decides what a masked tile adds.
  int any = 0;
  for (int i = threadIdx.x; i < n_visit; i += THREADS) {
    const int id = my_ids[i];
    any |= id >= 0 && static_cast<long long>(id) * bs <= p;
  }
  any = __syncthreads_or(any);

  const int raw = my_ids[j];
  const int blk = min(max(raw, 0), nb - 1);
  const int len = min(tile, bs - t0);
  const bool uniform = !any;  // every listed key scores `neg`
  int live;                   // keys taking part: a prefix of the tile
  if (uniform) {
    live = len;
  } else if (raw < 0) {
    live = 0;
  } else {
    const long long first = static_cast<long long>(blk) * bs + t0;
    live = static_cast<int>(max(0LL, min(static_cast<long long>(len), p - first + 1)));
  }

  // Stage the live rows: no register holds a row while it is in flight.
  const long long row0 = t0;
  if (!uniform) stage_rows(sk, k + b * ks.b + h * ks.h + blk * ks.n + row0 * ks.t, ks.t, live, HD);
  stage_rows(sv, v + b * vs.b + h * vs.h + blk * vs.n + row0 * vs.t, vs.t, live, HD);
  asm volatile("cp.async.commit_group;\n" ::);

  float qr[GMAX][EPL];
  const T* qb = q + static_cast<int64_t>(bk) * g_n * HD + lane * EPL;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = g < g_n ? to_f(qb[g * HD + e]) : 0.f;

  // Lane (i, g) = (lane / GMAX, lane % GMAX) keeps row g's running max and
  // sum (the same in every lane of the row); every lane keeps acc[g][e].
  const int my_i = lane / GMAX, my_g = lane % GMAX;
  float m_run = neg, l_run = 0.f;
  float acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;

  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int c = warp * KC; c < live; c += WARPS * KC) {
    const int n = min(KC, live - c);
    float pv[32];
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      float kf[EPL];
      const T* kr = sk + (c + i) * HD + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = (!uniform && i < n) ? to_f(kr[e]) : 0.f;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
        pv[i * GMAX + g] = d;
      }
    }
    butterfly<16>(pv, lane);
    const bool on = my_i < n && my_g < g_n;
    const float s = on ? (uniform ? neg : pv[0] * scale) : -INFINITY;
    float mx = s;
#pragma unroll
    for (int o = GMAX; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    const float pr = expf(s - m_new);
    float ps = pr;
#pragma unroll
    for (int o = GMAX; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l_run = l_run * corr + ps;
    m_run = m_new;
    sp[warp * 32 + lane] = pr;
    if (my_i == 0) sc[warp * GMAX + my_g] = corr;
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= g_n) continue;
      const float cg = sc[warp * GMAX + g];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= cg;
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      if (i >= n) continue;
      const T* vr = sv + (c + i) * HD + lane * EPL;
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = to_f(vr[e]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= g_n) continue;
        const float pg = sp[warp * 32 + i * GMAX + g];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
    __syncwarp();
  }

  // Merge the warps' partials, in warp order, through the (now free) tile.
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);   // (WARPS, g_n, HD)
  float* sm_ml = sm_acc + WARPS * g_n * HD;         // (WARPS, g_n, 2)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= g_n) continue;
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(warp * g_n + g) * HD + lane * EPL + e] = acc[g][e];
  }
  if (my_i == 0 && my_g < g_n) {
    sm_ml[(warp * g_n + my_g) * 2] = m_run;
    sm_ml[(warp * g_n + my_g) * 2 + 1] = l_run;
  }
  __syncthreads();
  const int64_t bkv = gridDim.y;
  float* out = part + (static_cast<int64_t>(split) * bkv + bk) * g_n * (HD + 2);
  for (int idx = threadIdx.x; idx < g_n * HD; idx += THREADS) {
    const int g = idx / HD, d = idx % HD;
    float mm = sm_ml[g * 2];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, sm_ml[(w * g_n + g) * 2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float cw = expf(sm_ml[(w * g_n + g) * 2] - mm);
      ll = fmaf(sm_ml[(w * g_n + g) * 2 + 1], cw, ll);
      aa = fmaf(sm_acc[(w * g_n + g) * HD + d], cw, aa);
    }
    float* o = out + g * (HD + 2);
    o[d] = aa;
    if (d == 0) {
      o[HD] = mm;
      o[HD + 1] = ll;
    }
  }
}

// One thread block per (b, h, g), one thread per element of the head: the
// n_split partials merged in split order.
template <typename T>
__global__ void kv_visit_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                                      int g_n, int n_split) {
  const int hd = blockDim.x, d = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (hd + 2);  // (b, h, g)
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (hd + 2);  // between splits
  const float* p = part + row;
  float mm = p[hd];
  for (int s = 1; s < n_split; ++s) mm = fmaxf(mm, p[s * stride + hd]);
  float ll = 0.f, aa = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float* ps = p + s * stride;
    const float cw = expf(ps[hd] - mm);
    ll = fmaf(ps[hd + 1], cw, ll);
    aa = fmaf(ps[d], cw, aa);
  }
  store(out + static_cast<int64_t>(blockIdx.x) * hd + d, aa / fmaxf(ll, 1e-30f));
}

template <typename T, int EPL, int GMAX>
cudaError_t run(const void* q, const void* k, const void* v, const int* ids,
                const int* pos, void* out, float* part, int bkv, int kv_heads,
                int g_n, int nb, int bs, int n_visit, int tile, Strides ks, Strides vs,
                float scale, float neg, cudaStream_t stream) {
  constexpr int HD = EPL * 32;
  const int tiles = (bs + tile - 1) / tile;
  const long long n_split = static_cast<long long>(n_visit) * tiles;
  if (n_split > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t rows = 2 * static_cast<size_t>(tile) * HD * sizeof(T);
  const size_t merge = static_cast<size_t>(WARPS) * g_n * (HD + 2) * sizeof(float);
  const size_t smem = (rows > merge ? rows : merge) + WARPS * (32 + GMAX) * sizeof(float);
  auto kernel = kv_visit_split_kernel<T, EPL, GMAX>;
  MDRQ_TRY(mdrq::allow_smem(kernel, smem));
  const dim3 grid(static_cast<unsigned>(n_split), static_cast<unsigned>(bkv));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ids,
      pos, part, kv_heads, g_n, nb, bs, n_visit, tile, tiles, ks, vs, scale, neg);
  MDRQ_TRY(cudaGetLastError());
  kv_visit_merge_kernel<T><<<bkv * g_n, HD, 0, stream>>>(part, static_cast<T*>(out), g_n,
                                                         static_cast<int>(n_split));
  return cudaGetLastError();
}

template <typename T, int EPL>
cudaError_t by_group(int g_n, const void* q, const void* k, const void* v,
                     const int* ids, const int* pos, void* out, float* part, int bkv,
                     int kv_heads, int nb, int bs, int n_visit, int tile, Strides ks,
                     Strides vs, float scale, float neg, cudaStream_t stream) {
  if (g_n <= 4)
    return run<T, EPL, 4>(q, k, v, ids, pos, out, part, bkv, kv_heads, g_n, nb, bs,
                          n_visit, tile, ks, vs, scale, neg, stream);
  return run<T, EPL, 8>(q, k, v, ids, pos, out, part, bkv, kv_heads, g_n, nb, bs,
                        n_visit, tile, ks, vs, scale, neg, stream);
}

template <typename T>
cudaError_t by_head_dim(int hd, int g_n, const void* q, const void* k, const void* v,
                        const int* ids, const int* pos, void* out, float* part,
                        int bkv, int kv_heads, int nb, int bs, int n_visit, int tile,
                        Strides ks, Strides vs, float scale, float neg,
                        cudaStream_t stream) {
#define KV_VISIT_HD(EPL)                                                               \
  return by_group<T, EPL>(g_n, q, k, v, ids, pos, out, part, bkv, kv_heads, nb, bs, \
                          n_visit, tile, ks, vs, scale, neg, stream)
  switch (hd) {
    case 32: KV_VISIT_HD(1);
    case 64: KV_VISIT_HD(2);
    case 128: KV_VISIT_HD(4);
    case 256: KV_VISIT_HD(8);
    default: return cudaErrorInvalidValue;
  }
#undef KV_VISIT_HD
}

}  // namespace

// q, out: (B, KV, G, hd) contiguous; k, v: (B, KV, nb, bs, hd) with element
// strides (b, h, n, t), a contiguous last axis and 16-byte aligned rows;
// ids: (B, KV, n_visit) i32 contiguous; pos: (B,) i32; `tile` keys per thread
// block, with tile * hd * sizeof(element) <= 32 KB; part: (n_visit *
// ceil(bs / tile), B * KV, G, hd + 2) f32 scratch. bf16 != 0: q, k, v and out
// are bfloat16, else f32.
extern "C" int mdrq_kv_visit_attention(
    const void* q, const void* k, const void* v, const int* ids, const int* pos,
    void* out, float* part, int bf16, int batch, int kv_heads, int g_n, int hd, int nb,
    int bs, int n_visit, int tile, long long ksb, long long ksh, long long ksn,
    long long kst, long long vsb, long long vsh, long long vsn, long long vst,
    float scale, float neg, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  const long long bkv = static_cast<long long>(batch) * kv_heads;
  const long long elem = bf16 ? 2 : 4;
  if (g_n < 1 || g_n > 8 || nb < 1 || bs < 1 || n_visit < 1 || bkv < 1 ||
      bkv > 65535 || tile < 1 || tile * hd * elem > TILE_BYTES)
    return cudaErrorInvalidValue;
  const Strides ks{ksb, ksh, ksn, kst}, vs{vsb, vsh, vsn, vst};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_head_dim<__nv_bfloat16>(hd, g_n, q, k, v, ids, pos, out, part,
                                      static_cast<int>(bkv), kv_heads, nb, bs, n_visit,
                                      tile, ks, vs, scale, neg, st);
  return by_head_dim<float>(hd, g_n, q, k, v, ids, pos, out, part, static_cast<int>(bkv),
                            kv_heads, nb, bs, n_visit, tile, ks, vs, scale, neg, st);
}

MDRQ_ERROR_STRING_FN
