// Block-visit decode attention for Hopper (sm_90a): zone-map-pruned KV.
//
// Replaces the Pallas TPU kernel kv_visit_attention
// (src/repro/kernels/kv_visit.py), the decode attention of the model's
// kv_block_prune branch.
//
// What it computes: for each (batch b, kv head h), one token's G grouped
// query rows attend over only the key blocks listed in ids[b, h, :]
// (-1 = padding). Key t of listed block blk is valid when blk >= 0 and
// blk * bs + t <= pos[b]; a masked key scores the finite fill `neg` (0.7 *
// the most negative bfloat16), not -inf, so a list with no valid key at all
// gives the uniform average of every listed key's value row (padding reads
// block 0), as the reference's softmax does. Repeated ids count twice.
// Scores and softmax in float32 for both input types; the output (B, KV,
// G, hd) takes q's type.
//
// What bounds it on this card: device-memory bytes. Each (b, h) reads its
// valid key rows and as many value rows of hd elements once; 4 * G * hd
// flops per key is far below the tensor cores' rate.
//
// Design: one launch, one kernel, a few long streams per (b, h).
// - The cache is read in place: the model's cache is token-major (B, S, KV,
//   hd) and the caller passes its block-major view (B, KV, nb, bs, hd) with
//   64-bit element strides (last axis contiguous, rows 16-byte aligned).
//   ids (int64 or int32) and pos (int64 or int32) are read as they come, so
//   the wrapper launches no cast kernel.
// - Split-KV: the list's (visit, key) positions are cut into tiles of TK
//   keys (a tile never crosses a listed block) and the tiles into n_split
//   contiguous runs of `tps` tiles, one thread block each. The wrapper's
//   split_plan fills one wave of one block per SM (4 splits of 32 tiles at
//   B = 4, KV = 8, 16 visits of 512 keys: 128 blocks of 2,048 keys); two
//   blocks fit an SM, but on an H100 a block streams faster alone. A list
//   of at most 4 tiles is one block (no merge).
// - A ring of STAGES tiles in shared memory, filled by cp.async two tiles
//   ahead of the compute (commit groups, one __syncthreads per tile): at
//   the shape above a block keeps 64 KB of K/V loads in flight. Only the
//   valid prefix of a tile is read; the rows up to the next multiple of 16
//   are zero-filled (cp.async with 0 source bytes) so the tensor-core
//   tiles never see stale shared memory. A tile of padding, or past pos,
//   reads nothing and is skipped, unless no key of the whole list is
//   valid. Each staged row is padded by 16 bytes, so the 8 rows of every
//   ldmatrix fall in 8 distinct bank groups.
// - bf16 arithmetic on tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), one warp per 16 keys of a tile. Scores: M = the query rows
//   (G <= 8, padded to 16 with zero rows), N = keys, K = hd; q's fragments
//   stay in registers and K's come by ldmatrix. Then P.V: M = query rows,
//   N = hd, K = the 16 keys, V's fragments by ldmatrix.trans. The score
//   accumulator of the first product is, register for register, the A
//   fragment of the second (FlashAttention-2's layout), so probabilities
//   never leave registers and no lane exchanges them; only the row max
//   takes two shuffles. Probabilities enter P.V as a bf16 pair and its
//   bf16 residual (two products; 16 bits of each probability, where one
//   bf16 rounding doubled the error against the plain version); their sum
//   l stays float32. The zero rows and the residual products cost ~4 us of
//   tensor-core time at the shape above against ~40 us of bytes.
// - float32 keeps exact float32 FMAs on CUDA cores (no TF32): a warp takes
//   every WARPS-th key of a tile, each lane hd / 32 elements of the row,
//   and a shuffle sum gives each row's score.
// - The merge is inside the kernel, in a fixed order, without float
//   atomics, so repeated calls are bit-identical; a merge by ticket: each
//   block merges its warps' (m, l, acc) in warp order and writes the
//   result to `part`; the last block of a (b, h) to finish, told by an
//   integer ticket (atomicAdd after a __threadfence), merges the n_split
//   partials in split order and sets the ticket back to 0. Partials are
//   n_split * G * (hd + 2) floats per (b, h) (0.27 MB at the shape above),
//   read back from L2. A thread-block cluster per (b, h) merging through
//   distributed shared memory needs no scratch, but on an H100 clusters of
//   4 to 8 of these blocks could not all be resident at once (a second
//   wave), so its split count would have to follow the card's GPC layout.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;      // ring depth: two tiles in flight while one computes
constexpr int MAX_SPLIT = 32;  // blocks per (b, h)
constexpr int MAX_GROUP = 8;  // query rows per kv head
constexpr int PAD = 16;       // bytes after each staged row

struct Strides {
  long long b, h, n, t;  // elements between batches, heads, blocks, keys
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ids;
  const void* pos;
  void* out;
  float* part;   // (n_split, B * KV, G, HD + 2) partials (n_split > 1)
  int* tickets;  // (B * KV,) zeros between calls
  Strides ks, vs;
  int ids64, pos64;  // index widths: 1 = int64, 0 = int32
  int kv_heads, g_n, nb, bs, n_visit;
  int per_visit;  // tiles per listed block
  int n_tiles;    // n_visit * per_visit
  int tps;        // tiles per split
  int n_split;    // splits per (b, h)
  int bkv;        // B * KV
  float scale, neg;
};

// Keys per tile and the ring's bytes for an instance (the wrapper's
// kv_visit.tile_keys mirrors TK; mdrq_kv_visit_shape reports both).
template <typename T, int HD>
struct Shape {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ROW = HD * static_cast<int>(sizeof(T)) + PAD;  // staged row bytes
  static constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;   // 16-byte chunks per row
  // bf16: four warps of 16 keys. float32: 16 KB of K rows per tile.
  static constexpr int TK = BF16 ? 64 : (16384 / (HD * 4) < 64 ? 16384 / (HD * 4) : 64);
  static constexpr int STAGE = 2 * TK * ROW;  // K rows, then V rows
  static constexpr int SMEM = STAGES * STAGE;
  // the merge's partials, reusing the ring: acc (WARPS, G, HD), then m and
  // l (WARPS, G) and the block's m and l (G), or the splits' m and l
  // (MAX_SPLIT, G) in the last block
  static_assert(static_cast<int>(sizeof(float)) *
                        (WARPS * MAX_GROUP * HD + 2 * MAX_SPLIT * MAX_GROUP + 2 * MAX_GROUP) <=
                    SMEM,
                "partials must fit the ring");
};

__device__ __forceinline__ long long load_index(const void* p, long long i, int wide) {
  return wide ? static_cast<const long long*>(p)[i]
              : static_cast<long long>(static_cast<const int*>(p)[i]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with bytes = 0 nothing is read and the 16
// bytes of shared memory are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A B for one m16n8k16 tile whose A rows 8..15 are zero: a0 holds
// (row lane / 4, k 2 (lane % 4) + {0, 1}), a2 the same at k + 8; d0, d1 are
// (row lane / 4, n 2 (lane % 4) + {0, 1}). The zero rows' outputs are dropped.
__device__ __forceinline__ void mma_rows8(float& d0, float& d1, unsigned a0, unsigned a2,
                                          unsigned b0, unsigned b1) {
  [[maybe_unused]] float z0, z1;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %11};\n"
      : "+f"(d0), "+f"(d1), "=f"(z0), "=f"(z1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f));
}

struct Tile {
  const char* k;  // row 0 of the tile in the cache
  const char* v;
  int live;       // keys taking part: a prefix of the tile
};

// Tile ti of (b, h)'s list: its rows and how many of them take part.
template <typename T, int HD>
__device__ __forceinline__ Tile tile_of(const Args& a, int ti, int b, int h, long long ids0,
                                        long long p, bool uniform) {
  constexpr int TK = Shape<T, HD>::TK;
  const int j = ti / a.per_visit;
  const int t0 = (ti - j * a.per_visit) * TK;
  const int len = min(TK, a.bs - t0);
  const long long raw = load_index(a.ids, ids0 + j, a.ids64);
  const long long blk = min(max(raw, 0LL), static_cast<long long>(a.nb - 1));
  int live;
  if (uniform) {
    live = len;  // every listed key scores `neg`, padding reads block 0
  } else if (raw < 0) {
    live = 0;
  } else {
    live = static_cast<int>(
        max(0LL, min(static_cast<long long>(len), p - (blk * a.bs + t0) + 1)));
  }
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h + blk * a.ks.n + t0 * a.ks.t;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h + blk * a.vs.n + t0 * a.vs.t;
  return {reinterpret_cast<const char*>(k), reinterpret_cast<const char*>(v), live};
}

// Issue the copies of one tile into a ring slot: the live rows of K and V
// from the cache, the rows up to the next multiple of 16 zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(unsigned char* slot, const Tile& t, const Args& a) {
  using S = Shape<T, HD>;
  const int rows = min(S::TK, (t.live + 15) & ~15);
  const long long kst = a.ks.t * static_cast<long long>(sizeof(T));
  const long long vst = a.vs.t * static_cast<long long>(sizeof(T));
  for (int i = threadIdx.x; i < rows * S::CPR; i += THREADS) {
    const int r = i / S::CPR, c = i % S::CPR;
    const int bytes = r < t.live ? 16 : 0;
    cp_async16(slot + r * S::ROW + 16 * c, t.k + r * kst + 16 * c, bytes);
    cp_async16(slot + (S::TK + r) * S::ROW + 16 * c, t.v + r * vst + 16 * c, bytes);
  }
}

// The running softmax state of one warp over its keys, and its arithmetic.
// bf16: lane (g = lane / 4, c = lane % 4) owns query row g and, of the
// output, columns n * 8 + 2 c + {0, 1} (acc[n]); l is the lane's share.
template <typename T, int HD, bool BF16 = Shape<T, HD>::BF16>
struct Warp;

template <typename T, int HD>
struct Warp<T, HD, true> {
  unsigned qa[HD / 16][2];  // A fragments of q (rows >= G are zero)
  float acc[HD / 8][2];
  float m, l;

  __device__ __forceinline__ void init(const T* q, int g_n, float neg) {
    const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = ks * 16 + half * 8 + 2 * c;
        qa[ks][half] = g < g_n ? pack_bf16(to_f(q[g * HD + d]), to_f(q[g * HD + d + 1])) : 0u;
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = 0.f;
    m = neg;
    l = 0.f;
  }

  // The tile's keys in the staged slot: warp w takes keys [16 i, 16 i + 16)
  // for i = w, w + WARPS, ...; keys >= live score -inf (weight 0).
  __device__ __forceinline__ void run(const unsigned char* slot, int live, bool uniform,
                                      float scale, float neg) {
    using S = Shape<T, HD>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
    for (int k0 = warp * 16; k0 < live; k0 += WARPS * 16) {
      const unsigned char* kt = slot + k0 * S::ROW;
      const unsigned char* vt = slot + (S::TK + k0) * S::ROW;
      float s[2][2];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {  // keys k0 + 8 nb + [0, 8)
        s[nb][0] = s[nb][1] = 0.f;
#pragma unroll
        for (int kp = 0; kp < HD / 32; ++kp) {  // hd [32 kp, 32 kp + 32)
          unsigned bf[4];
          ldmatrix_x4(bf, kt + (nb * 8 + (lane & 7)) * S::ROW + (kp * 4 + (lane >> 3)) * 16);
          mma_rows8(s[nb][0], s[nb][1], qa[2 * kp][0], qa[2 * kp][1], bf[0], bf[1]);
          mma_rows8(s[nb][0], s[nb][1], qa[2 * kp + 1][0], qa[2 * kp + 1][1], bf[2], bf[3]);
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + nb * 8 + 2 * c + i;
          s[nb][i] = key < live ? (uniform ? neg : s[nb][i] * scale) : -INFINITY;
          mx = fmaxf(mx, s[nb][i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);  // finite: key k0 is live
      const float corr = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[nb][i] = expf(s[nb][i] - m_new);
          ps += s[nb][i];
        }
      l = l * corr + ps;
      m = m_new;
      // P (row g, keys 2c, 2c + 1 and 8 + 2c, 9 + 2c) as a bf16 pair and
      // its bf16 residual: hi + lo carries 16 bits of each probability
      unsigned pa[2], pl[2];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[nb][0], s[nb][1]);
        const float2 back = __bfloat1622float2(hi);
        pa[nb] = *reinterpret_cast<const unsigned*>(&hi);
        pl[nb] = pack_bf16(s[nb][0] - back.x, s[nb][1] - back.y);
      }
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {  // hd [16 np, 16 np + 16)
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * S::ROW +
                                  (np * 2 + (lane >> 4)) * 16);
        acc[2 * np][0] *= corr;
        acc[2 * np][1] *= corr;
        acc[2 * np + 1][0] *= corr;
        acc[2 * np + 1][1] *= corr;
        mma_rows8(acc[2 * np][0], acc[2 * np][1], pa[0], pa[1], vf[0], vf[1]);
        mma_rows8(acc[2 * np][0], acc[2 * np][1], pl[0], pl[1], vf[0], vf[1]);
        mma_rows8(acc[2 * np + 1][0], acc[2 * np + 1][1], pa[0], pa[1], vf[2], vf[3]);
        mma_rows8(acc[2 * np + 1][0], acc[2 * np + 1][1], pl[0], pl[1], vf[2], vf[3]);
      }
    }
  }

  // The warp's (m, l, acc) of rows < g_n into shared memory.
  __device__ __forceinline__ void save(float* wacc, float* wm, float* wl, int g_n) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
    float lt = l;
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (g >= g_n) return;
    float* row = wacc + (warp * g_n + g) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      row[n * 8 + 2 * c] = acc[n][0];
      row[n * 8 + 2 * c + 1] = acc[n][1];
    }
    if (c == 0) {
      wm[warp * g_n + g] = m;
      wl[warp * g_n + g] = lt;
    }
  }
};

// float32: lane owns elements [lane * EPL, lane * EPL + EPL) of every row;
// m and l are the same in every lane.
template <typename T, int HD>
struct Warp<T, HD, false> {
  static constexpr int EPL = HD / 32;
  float qr[MAX_GROUP][EPL];
  float acc[MAX_GROUP][EPL];
  float m[MAX_GROUP], l[MAX_GROUP];

  __device__ __forceinline__ void init(const T* q, int g_n, float neg) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        qr[g][e] = g < g_n ? to_f(q[g * HD + lane * EPL + e]) : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = neg;
      l[g] = 0.f;
    }
  }

  __device__ __forceinline__ void run(const unsigned char* slot, int live, bool uniform,
                                      float scale, float neg) {
    using S = Shape<T, HD>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int key = warp; key < live; key += WARPS) {
      const float* kr = reinterpret_cast<const float*>(slot + key * S::ROW) + lane * EPL;
      const float* vr = reinterpret_cast<const float*>(slot + (S::TK + key) * S::ROW) + lane * EPL;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kf[e] = kr[e];
        vf[e] = vr[e];
      }
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        float s = neg;
        if (!uniform) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          s = d * scale;
        }
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e] * corr);
      }
    }
  }

  __device__ __forceinline__ void save(float* wacc, float* wm, float* wl, int g_n) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
      if (g >= g_n) break;
#pragma unroll
      for (int e = 0; e < EPL; ++e) wacc[(warp * g_n + g) * HD + lane * EPL + e] = acc[g][e];
      if (lane == 0) {
        wm[warp * g_n + g] = m[g];
        wl[warp * g_n + g] = l[g];
      }
    }
  }
};

// One thread block per (split, b * KV + h).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) kv_visit_kernel(const Args a) {
  using S = Shape<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int bk = blockIdx.y;  // b * kv_heads + h
  const int b = bk / a.kv_heads, h = bk % a.kv_heads;
  const long long ids0 = static_cast<long long>(bk) * a.n_visit;
  const long long p = load_index(a.pos, b, a.pos64);

  // Is any key of the whole list valid? If not, every listed key counts.
  int any = 0;
  for (int i = threadIdx.x; i < a.n_visit; i += THREADS) {
    const long long id = load_index(a.ids, ids0 + i, a.ids64);
    any |= id >= 0 && id * a.bs <= p;
  }
  const bool uniform = !__syncthreads_or(any);

  const int t_first = split * a.tps;
  const int n_t = min(a.tps, a.n_tiles - t_first);  // >= 1 (split_plan)

  Warp<T, HD> w;
  w.init(static_cast<const T*>(a.q) + static_cast<long long>(bk) * a.g_n * HD, a.g_n, a.neg);

  // The ring: tile i lives in slot i % STAGES; one commit group per tile.
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_t)
      stage_tile<T, HD>(smem + i * S::STAGE, tile_of<T, HD>(a, t_first + i, b, h, ids0, p, uniform),
                        a);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < n_t; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // tile i landed; slot (i - 1) % STAGES is free
    const int nx = i + STAGES - 1;
    if (nx < n_t)
      stage_tile<T, HD>(smem + (nx % STAGES) * S::STAGE,
                        tile_of<T, HD>(a, t_first + nx, b, h, ids0, p, uniform), a);
    asm volatile("cp.async.commit_group;\n" ::);
    const int live = tile_of<T, HD>(a, t_first + i, b, h, ids0, p, uniform).live;
    w.run(smem + (i % STAGES) * S::STAGE, live, uniform, a.scale, a.neg);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the ring is free: it holds the partials from here on

  const int g_n = a.g_n;
  float* wacc = reinterpret_cast<float*>(smem);  // (WARPS, g_n, HD); row 0 becomes the block's
  float* wm = wacc + WARPS * g_n * HD;           // (WARPS, g_n)
  float* wl = wm + WARPS * g_n;
  float* bm = wl + WARPS * g_n;                  // (g_n): the block's m and l
  float* bl = bm + g_n;
  w.save(wacc, wm, wl, g_n);
  __syncthreads();

  // The block's partial: its warps merged in warp order (in place: each
  // element is read and written by one thread).
  for (int idx = threadIdx.x; idx < g_n * HD; idx += THREADS) {
    const int g = idx / HD;
    float mm = wm[g];
#pragma unroll
    for (int x = 1; x < WARPS; ++x) mm = fmaxf(mm, wm[x * g_n + g]);
    float aa = 0.f, ll = 0.f;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) {
      const float cw = expf(wm[x * g_n + g] - mm);
      aa = fmaf(wacc[x * g_n * HD + idx], cw, aa);
      ll = fmaf(wl[x * g_n + g], cw, ll);
    }
    wacc[idx] = aa;
    if (idx % HD == 0) {
      bm[g] = mm;
      bl[g] = ll;
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + static_cast<long long>(bk) * g_n * HD;
  if (a.n_split == 1) {  // the block's partial is the (b, h) output
    for (int idx = threadIdx.x; idx < g_n * HD; idx += THREADS)
      store(out + idx, wacc[idx] / fmaxf(bl[idx / HD], 1e-30f));
    return;
  }

  // Publish the partial: (acc (g_n, HD), m (g_n), l (g_n)) at part[split][bk].
  const int width = g_n * (HD + 2);
  float* mine = a.part + (static_cast<long long>(split) * a.bkv + bk) * width;
  for (int idx = threadIdx.x; idx < width; idx += THREADS)
    mine[idx] = idx < g_n * HD ? wacc[idx] : (idx < g_n * (HD + 1) ? bm[idx - g_n * HD]
                                                                     : bl[idx - g_n * (HD + 1)]);
  __threadfence();  // the partial is visible before the ticket counts it
  __syncthreads();
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(a.tickets + bk, 1);
  __syncthreads();
  if (ticket != a.n_split - 1) return;

  // The last block of (b, h) merges every split's partial in split order.
  __threadfence();
  float* sm = wm;  // (n_split, g_n) m, then l: the warps' values are spent
  float* sl = wm + a.n_split * g_n;
  for (int i = threadIdx.x; i < a.n_split * g_n; i += THREADS) {
    const float* src = a.part + (static_cast<long long>(i / g_n) * a.bkv + bk) * width;
    sm[i] = __ldcg(src + g_n * HD + i % g_n);
    sl[i] = __ldcg(src + g_n * (HD + 1) + i % g_n);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g_n * HD; idx += THREADS) {
    const int g = idx / HD;
    float mm = sm[g];
    for (int r = 1; r < a.n_split; ++r) mm = fmaxf(mm, sm[r * g_n + g]);
    float aa = 0.f, ll = 0.f;
    const float* src = a.part + static_cast<long long>(bk) * width + idx;
    for (int r = 0; r < a.n_split; ++r) {
      const float cw = expf(sm[r * g_n + g] - mm);
      aa = fmaf(__ldcg(src + static_cast<long long>(r) * a.bkv * width), cw, aa);
      ll = fmaf(sl[r * g_n + g], cw, ll);
    }
    store(out + idx, aa / fmaxf(ll, 1e-30f));
  }
  if (threadIdx.x == 0) a.tickets[bk] = 0;  // ready for the next call
}

template <typename T, int HD>
cudaError_t run(const Args& a, int tile, cudaStream_t stream) {
  using S = Shape<T, HD>;
  if (tile != S::TK) return cudaErrorInvalidValue;  // the wrapper's plan is for another tile
  auto kernel = kv_visit_kernel<T, HD>;
  MDRQ_TRY(mdrq::allow_smem(kernel, S::SMEM));
  const dim3 grid(static_cast<unsigned>(a.n_split), static_cast<unsigned>(a.bkv));
  kernel<<<grid, THREADS, S::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int hd, const Args& a, int tile, cudaStream_t stream) {
  switch (hd) {
    case 32: return run<T, 32>(a, tile, stream);
    case 64: return run<T, 64>(a, tile, stream);
    case 128: return run<T, 128>(a, tile, stream);
    case 256: return run<T, 256>(a, tile, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
cudaError_t report(int* tile, int* smem) {
  *tile = Shape<T, HD>::TK;
  *smem = Shape<T, HD>::SMEM;
  return cudaSuccess;
}

template <typename T>
cudaError_t shape_by_head_dim(int hd, int* tile, int* smem) {
  switch (hd) {
    case 32: return report<T, 32>(tile, smem);
    case 64: return report<T, 64>(tile, smem);
    case 128: return report<T, 128>(tile, smem);
    case 256: return report<T, 256>(tile, smem);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, KV, G, hd) contiguous; k, v: (B, KV, nb, bs, hd) with element
// strides (b, h, n, t), a contiguous last axis and 16-byte aligned rows;
// ids: (B, KV, n_visit) contiguous, int64 if ids64 else int32; pos: (B,),
// int64 if pos64 else int32. `tile` keys per tile (the instance's TK),
// n_split blocks of `tps` tiles per (b, h), covering the n_visit *
// ceil(bs / tile) tiles with none empty. part: (n_split, B * KV, G, hd + 2)
// float32 scratch and tickets: (B * KV,) int32, zero before the call and
// left zero by it (both unused when n_split = 1); calls on other streams must
// not share tickets (the wrapper keeps a buffer per device and stream).
// bf16 != 0: q, k, v and out are bfloat16, else float32.
extern "C" int mdrq_kv_visit_attention(
    const void* q, const void* k, const void* v, const void* ids, const void* pos, void* out,
    float* part, int* tickets, int ids64, int pos64, int bf16, int batch, int kv_heads,
    int g_n, int hd, int nb, int bs, int n_visit, int tile, int n_split, int tps,
    long long ksb, long long ksh, long long ksn, long long kst, long long vsb, long long vsh,
    long long vsn, long long vst, float scale, float neg, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  const long long bkv = static_cast<long long>(batch) * kv_heads;
  if (g_n < 1 || g_n > MAX_GROUP || nb < 1 || bs < 1 || n_visit < 1 || bkv < 1 ||
      bkv > 65535 || tile < 1 || n_split < 1 || n_split > MAX_SPLIT || tps < 1 ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const long long per_visit = (bs + tile - 1) / tile;
  const long long n_tiles = per_visit * n_visit;
  if (n_tiles > 0x7fffffffLL || static_cast<long long>(n_split) * tps < n_tiles ||
      static_cast<long long>(n_split - 1) * tps >= n_tiles)
    return cudaErrorInvalidValue;  // a split past the list, or tiles left over
  Args a{q, k, v, ids, pos, out, part, tickets, {ksb, ksh, ksn, kst}, {vsb, vsh, vsn, vst},
         ids64, pos64, kv_heads, g_n, nb, bs, n_visit, static_cast<int>(per_visit),
         static_cast<int>(n_tiles), tps, n_split, static_cast<int>(bkv), scale, neg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return by_head_dim<__nv_bfloat16>(hd, a, tile, st);
  return by_head_dim<float>(hd, a, tile, st);
}

// The instance's keys per tile and dynamic shared memory per thread block
// (Shape::TK, Shape::SMEM) -> *tile, *smem; needs no device.
extern "C" int mdrq_kv_visit_shape(int bf16, int hd, int* tile, int* smem) {
  if (bf16) return shape_by_head_dim<__nv_bfloat16>(hd, tile, smem);
  return shape_by_head_dim<float>(hd, tile, smem);
}

MDRQ_ERROR_STRING_FN
