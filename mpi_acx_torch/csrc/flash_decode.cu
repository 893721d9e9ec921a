// K2 and B9: length-aware GQA decode attention for Hopper (sm_90a), CUDA C++
// behind plain C entry points (loaded with ctypes by
// mpi_acx_torch/ops/flash_decode.py).
//
// Replaces two TPU kernels of mpi_acx_tpu/ops/flash_decode.py, each in both
// of its operand forms: _decode_kernel (the pl.pallas_call in
// flash_decode_attend: a [B, max_len, Hkv, D] cache per slot) and
// _paged_decode_kernel (the pl.pallas_call in paged_flash_decode_attend:
// [P, page_tokens, Hkv, D] pools, slot b's row t on page table[b, t / pt]).
// One kernel template serves all four; where a row lives is the only
// difference between the contiguous and the paged instantiation, so they
// run the same FLOPs in the same order and B9 equals K2 bit for bit on the
// same rows, for any page size.
//
// The function: q [B, W, Hkv*n_rep, D] pre-scaled by 1/sqrt(D); window row
// i = w*n_rep + r sits at absolute position pos[b] + i // n_rep and reads
// the un-repeated K/V group g; f32 logits and online-softmax state; output
// [B, W, Hkv*n_rep*D] in q's type. Two operand forms:
//  * bf16/f32 cache: q is rounded to the input type after the scale, and
//    the probabilities are rounded to it before the P.V product;
//  * int8 cache (ops/kvquant.py codes plus one f32 scale per position and
//    head): q stays f32, each live row is dequantized in registers as code
//    * scale, and both products and the probabilities stay f32 (the TPU
//    kernel's quant=True branch). Only codes and scales are read from
//    memory; the cache is never dequantized to memory.
// Only the live keys [0, min(pos + W, max_len)) are read.
//
// What bounds it on the H100: the bytes, and before them the latency of
// dependent steps. A decode step reads every live K/V row once and does 4
// FLOPs per cached element and query row, so at W*n_rep = 1 it sits two
// orders of magnitude below the ridge: the bound is the live cache bytes
// over 3.35 TB/s, 1.9 us at the served positions and 7.5 us for a full
// 1024-row cache of B = 8, 12 heads. At those sizes a call is a chain of a
// few microsecond steps (launch, pos, the K/V copies, the products, the
// merge), so the design puts the bytes in flight early, shortens each
// CTA's walk and keeps the merge on the chip:
//  * Keys split over the SMs (flash-decoding). Each slot's positions are
//    cut into chunks of `chunk` positions (a multiple of kTile), one CTA per
//    (KV group, slot and block of R window rows, chunk). The grid covers
//    max_len, which the host knows; pos lives on the card and is never read
//    back, so a CTA whose chunk starts past its rows' live length leaves at
//    once. The host's rule (ops/flash_decode.py:decode_chunk) picks the
//    chunk from the shape and the SM count, at most kMaxCluster chunks.
//  * A tile's bytes issued before any is used. A CTA walks its chunk in
//    tiles of kTile keys through a ring of up to kMaxStages shared-memory
//    stages: every thread starts 16-byte cp.async copies of its keys' K and
//    V row pieces (and 4-byte copies of the int8 form's scales) for every
//    stage of the ring, then waits once per tile; a key past the chunk's
//    live end is zero-filled, never read. A chunk of up to two tiles (the
//    served one) has all of its bytes in flight before the first product.
//  * Products on the CUDA cores: a quad of lanes per key (a quarter of D
//    each, reduced with two shuffles) for Q.K, two keys a quad per tile, a
//    lane per two columns for P.V with the probabilities broadcast through
//    shared memory; each of the 8 warps keeps its own softmax state over
//    its 16 keys of a tile, and the warps' states are merged in warp order
//    at the end. The odd keys' K pieces are stored xor-swizzled so the quad
//    reads of two neighbouring keys fall on disjoint banks.
//  * One ordered merge, on the chip. A slot's chunks form one thread block
//    cluster (launched with a cluster dimension of ceil(max_len / chunk)).
//    A slot whose rows have one live chunk writes its output directly.
//    Otherwise every other live chunk stores its (m, l, acc[D]) in f32 into
//    chunk 0's shared memory (distributed shared memory) and arrives on
//    chunk 0's mbarrier, armed before a cluster barrier that the writers
//    pass first; chunk 0 merges the partials in chunk order, never arrival
//    order, so two calls on the same inputs give the same bits. Nothing
//    outlives a launch: no workspace, no counters, no ordering between
//    calls or streams.
//  * The paged form reads the table entries of the pages its chunk touches
//    once, into shared memory, before its copies: no whole table row, no
//    per-key table read.
// The int8 form halves the row bytes again.
//
// Head dims 64 (GPT-2) and 128 (Llama-3-8B: 32 query heads over 8 KV groups,
// n_rep = 4, W * n_rep = 4 a served step, one row block). At D = 128 a
// quad's lane takes a quarter of a key's row (32 elements: 4 bf16, 8 f32
// or 2 int8 pieces of 16 bytes) and P.V four columns a lane; the xor
// swizzle of the odd keys' pieces keeps a quad pair's 16-byte reads on
// disjoint banks at every D (the piece index mod 8 alternates between the
// two keys). A bf16 stage of 128 keys is 64 KB there, so the ring is two
// stages (128 KB, one CTA an SM; the host's split rule gives the SMs half
// as many CTAs as at D = 64) and an f32 one, 128 KB a stage, is one stage
// (copies then wait for the products of the tile before). The paged form
// (B9) is built for D = 64 alone: no path pages a D = 128 cache.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerLane = 2;    // keys a lane quad takes per tile
constexpr int kSpan = kWarps * 8;  // keys of one pass over the 8 warps
constexpr int kTile = kSpan * kKeysPerLane;  // keys a CTA stages at a time
constexpr int kMaxStages = 2;      // tiles in flight (cp_async_wait_ring)
constexpr int kRingBytes = 128 * 1024;  // the ring's shared memory at most
constexpr int kMaxCluster = 8;     // chunks per slot: the portable cluster
constexpr int kMaxDevices = 64;    // devices whose smem opt-in is remembered

template <int BYTES> struct RawOf;
template <> struct RawOf<2> { using type = uint16_t; };
template <> struct RawOf<4> { using type = uint32_t; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

// N consecutive elements of T (one aligned access) widened to f32. A bf16
// pair in one 32-bit word widens with one instruction each: a shift for
// the low element, a mask for the high one.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  using R = typename RawOf<N * sizeof(T)>::type;
  union {
    R r;
    T e[N];
    uint32_t w[(N * sizeof(T) + 3) / 4];
  } u;
  u.r = *reinterpret_cast<const R*>(p);
  if constexpr (std::is_same<T, uint16_t>::value && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      out[2 * i] = __uint_as_float(u.w[i] << 16);
      out[2 * i + 1] = __uint_as_float(u.w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = acx::to_f32(u.e[i]);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with ok false nothing is read
// and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (a scale), zero-filled when ok is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n - 1 (n of 1 or 2 ring stages) of this thread's
// copy groups are pending.
__device__ __forceinline__ void cp_async_wait_ring(int n) {
  if (n == 1)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Thread block clusters: the CTAs of one slot's chunks form a cluster, and
// the chunk-0 CTA merges the others' partial states from its own shared
// memory (distributed shared memory), so the merge never leaves the GPC.
// Relaxed: the one write it orders, chunk 0's barrier init, has its own
// release fence (mbar_init).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p`'s counterpart in the cluster's CTA
// `rank`.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)),
      "r"(n)
      : "memory");
}

// Arrive, with release at cluster scope, on the barrier at shared::cluster
// address `addr` (another CTA's).
__device__ __forceinline__ void mbar_arrive_remote(unsigned addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// Wait, with acquire at cluster scope, for phase 0 of this CTA's barrier.
__device__ __forceinline__ void mbar_wait0(unsigned long long* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// Reductions over the 8 keys of a warp (lanes 4k..4k+3 hold key k).
__device__ __forceinline__ float keys_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float keys_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Strides are in elements. A "unit" is a slot of the contiguous cache or a
// page of the pool; a row is a position within it.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;   // int8 form: scales [units, rows, Hkv, 1]
  const float* vs;
  const int* pos;    // [B]
  const int* table;  // paged form: [B, max_pages]
  void* o;
  int W, n_rep, max_len, pt, n_units;
  int chunk, n_chunks, stages, n_rb;
  long long q_sb, q_sw, k_u, k_r, v_u, v_r, ks_u, ks_r, vs_u, vs_r, tab_sb;
  float scale;
};

// Bytes of one ring stage: K and V rows of kTile keys, then (int8 form)
// their scales.
template <typename KT, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kTile * D * static_cast<int>(sizeof(KT)) +
         (std::is_same<KT, int8_t>::value ? 2 * kTile * 4 : 0);
}

// Stages of the ring: two, or one where a stage takes the whole budget
// (f32 at D = 128).
template <typename KT, int D>
constexpr int ring_stages() {
  return stage_bytes<KT, D>() * kMaxStages <= kRingBytes ? kMaxStages : 1;
}

// Registers: at D = 64 the served R = 1 forms keep six CTAs an SM (40 a
// thread), the wider row blocks trade CTAs for registers; at D = 128,
// where shared memory holds an SM to one to three CTAs, up to 80
// registers at R = 1 and 128 above (R = 2 spilled at 80). None spills.
template <int R, int D>
constexpr int min_blocks() {
  if (D > 64) return R == 1 ? 3 : 2;
  return R == 1 ? 6 : R == 2 ? 3 : 2;
}

// One CTA per (KV group g, slot b and block of R window rows, chunk of
// `chunk` positions). T is q's and the output's type, KT the cache's (T,
// or int8_t for the int8 form).
template <typename T, typename KT, int D, int R, bool PAGED>
__global__ void __launch_bounds__(kThreads, min_blocks<R, D>())
    decode_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int PER = 16 / sizeof(KT);     // elements per 16-byte piece
  constexpr int PIECES = D / PER;          // pieces per row: 4, 8 or 16
  constexpr int KPL = PIECES / 4;          // K pieces per lane (4 a key)
  constexpr int SWZ = PIECES >= 8 ? 4 : 0; // odd keys' pieces xor SWZ
  constexpr int DPL = D / 32;              // V columns per lane
  constexpr int QPT = (R * D + kThreads - 1) / kThreads;
  constexpr int RS = R * (D + 2);          // floats of one chunk's partial
  static_assert(D % 32 == 0 && PIECES % 4 == 0, "head dim");
  __shared__ __align__(16) float Qs[R][D];
  __shared__ float Ms[kWarps][R], Ls[kWarps][R], Fw[R][kWarps], Mr[R];
  __shared__ float As[kWarps][R][D];
  __shared__ __align__(16) float Ps[kWarps][8 * kKeysPerLane * R];
  __shared__ int Hz[R];                    // each row's last visible key
  __shared__ unsigned long long bar;       // chunk 0: the partials are in
  extern __shared__ __align__(16) unsigned char ring[];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KT* __restrict__ kc = static_cast<const KT*>(a.k);
  const KT* __restrict__ vc = static_cast<const KT*>(a.v);
  const int g = blockIdx.x, Hkv = gridDim.x;
  const int rb = blockIdx.y % a.n_rb, b = blockIdx.y / a.n_rb;
  const int chunk = blockIdx.z;
  const int n_rep = a.n_rep, Wn = a.W * n_rep, Hq = Hkv * n_rep;
  const int i0 = rb * R, rows = min(R, Wn - i0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The query rows' loads go out beside pos's: neither waits on the other.
  float qx[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int idx = tid + k * kThreads, i = idx / D, d = idx % D;
    qx[k] = 0.f;
    if (idx < R * D && i < rows) {
      const int row = i0 + i, w = row / n_rep, hq = g * n_rep + row % n_rep;
      qx[k] = acx::to_f32(q[b * a.q_sb + w * a.q_sw + hq * D + d]);
    }
  }
  const int p0 = a.pos[b];
  // Live keys: up to the last row's horizon, capped at the cache length.
  const int live = min(p0 + (i0 + rows - 1) / n_rep + 1, a.max_len);
  const int n_live = (live + a.chunk - 1) / a.chunk;
  // Chunk 0 (rank 0 of the cluster) always has work and is the one that
  // merges: it arms its barrier for the other live chunks before the
  // cluster barrier, which each of them passes before writing to it.
  float* inbox = reinterpret_cast<float*>(ring + a.stages *
                                          stage_bytes<KT, D>());
  if (chunk == 0 && n_live > 1 && tid == 0) mbar_init(&bar, n_live - 1);
  cluster_arrive();
  if (chunk >= n_live) return;
  const int c_lo = chunk * a.chunk, c_hi = min(c_lo + a.chunk, live);
  const int n_tiles = (c_hi - c_lo + kTile - 1) / kTile;

  if (tid < R) Hz[tid] = min(p0 + (i0 + tid) / n_rep, c_hi - 1);
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < R * D) {
      float x = qx[k] * a.scale;
      if constexpr (!kQuant) x = acx::round_to<T>(x);
      Qs[idx / D][idx % D] = x;
    }
  }
  // Paged: the table entries of the pages this chunk touches. An entry
  // outside the pool is clamped to it, as XLA clamps a gather's index:
  // never a read out of bounds.
  int* tab = reinterpret_cast<int*>(inbox + (a.n_chunks - 1) * RS);
  const int pg_lo = c_lo / a.pt;
  if constexpr (PAGED) {
    const int n_pg = (c_hi - 1) / a.pt - pg_lo + 1;
    for (int j = tid; j < n_pg; j += kThreads)
      tab[j] = min(max(a.table[b * a.tab_sb + pg_lo + j], 0), a.n_units - 1);
  }
  __syncthreads();

  auto stage_k = [&](int s) {
    return reinterpret_cast<KT*>(ring + s * stage_bytes<KT, D>());
  };
  auto stage_v = [&](int s) { return stage_k(s) + kTile * D; };
  auto stage_ks = [&](int s) {
    return reinterpret_cast<float*>(stage_k(s) + 2 * kTile * D);
  };

  // Start the copies of the tile at t0 into stage s: thread (key j,
  // quarter q4) copies pieces q4, q4 + 4, ... of key j's K and V rows, for
  // keys j = tid / 4 + kSpan * kl.
  auto fetch = [&](int t0, int s) {
#pragma unroll
    for (int kl = 0; kl < kKeysPerLane; ++kl) {
      const int j = (tid >> 2) + kSpan * kl, q4 = tid & 3, t = t0 + j;
      const bool ok = t < c_hi;
      int u = 0, r = 0;
      if (ok) {
        if constexpr (PAGED) {
          const int pg = t / a.pt;
          u = tab[pg - pg_lo];
          r = t - pg * a.pt;
        } else {
          u = b;
          r = t;
        }
      }
      const KT* gk = kc + u * a.k_u + r * a.k_r + g * D;
      const KT* gv = vc + u * a.v_u + r * a.v_r + g * D;
      KT* sk = stage_k(s) + j * D;
      KT* sv = stage_v(s) + j * D;
      const int swz = (j & 1) ? SWZ : 0;
#pragma unroll
      for (int pp = 0; pp < KPL; ++pp) {
        const int p = q4 + 4 * pp;
        cp_async16(sk + (p ^ swz) * PER, gk + p * PER, ok);
        cp_async16(sv + p * PER, gv + p * PER, ok);
      }
      if constexpr (kQuant) {
        if (q4 == 0)
          cp_async4(stage_ks(s) + j, a.ks + u * a.ks_u + r * a.ks_r + g, ok);
        else if (q4 == 1)
          cp_async4(stage_ks(s) + kTile + j,
                    a.vs + u * a.vs_u + r * a.vs_r + g, ok);
      }
    }
  };

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = acx::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const int S = a.stages;
  for (int s = 0; s < S; ++s) {
    if (s < n_tiles) fetch(c_lo + s * kTile, s);
    cp_async_commit();
  }
  const int kk = lane >> 2, q4 = lane & 3;
  const int swz = (kk & 1) ? SWZ : 0;        // keys j and j + kSpan alike
  float* pw = Ps[warp];                      // this warp's probabilities
  for (int tt = 0, s = 0; tt < n_tiles; ++tt, s = (s + 1 == S) ? 0 : s + 1) {
    cp_async_wait_ring(S);
    __syncthreads();

    // Q.K for this lane quad's keys j = warp * 8 + kk + kSpan * kl: each
    // lane a quarter of D (q read once for both keys), then the quad's 4
    // lanes summed.
    const KT* sk = stage_k(s) + (warp * 8 + kk) * D;
    float ksc[kKeysPerLane];
#pragma unroll
    for (int kl = 0; kl < kKeysPerLane; ++kl)
      ksc[kl] = kQuant ? stage_ks(s)[warp * 8 + kk + kSpan * kl] : 1.f;
    float sc[kKeysPerLane][R];
#pragma unroll
    for (int kl = 0; kl < kKeysPerLane; ++kl) {
#pragma unroll
      for (int i = 0; i < R; ++i) sc[kl][i] = 0.f;
    }
    // Both keys' pieces in registers at once (one read of q serves both)
    // for R = 2 and 4 with 8 or fewer elements a piece; one key at a time
    // otherwise, which keeps R = 1 within its 40 registers.
    constexpr int KF =
        (R > 1 && R <= 4 && PER * kKeysPerLane <= 16) ? kKeysPerLane : 1;
#pragma unroll
    for (int k0 = 0; k0 < kKeysPerLane; k0 += KF) {
#pragma unroll
      for (int p = 0; p < KPL; ++p) {
        const int piece = q4 + 4 * p;
        float kv[KF][PER];
#pragma unroll
        for (int f = 0; f < KF; ++f) {
          load_vec<KT, PER>(sk + kSpan * (k0 + f) * D + (piece ^ swz) * PER,
                            kv[f]);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < PER; ++e) kv[f][e] *= ksc[k0 + f];
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int e = 0; e < PER; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&Qs[i][piece * PER + e]);
#pragma unroll
            for (int f = 0; f < KF; ++f) {
              float& acc_s = sc[k0 + f][i];
              acc_s = fmaf(qv.x, kv[f][e], acc_s);
              acc_s = fmaf(qv.y, kv[f][e + 1], acc_s);
              acc_s = fmaf(qv.z, kv[f][e + 2], acc_s);
              acc_s = fmaf(qv.w, kv[f][e + 3], acc_s);
            }
          }
        }
      }
    }

    // Online-softmax update over the warp's 8 * kKeysPerLane keys; the
    // probabilities (rounded to the input type in the bf16/f32 form, kept
    // f32 in the int8 form) go to the warp's row of Ps for the P.V loop.
    const int t0 = c_lo + tt * kTile + warp * 8 + kk;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      bool vis[kKeysPerLane];
      float mx = acx::kNegInf;
#pragma unroll
      for (int kl = 0; kl < kKeysPerLane; ++kl) {
        sc[kl][i] += __shfl_xor_sync(0xffffffffu, sc[kl][i], 1);
        sc[kl][i] += __shfl_xor_sync(0xffffffffu, sc[kl][i], 2);
        vis[kl] = t0 + kSpan * kl <= Hz[i];
        if (vis[kl]) mx = fmaxf(mx, sc[kl][i]);
      }
      const float m_new = fmaxf(m[i], keys_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int kl = 0; kl < kKeysPerLane; ++kl) {
        const float pr = vis[kl] ? expf(sc[kl][i] - m_new) : 0.f;
        ps += pr;
        if (q4 == 0)
          pw[(kl * 8 + kk) * R + i] = kQuant ? pr : acx::round_to<T>(pr);
      }
      l[i] = corr * l[i] + keys_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
    }
    __syncwarp();

    // acc += P V over the warp's keys: lane holds columns lane * DPL.. of
    // each V row; a key past the chunk's end has p = 0 and a zero row.
#pragma unroll
    for (int kl = 0; kl < kKeysPerLane; ++kl) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int jk = warp * 8 + k + kSpan * kl;
        float vv[DPL];
        load_vec<KT, DPL>(stage_v(s) + jk * D + lane * DPL, vv);
        if constexpr (kQuant) {
          const float vsc = stage_ks(s)[kTile + jk];
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[e] *= vsc;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pk = pw[(kl * 8 + k) * R + i];
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[i][e] = fmaf(pk, vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();                 // the stage and Ps are free again
    if (tt + S < n_tiles) fetch(c_lo + (tt + S) * kTile, s);
    cp_async_commit();
  }

  // Merge the warps' states in warp order: sum_w acc_w e^(m_w - M) and
  // sum_w l_w e^(m_w - M). A warp that saw no visible key holds m = -1e30,
  // l = 0, acc = 0 and drops out.
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane == 0) {
      Ms[warp][i] = m[i];
      Ls[warp][i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) As[warp][i][lane * DPL + e] = acc[i][e];
  }
  __syncthreads();
  // Each warp's weight e^(m_w - M) for each row, once.
  if (tid < R * kWarps) {
    const int i = tid / kWarps, w = tid % kWarps;
    float M = Ms[0][i];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) M = fmaxf(M, Ms[v][i]);
    Fw[i][w] = expf(Ms[w][i] - M);
    if (w == 0) Mr[i] = M;
  }
  __syncthreads();
  T* __restrict__ o = static_cast<T*>(a.o);
  if (chunk > 0) cluster_wait();              // chunk 0's barrier is armed
  else if (n_live > 1) mbar_wait0(&bar);      // the partials are in
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, row = i0 + i;
    float M = Mr[i], L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      L = fmaf(Ls[w][i], Fw[i][w], L);
      A = fmaf(As[w][i][d], Fw[i][w], A);
    }
    if (chunk > 0) {
      // To chunk 0's inbox, slot chunk - 1.
      const float* pc = inbox + (chunk - 1) * RS;
      st_cluster(map_rank(pc + i * D + d, 0), A);
      if (d == 0) {
        st_cluster(map_rank(pc + R * D + i, 0), M);
        st_cluster(map_rank(pc + R * D + R + i, 0), L);
      }
      continue;
    }
    if (n_live > 1) {
      // Chunk 0: merge chunks 1.. in chunk order into its own state, an
      // online softmax over the partials.
      for (int c = 1; c < n_live; ++c) {
        const float* pc = inbox + (c - 1) * RS;
        const float mc = pc[R * D + i];
        const float m_new = fmaxf(M, mc);
        const float f_old = expf(M - m_new), f = expf(mc - m_new);
        L = fmaf(pc[R * D + R + i], f, L * f_old);
        A = fmaf(pc[i * D + d], f, A * f_old);
        M = m_new;
      }
    }
    const int w = row / n_rep, hq = g * n_rep + row % n_rep;
    o[((static_cast<long long>(b) * a.W + w) * Hq + hq) * D + d] =
        acx::from_f32<T>(A / L);
  }
  if (chunk > 0) {
    // Every thread's stores precede thread 0's release arrive.
    __syncthreads();
    if (tid == 0) mbar_arrive_remote(map_rank(&bar, 0));
  }
}

template <typename T, typename KT, int D, int R, bool PAGED>
cudaError_t launch(Args a, int B, int Hkv, cudaStream_t stream) {
  a.stages = min(a.stages, ring_stages<KT, D>());
  a.n_rb = (a.W * a.n_rep + R - 1) / R;
  if (static_cast<long long>(B) * a.n_rb > 65535) return cudaErrorInvalidValue;
  // Dynamic shared memory: the ring, chunk 0's inbox of the other chunks'
  // partials, and (paged) the chunk's table entries.
  const size_t smem =
      a.stages * stage_bytes<KT, D>() +
      (a.n_chunks - 1) * R * (D + 2) * sizeof(float) +
      (PAGED ? ((a.chunk - 1) / a.pt + 2) * sizeof(int) : 0);
  // The kernel's static arrays (Qs, As, Ps, Ms, Ls, Fw, Mr, Hz, bar): past
  // 48 KB in all, the dynamic part needs the opt-in.
  constexpr size_t kStatic =
      ((kWarps + 1) * R * D + (8 * kKeysPerLane + 3) * kWarps * R + 2 * R) *
          sizeof(float) + sizeof(unsigned long long);
  // Set once per device and instantiation, to the most any launch asked
  // for: the opt-in is a host call of its own, not to be paid per launch.
  static int allowed[kMaxDevices] = {};
  auto kernel = decode_kernel<T, KT, D, R, PAGED>;
  if (smem + kStatic > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices || allowed[dev] < static_cast<int>(smem)) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      if (dev < kMaxDevices) allowed[dev] = static_cast<int>(smem);
    }
  }
  // One cluster per (group, slot and row block): its chunks.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = a.n_chunks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B * a.n_rb, a.n_chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = a.n_chunks > 1 ? 1 : 0;     // one chunk: no cluster
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, typename KT, int D, bool PAGED>
cudaError_t dispatch_r(const Args& a, int B, int Hkv, cudaStream_t stream) {
  const int Wn = a.W * a.n_rep;
  if (Wn <= 1) return launch<T, KT, D, 1, PAGED>(a, B, Hkv, stream);
  if (Wn <= 2) return launch<T, KT, D, 2, PAGED>(a, B, Hkv, stream);
  if (Wn <= 4) return launch<T, KT, D, 4, PAGED>(a, B, Hkv, stream);
  return launch<T, KT, D, 8, PAGED>(a, B, Hkv, stream);
}

template <int D, bool PAGED>
int run_d(const Args& a, int dtype, int quant, int B, int Hkv,
          cudaStream_t st) {
  if (dtype == acx::kF32)
    return quant ? dispatch_r<float, int8_t, D, PAGED>(a, B, Hkv, st)
                 : dispatch_r<float, float, D, PAGED>(a, B, Hkv, st);
  if (dtype == acx::kBF16)
    return quant ? dispatch_r<uint16_t, int8_t, D, PAGED>(a, B, Hkv, st)
                 : dispatch_r<uint16_t, uint16_t, D, PAGED>(a, B, Hkv, st);
  return cudaErrorInvalidValue;
}

// D = 64 in both forms, D = 128 contiguous only (the paged form is not
// instantiated there).
template <bool PAGED>
int run(Args a, int dtype, int quant, int B, int Hkv, int D, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant && (a.ks == nullptr || a.vs == nullptr))
    return cudaErrorInvalidValue;
  // Positions per CTA: a whole number of tiles; the grid covers max_len in
  // at most one cluster's worth of chunks.
  if (a.chunk <= 0 || a.chunk % kTile) return cudaErrorInvalidValue;
  const long long n_chunks = (a.max_len + a.chunk - 1LL) / a.chunk;
  if (n_chunks > kMaxCluster) return cudaErrorInvalidValue;
  a.n_chunks = static_cast<int>(n_chunks);
  a.stages = min(kMaxStages, a.chunk / kTile);
  if (D == 64) return run_d<64, PAGED>(a, dtype, quant, B, Hkv, st);
  if constexpr (!PAGED) {
    if (D == 128) return run_d<128, false>(a, dtype, quant, B, Hkv, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Contiguous cache (K2). q [B,W,Hkv*n_rep,D] with D of 64 or 128 (head
// stride D, element stride 1); kc/vc [B,max_len,Hkv,D] of q's type, or
// int8 codes with f32 scales ks/vs [B,max_len,Hkv,1] when quant != 0
// (ks/vs ignored otherwise); rows contiguous [Hkv, D] blocks on 16-byte
// bounds; pos int32 [B]; o contiguous [B,W,Hkv*n_rep*D] of q's type.
// chunk: positions per CTA, a multiple of 128 with max_len / chunk at most
// 8 (one cluster). strides = {q_sb, q_sw, k_sb, k_ss, v_sb, v_ss, ks_sb,
// ks_ss, vs_sb, vs_ss} in elements. Returns the cudaError_t of the launch.
extern "C" int acx_flash_decode(const void* q, const void* kc, const void* vc,
                                const void* ks, const void* vs,
                                const void* pos, void* o, int dtype,
                                int quant, int B, int W, int Hkv, int n_rep,
                                int D, int max_len, int chunk,
                                const long long* strides, void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  if (B <= 0 || W <= 0 || Hkv <= 0 || n_rep <= 0 || max_len <= 0 ||
      (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, kc, vc, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(pos),
               nullptr, o, W, n_rep, max_len, 1, B, chunk, 0, 0, 0,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], 0,
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  return run<false>(a, dtype, quant, B, Hkv, D, stream);
}

// Paged pools (B9). kp/vp [n_pages,page_tokens,Hkv,D] (with scale pools
// ksp/vsp [n_pages,page_tokens,Hkv,1] when quant != 0), table int32
// [B,max_pages] (row stride tab_sb) naming slot b's page for positions
// [j*page_tokens, (j+1)*page_tokens); max_len is max_pages * page_tokens
// and everything else as acx_flash_decode, with D = 64 only. strides =
// {q_sb, q_sw, k_sp, k_ss, v_sp, v_ss, ks_sp, ks_ss, vs_sp, vs_ss, tab_sb}.
extern "C" int acx_paged_decode(const void* q, const void* kp, const void* vp,
                                const void* ksp, const void* vsp,
                                const void* pos, const void* table, void* o,
                                int dtype, int quant, int B, int W, int Hkv,
                                int n_rep, int D,
                                int page_tokens, int max_pages, int n_pages,
                                int chunk, const long long* strides,
                                void* stream) {
  cudaGetLastError();
  if (B <= 0 || W <= 0 || Hkv <= 0 || n_rep <= 0 || D != 64 ||
      page_tokens <= 0 || max_pages <= 0 || n_pages <= 0 ||
      static_cast<long long>(page_tokens) * max_pages > (1 << 30))
    return cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, kp, vp, static_cast<const float*>(ksp),
               static_cast<const float*>(vsp), static_cast<const int*>(pos),
               static_cast<const int*>(table), o, W, n_rep,
               page_tokens * max_pages, page_tokens, n_pages, chunk, 0, 0, 0,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
               s[10],
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  return run<true>(a, dtype, quant, B, Hkv, D, stream);
}
