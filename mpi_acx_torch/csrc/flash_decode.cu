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
// Only the live keys [0, min(pos + W, max_len)) are read, and only the tiles
// that straddle a row's horizon (or the end of the cache) evaluate the mask.
//
// What bounds it on the H100: the bytes. A decode step reads every live K/V
// row once and does 4 FLOPs per cached element and query row, so at W*n_rep
// = 1 it sits two orders of magnitude below the ridge; the bound is the live
// cache bytes over 3.35 TB/s. What the design does about that: the cache is
// read straight from global memory (no staging copy), each lane pulls whole
// 16-byte chunks of its own key row and whole rows of V are read by the warp
// as one coalesced access, 16 rows issued before any is used so their
// latencies overlap; the eight warps of a block (one block per slot and KV
// group) walk disjoint 32-key tiles so eight tiles' loads are in flight at
// once, and their partial softmax states are merged once at the end in shared
// memory. Reading past the live length is never needed, so a slot at
// position 40 of a 1024-long cache moves 41 rows, not 1024. The int8 form
// halves the row bytes. In the paged form each block copies its slot's table
// row to shared memory once, each lane resolves its own key's page, and the
// warp's V loads take those locations from the lanes by shuffle, so paging
// costs one division per key. Splitting one slot's keys over several blocks
// (more SMs per slot) is later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;        // keys per warp tile: one per lane
constexpr int kVChunk = 16;      // V rows loaded together in the P.V loop
constexpr int kMaxPages = 4096;  // table row held in shared memory

template <int BYTES> struct RawOf;
template <> struct RawOf<2> { using type = uint16_t; };
template <> struct RawOf<4> { using type = uint32_t; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

// N consecutive elements of T (one aligned access) widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  using R = typename RawOf<N * sizeof(T)>::type;
  union {
    R r;
    T e[N];
  } u;
  u.r = *reinterpret_cast<const R*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = acx::to_f32(u.e[i]);
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
  int W, n_rep, max_len, pt, max_pages, n_units;
  long long q_sb, q_sw, k_u, k_r, v_u, v_r, ks_u, ks_r, vs_u, vs_r, tab_sb;
  float scale;
};

// Where key/value row t of slot b lives.
template <bool PAGED>
__device__ __forceinline__ void locate(int b, int t, int pt,
                                       const int* __restrict__ tab, int& u,
                                       int& r) {
  if constexpr (PAGED) {
    const int j = t / pt;
    u = tab[j];
    r = t - j * pt;
  } else {
    u = b;
    r = t;
  }
}

// One block per (KV group g, slot b, chunk of R window rows). T is q's and
// the output's type, KT the cache's (T, or int8_t for the int8 form).
template <typename T, typename KT, int D, int R, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int DPL = D / 32;            // V columns per lane
  constexpr int PER = 16 / sizeof(KT);   // key elements per 16-byte load
  __shared__ __align__(16) float Qs[R][D];
  __shared__ float Ms[kWarps][R], Ls[kWarps][R];
  __shared__ float As[kWarps][R][D];
  extern __shared__ int Tab[];           // paged: the slot's table row

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KT* __restrict__ kc = static_cast<const KT*>(a.k);
  const KT* __restrict__ vc = static_cast<const KT*>(a.v);
  const int g = blockIdx.x, b = blockIdx.y, i0 = blockIdx.z * R;
  const int Hkv = gridDim.x, n_rep = a.n_rep;
  const int Wn = a.W * n_rep, Hq = Hkv * n_rep;
  const int rows = min(R, Wn - i0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = a.pos[b];
  const int max_len = a.max_len;

  if constexpr (PAGED) {
    // A table entry outside the pool is clamped to it, as XLA clamps a
    // gather's index: never a read out of bounds.
    for (int j = tid; j < a.max_pages; j += kWarps * 32)
      Tab[j] = min(max(a.table[b * a.tab_sb + j], 0), a.n_units - 1);
  }
  for (int idx = tid; idx < R * D; idx += kWarps * 32) {
    const int i = idx / D, d = idx % D, row = i0 + i;
    float x = 0.f;
    if (i < rows) {
      const int w = row / n_rep, hq = g * n_rep + row % n_rep;
      x = acx::to_f32(q[b * a.q_sb + w * a.q_sw + hq * D + d]) * a.scale;
      if constexpr (!kQuant) x = acx::round_to<T>(x);
    }
    Qs[i][d] = x;
  }
  __syncthreads();

  // Live keys: up to the last row's horizon, capped at the cache length.
  // Tiles [0, n_full) lie at or below the first row's horizon (unmasked).
  const int first_pos = p0 + i0 / n_rep;
  const int live = min(p0 + (i0 + rows - 1) / n_rep + 1, max_len);
  const int n_tiles = (live + kTile - 1) / kTile;
  const int n_full = min((min(first_pos, max_len - 1) + 1) / kTile, n_tiles);

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = acx::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  for (int t = warp; t < n_tiles; t += kWarps) {
    const int c0 = t * kTile, c = c0 + lane;

    // This lane's key row: where it lives, its scales, its logits against
    // the block's query rows. voff is the element offset of its V row (of
    // row 0 of unit 0 for a lane past the live keys: in bounds).
    int u = 0, r = 0;
    long long voff = 0;
    float ksc = 1.f, vsc = 1.f;
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    if (c < live) {
      locate<PAGED>(b, c, a.pt, Tab, u, r);
      voff = u * a.v_u + r * a.v_r;
      if constexpr (kQuant) {
        ksc = a.ks[u * a.ks_u + r * a.ks_r + g];
        vsc = a.vs[u * a.vs_u + r * a.vs_r + g];
      }
      const KT* krow = kc + u * a.k_u + r * a.k_r + g * D;
#pragma unroll
      for (int ch = 0; ch < D / PER; ++ch) {
        float kv[PER];
        load_vec<KT, PER>(krow + ch * PER, kv);
        if constexpr (kQuant) {
#pragma unroll
          for (int e = 0; e < PER; ++e) kv[e] *= ksc;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int e = 0; e < PER; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&Qs[i][ch * PER + e]);
            s[i] = fmaf(qv.x, kv[e], s[i]);
            s[i] = fmaf(qv.y, kv[e + 1], s[i]);
            s[i] = fmaf(qv.z, kv[e + 2], s[i]);
            s[i] = fmaf(qv.w, kv[e + 3], s[i]);
          }
        }
      }
    }

    // Online-softmax update; s[i] becomes the probability (rounded to the
    // input type in the bf16/f32 form, kept f32 in the int8 form).
    const bool masked = t >= n_full;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      bool vis = true;
      if (masked) vis = c < live && c <= p0 + (i0 + i) / n_rep;
      const float sv = vis ? s[i] : acx::kNegInf;
      const float m_new = fmaxf(m[i], acx::warp_max(sv));
      const float pr = vis ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + acx::warp_sum(pr);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
      s[i] = kQuant ? pr : acx::round_to<T>(pr);
    }

    // acc += P V over the tile's keys: the warp reads one V row per key,
    // located (paged) by the lane that holds that key. Every load is in
    // bounds and unconditional, so the rows of a chunk are all issued
    // before any is used and their memory latencies overlap; a key past the
    // live length has p = 0 (its tile is masked) and its row is zeroed.
    const int n_keys = min(kTile, live - c0);
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kVChunk) {
      float vv[kVChunk][DPL];
#pragma unroll
      for (int jj = 0; jj < kVChunk; ++jj) {
        long long vo;
        if constexpr (PAGED) {
          vo = __shfl_sync(0xffffffffu, voff, j0 + jj);
        } else {
          vo = b * a.v_u + min(c0 + j0 + jj, live - 1) * a.v_r;
        }
        load_vec<KT, DPL>(vc + vo + g * D + lane * DPL, vv[jj]);
        if (j0 + jj >= n_keys) {
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[jj][e] = 0.f;
        }
        if constexpr (kQuant) {
          const float sj = __shfl_sync(0xffffffffu, vsc, j0 + jj);
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[jj][e] *= sj;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kVChunk; ++jj) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pj = __shfl_sync(0xffffffffu, s[i], j0 + jj);
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[i][e] = fmaf(pj, vv[jj][e], acc[i][e]);
        }
      }
    }
  }

  // Merge the warps' partial states: out = sum_w acc_w e^(m_w - M) /
  // sum_w l_w e^(m_w - M). A warp that saw no live key holds m = -1e30,
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
  T* __restrict__ o = static_cast<T*>(a.o);
  for (int idx = tid; idx < rows * D; idx += kWarps * 32) {
    const int i = idx / D, d = idx % D, row = i0 + i;
    float M = Ms[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, Ms[w][i]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Ms[w][i] - M);
      L = fmaf(Ls[w][i], f, L);
      A = fmaf(As[w][i][d], f, A);
    }
    const int w = row / n_rep, hq = g * n_rep + row % n_rep;
    o[((static_cast<long long>(b) * a.W + w) * Hq + hq) * D + d] =
        acx::from_f32<T>(A / L);
  }
}

template <typename T, typename KT, int R, bool PAGED>
cudaError_t launch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  const int Wn = a.W * a.n_rep;
  const dim3 grid(Hkv, B, (Wn + R - 1) / R);
  const size_t smem = PAGED ? a.max_pages * sizeof(int) : 0;
  decode_kernel<T, KT, 64, R, PAGED><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KT, bool PAGED>
cudaError_t dispatch_r(const Args& a, int B, int Hkv, cudaStream_t stream) {
  const int Wn = a.W * a.n_rep;
  if (Wn <= 1) return launch<T, KT, 1, PAGED>(a, B, Hkv, stream);
  if (Wn <= 2) return launch<T, KT, 2, PAGED>(a, B, Hkv, stream);
  if (Wn <= 4) return launch<T, KT, 4, PAGED>(a, B, Hkv, stream);
  return launch<T, KT, 8, PAGED>(a, B, Hkv, stream);
}

template <bool PAGED>
int run(const Args& a, int dtype, int quant, int B, int Hkv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant && (a.ks == nullptr || a.vs == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == acx::kF32)
    return quant ? dispatch_r<float, int8_t, PAGED>(a, B, Hkv, st)
                 : dispatch_r<float, float, PAGED>(a, B, Hkv, st);
  if (dtype == acx::kBF16)
    return quant ? dispatch_r<uint16_t, int8_t, PAGED>(a, B, Hkv, st)
                 : dispatch_r<uint16_t, uint16_t, PAGED>(a, B, Hkv, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Contiguous cache (K2). q [B,W,Hkv*n_rep,D] (head stride D, element stride
// 1); kc/vc [B,max_len,Hkv,D] of q's type, or int8 codes with f32 scales
// ks/vs [B,max_len,Hkv,1] when quant != 0 (ks/vs ignored otherwise); rows
// contiguous [Hkv, D] blocks on 16-byte bounds; pos int32 [B]; o contiguous
// [B,W,Hkv*n_rep*D] of q's type. strides = {q_sb, q_sw, k_sb, k_ss, v_sb,
// v_ss, ks_sb, ks_ss, vs_sb, vs_ss} in elements. Returns the cudaError_t of
// the launch.
extern "C" int acx_flash_decode(const void* q, const void* kc, const void* vc,
                                const void* ks, const void* vs,
                                const void* pos, void* o, int dtype, int quant,
                                int B, int W, int Hkv, int n_rep, int D,
                                int max_len, const long long* strides,
                                void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  // Built for GPT-2's head dim alone (see flash_attention.cu).
  if (B <= 0 || W <= 0 || Hkv <= 0 || n_rep <= 0 || max_len <= 0 || D != 64)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, kc, vc, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(pos),
               nullptr, o, W, n_rep, max_len, 1, 0, B,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], 0,
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  return run<false>(a, dtype, quant, B, Hkv, stream);
}

// Paged pools (B9). kp/vp [n_pages,page_tokens,Hkv,D] (with scale pools
// ksp/vsp [n_pages,page_tokens,Hkv,1] when quant != 0), table int32
// [B,max_pages] (row stride tab_sb) naming slot b's page for positions
// [j*page_tokens, (j+1)*page_tokens); everything else as acx_flash_decode.
// strides = {q_sb, q_sw, k_sp, k_ss, v_sp, v_ss, ks_sp, ks_ss, vs_sp, vs_ss,
// tab_sb}.
extern "C" int acx_paged_decode(const void* q, const void* kp, const void* vp,
                                const void* ksp, const void* vsp,
                                const void* pos, const void* table, void* o,
                                int dtype, int quant, int B, int W, int Hkv,
                                int n_rep, int D, int page_tokens,
                                int max_pages, int n_pages,
                                const long long* strides, void* stream) {
  cudaGetLastError();
  if (B <= 0 || W <= 0 || Hkv <= 0 || n_rep <= 0 || D != 64 ||
      page_tokens <= 0 || max_pages <= 0 || max_pages > kMaxPages ||
      n_pages <= 0 ||
      static_cast<long long>(page_tokens) * max_pages > (1 << 30))
    return cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, kp, vp, static_cast<const float*>(ksp),
               static_cast<const float*>(vsp), static_cast<const int*>(pos),
               static_cast<const int*>(table), o, W, n_rep,
               page_tokens * max_pages, page_tokens, max_pages, n_pages,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
               s[10],
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  return run<true>(a, dtype, quant, B, Hkv, stream);
}
