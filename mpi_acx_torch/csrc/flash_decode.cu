// K2: length-aware GQA decode attention for Hopper (sm_90a), CUDA C++ behind a
// plain C entry point (loaded with ctypes by mpi_acx_torch/ops/flash_decode.py).
//
// Replaces the TPU kernel mpi_acx_tpu/ops/flash_decode.py:_decode_kernel, the
// body of the pl.pallas_call in flash_decode_attend. Same function: q
// [B, W, Hkv*n_rep, D] pre-scaled by 1/sqrt(D) and rounded to the input type;
// window row i = w*n_rep + r sits at absolute position pos[b] + i // n_rep and
// reads the un-repeated K/V group g of a [B, max_len, Hkv, D] cache; f32
// logits and online-softmax state; probabilities rounded to the input type
// before the P.V product; output [B, W, Hkv*n_rep*D]. Only the live keys
// [0, min(pos + W, max_len)) are read, and only the tiles that straddle a
// row's horizon (or the end of the cache) evaluate the mask.
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
// position 40 of a 1024-long cache moves 41 rows, not 1024. Splitting one
// slot's keys over several blocks (more SMs per slot) is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;    // keys per warp tile: one per lane
constexpr int kVChunk = 16;  // V rows loaded together in the P.V loop

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

// One block per (KV group g, slot b, chunk of R window rows).
template <typename T, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos,
                    T* __restrict__ o, int W, int n_rep, int max_len,
                    long long q_sb, long long q_sw, long long k_sb,
                    long long k_ss, long long v_sb, long long v_ss,
                    float scale) {
  constexpr int DPL = D / 32;            // V columns per lane
  constexpr int PER = 16 / sizeof(T);    // key elements per 16-byte load
  __shared__ __align__(16) float Qs[R][D];
  __shared__ float Ms[kWarps][R], Ls[kWarps][R];
  __shared__ float As[kWarps][R][D];

  const int g = blockIdx.x, b = blockIdx.y, i0 = blockIdx.z * R;
  const int Hkv = gridDim.x;
  const int Wn = W * n_rep, Hq = Hkv * n_rep;
  const int rows = min(R, Wn - i0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = pos[b];

  for (int idx = tid; idx < R * D; idx += kWarps * 32) {
    const int i = idx / D, d = idx % D, row = i0 + i;
    float x = 0.f;
    if (i < rows) {
      const int w = row / n_rep, hq = g * n_rep + row % n_rep;
      x = acx::round_to<T>(acx::to_f32(q[b * q_sb + w * q_sw + hq * D + d]) *
                           scale);
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

    // Logits of this lane's key row against the block's query rows.
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    if (c < live) {
      const T* krow = kc + b * k_sb + c * k_ss + g * D;
#pragma unroll
      for (int ch = 0; ch < D / PER; ++ch) {
        float kv[PER];
        load_vec<T, PER>(krow + ch * PER, kv);
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

    // Online-softmax update; s[i] becomes the (rounded) probability.
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
      s[i] = acx::round_to<T>(pr);
    }

    // acc += P V over the tile's live keys: the warp reads one V row per
    // key. The rows of a chunk are loaded before any is used, so their
    // memory latencies overlap; keys past the live length have p = 0 (their
    // tile is masked) and are neither read nor accumulated.
    const int n_keys = min(kTile, live - c0);
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kVChunk) {
      float vv[kVChunk][DPL];
#pragma unroll
      for (int jj = 0; jj < kVChunk; ++jj) {
        if (j0 + jj < n_keys) {
          load_vec<T, DPL>(
              vc + b * v_sb + (c0 + j0 + jj) * v_ss + g * D + lane * DPL,
              vv[jj]);
        } else {
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[jj][e] = 0.f;
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
    o[((static_cast<long long>(b) * W + w) * Hq + hq) * D + d] =
        acx::from_f32<T>(A / L);
  }
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* pos, void* o, int B, int W, int Hkv, int n_rep,
                   int max_len, const long long* st, cudaStream_t stream) {
  const int Wn = W * n_rep;
  const dim3 grid(Hkv, B, (Wn + R - 1) / R);
  flash_decode_kernel<T, D, R><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<T*>(o), W, n_rep, max_len, st[0], st[1], st[2], st[3],
      st[4], st[5], static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_r(const void* q, const void* kc, const void* vc,
                       const void* pos, void* o, int B, int W, int Hkv,
                       int n_rep, int max_len, const long long* st,
                       cudaStream_t stream) {
  const int Wn = W * n_rep;
  if (Wn <= 1)
    return launch<T, D, 1>(q, kc, vc, pos, o, B, W, Hkv, n_rep, max_len, st, stream);
  if (Wn <= 2)
    return launch<T, D, 2>(q, kc, vc, pos, o, B, W, Hkv, n_rep, max_len, st, stream);
  if (Wn <= 4)
    return launch<T, D, 4>(q, kc, vc, pos, o, B, W, Hkv, n_rep, max_len, st, stream);
  return launch<T, D, 8>(q, kc, vc, pos, o, B, W, Hkv, n_rep, max_len, st, stream);
}

}  // namespace

// q [B,W,Hkv*n_rep,D] (head stride D, element stride 1), kc/vc
// [B,max_len,Hkv,D] (head stride D, element stride 1, rows 16-byte aligned),
// pos int32 [B], o contiguous [B,W,Hkv*n_rep*D]. strides = {q_sb, q_sw, k_sb,
// k_ss, v_sb, v_ss} in elements. Returns the cudaError_t of the launch.
extern "C" int acx_flash_decode(const void* q, const void* kc, const void* vc,
                                const void* pos, void* o, int dtype, int B,
                                int W, int Hkv, int n_rep, int D, int max_len,
                                const long long* strides, void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  // Built for GPT-2's head dim alone (see flash_attention.cu).
  if (B <= 0 || W <= 0 || Hkv <= 0 || n_rep <= 0 || max_len <= 0 || D != 64)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acx::kF32)
    return dispatch_r<float, 64>(q, kc, vc, pos, o, B, W, Hkv, n_rep, max_len,
                                 strides, st);
  if (dtype == acx::kBF16)
    return dispatch_r<uint16_t, 64>(q, kc, vc, pos, o, B, W, Hkv, n_rep,
                                    max_len, strides, st);
  return cudaErrorInvalidValue;
}
