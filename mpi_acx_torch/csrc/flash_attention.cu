// K1: flash-attention forward for Hopper (sm_90a), CUDA C++ behind a plain C
// entry point (loaded with ctypes by mpi_acx_torch/ops/attention.py).
//
// Replaces the TPU kernel mpi_acx_tpu/ops/attention.py:_flash_kernel, the
// body of the pl.pallas_call in _flash_fwd_impl that flash_attention reaches.
// It computes the same function: q pre-scaled by 1/sqrt(D) and rounded to the
// input type, f32 logits, an online softmax whose (m, l, acc) state stays in
// f32 registers, probabilities rounded to the input type before the P.V
// product, out = acc / l. Key tiles above the causal diagonal are never
// visited; only the tiles that straddle the diagonal or the ragged key tail
// evaluate the mask. Any S and Sk are accepted: the ragged tails are masked,
// there is no "S divides into 128-multiples" rule.
//
// What bounds it on the H100. At the serving shapes (B=1, H=12, D=64,
// S <= 1024) a causal call does 2*H*D*S^2 FLOPs over 8*S*H*D bytes (bf16):
// below ~300 FLOP/byte, so the roofline bound is the bytes, about 2 us at
// S=1024, and a (b, h) pair yields only S/64 blocks, so few SMs hold work
// and each must turn its tiles around fast. What the design does about it:
//  * bf16 runs both products on the tensor cores (mma.sync m16n8k16, f32
//    accumulate). Each warp owns 16 query rows; the logits' accumulator
//    fragments are exactly the A fragments of the P.V product, so P never
//    leaves registers. K is staged row-major and V transposed in shared
//    memory with row pitches that make every fragment load conflict-free.
//  * f32 runs true-f32 FMAs (the tensor cores' f32 input mode is TF32,
//    which would break the f32 contract): 16 rows per warp, one key per
//    lane, K/V tiles staged once in shared memory and reused by all 64 rows.
//  * The heaviest causal q tiles are scheduled first so the short ones fill
//    the tail. wgmma/TMA pipelines and splitting long rows across blocks are
//    later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16;                   // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // query rows per block

// Tiles [0, n_full) are visible to every row of the q tile at q0; tiles
// [n_full, n_tiles) straddle the diagonal or the key tail and are masked.
__device__ __forceinline__ void tile_bounds(int q0, int S, int Sk, int causal,
                                            int block_k, int* n_tiles,
                                            int* n_full) {
  if (causal) {
    *n_tiles = (min(q0 + kBlockQ, S) - 1) / block_k + 1;
    *n_full = (q0 + 1) / block_k;
  } else {
    *n_tiles = (Sk + block_k - 1) / block_k;
    *n_full = Sk / block_k;
  }
}

// ---- bf16: tensor cores -----------------------------------------------------

constexpr int kMmaBK = 64;  // keys per tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(acx::from_f32<uint16_t>(lo)) |
         (static_cast<uint32_t>(acx::from_f32<uint16_t>(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * ((kBlockQ + kMmaBK) * (D + 8) + D * (kMmaBK + 8));
}

// Fragment layout of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
// A (16x16, row): {a0,a1} row g, cols 2t..2t+1; {a2,a3} row g+8; {a4,a5}
// row g, cols 8+2t..; {a6,a7} row g+8, cols 8+2t... B (16x8, col): {b0,b1}
// rows 2t..2t+1 of col g; {b2,b3} rows 8+2t... C (16x8): {c0,c1} row g,
// cols 2t..2t+1; {c2,c3} row g+8.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int S,
               int Sk, long long q_sb, long long q_ss, long long k_sb,
               long long k_ss, long long v_sb, long long v_ss, long long o_sb,
               long long o_ss, int causal, float scale) {
  constexpr int QP = D + 8;        // Qs/Ks row pitch (elements)
  constexpr int VP = kMmaBK + 8;   // Vt row pitch
  constexpr int NKS = D / 16;      // k steps of Q K^T
  constexpr int NSB = kMmaBK / 8;  // 8-key column blocks of the logits
  constexpr int NOB = D / 8;       // 8-wide column blocks of the output
  constexpr int NPS = kMmaBK / 16; // k steps of P V
  extern __shared__ uint4 smem_u4[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_u4);  // [kBlockQ][QP]
  uint16_t* Ks = Qs + kBlockQ * QP;                     // [kMmaBK][QP]
  uint16_t* Vt = Ks + kMmaBK * QP;                      // [D][VP], transposed

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBlockQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int idx = tid; idx < kBlockQ * D; idx += kWarps * 32) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[r * QP + d] =
        s < S ? acx::from_f32<uint16_t>(
                    acx::to_f32(q[b * q_sb + s * q_ss + h * D + d]) * scale)
              : 0;
  }
  __syncthreads();
  uint32_t qa[NKS][4];
  const uint16_t* qrow = Qs + (warp * kRows + g) * QP + 2 * t;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    qa[ks][0] = ld32(qrow + ks * 16);
    qa[ks][1] = ld32(qrow + 8 * QP + ks * 16);
    qa[ks][2] = ld32(qrow + ks * 16 + 8);
    qa[ks][3] = ld32(qrow + 8 * QP + ks * 16 + 8);
  }

  int n_tiles, n_full;
  tile_bounds(q0, S, Sk, causal, kMmaBK, &n_tiles, &n_full);
  const int row_lo = q0 + warp * kRows + g;  // this thread's two rows
  const int row_hi = row_lo + 8;
  float m_lo = acx::kNegInf, m_hi = acx::kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[NOB][4];
#pragma unroll
  for (int ob = 0; ob < NOB; ++ob)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ob][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * kMmaBK;
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kMmaBK * D; idx += kWarps * 32) {
      const int r = idx / D, d = idx % D, c = c0 + r;
      uint16_t kx = 0, vx = 0;
      if (c < Sk) {
        kx = k[b * k_sb + c * k_ss + h * D + d];
        vx = v[b * v_sb + c * v_ss + h * D + d];
      }
      Ks[r * QP + d] = kx;
      Vt[d * VP + r] = vx;
    }
    __syncthreads();

    // Logits: 16 rows x 64 keys per warp, f32 accumulators.
    float sc[NSB][4];
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
      const uint16_t* krow = Ks + (nb * 8 + g) * QP + 2 * t;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        mma_bf16(sc[nb], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }
    if (j >= n_full) {
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nb * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= Sk || (causal && col > row)) sc[nb][e] = acx::neg_inf();
        }
    }

    // Online softmax; a row's 64 logits sit in the 4 threads of a quad.
    float mx_lo = acx::kNegInf, mx_hi = acx::kNegInf;
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[nb][0], sc[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[nb][2], sc[nb][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    // P as the A fragments of P V: logits block nb is half (nb & 1) of
    // k step nb / 2. Masked logits are -inf, so their p is exactly 0.
    uint32_t pa[NPS][4];
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) {
      const float p0 = expf(sc[nb][0] - mn_lo), p1 = expf(sc[nb][1] - mn_lo);
      const float p2 = expf(sc[nb][2] - mn_hi), p3 = expf(sc[nb][3] - mn_hi);
      s_lo += p0 + p1;
      s_hi += p2 + p3;
      pa[nb >> 1][(nb & 1) * 2] = pack_bf16(p0, p1);
      pa[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o2);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o2);
    }
    l_lo = corr_lo * l_lo + s_lo;
    l_hi = corr_hi * l_hi + s_hi;
#pragma unroll
    for (int ob = 0; ob < NOB; ++ob) {
      acc[ob][0] *= corr_lo;
      acc[ob][1] *= corr_lo;
      acc[ob][2] *= corr_hi;
      acc[ob][3] *= corr_hi;
      const uint16_t* vrow = Vt + (ob * 8 + g) * VP + 2 * t;
#pragma unroll
      for (int ps = 0; ps < NPS; ++ps)
        mma_bf16(acc[ob], pa[ps], ld32(vrow + ps * 16), ld32(vrow + ps * 16 + 8));
    }
  }

#pragma unroll
  for (int ob = 0; ob < NOB; ++ob) {
    const int d = ob * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(o + b * o_sb + row_lo * o_ss + h * D + d) =
          pack_bf16(acc[ob][0] / l_lo, acc[ob][1] / l_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(o + b * o_sb + row_hi * o_ss + h * D + d) =
          pack_bf16(acc[ob][2] / l_hi, acc[ob][3] / l_hi);
  }
}

// ---- f32: FMA ---------------------------------------------------------------

constexpr int kBlockK = 32;                 // keys per tile: one per lane
constexpr int kPPitch = kRows + 4;          // P tile pitch (16B-aligned rows)

template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (kBlockQ * D                   // Qs: pre-scaled q tile
              + kBlockK * (D + 1)           // Ks: padded, conflict-free
              + kBlockK * D                 // Vs
              + kWarps * kBlockK * kPPitch);  // Ps: per warp, [key][row]
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int Sk, long long q_sb, long long q_ss, long long k_sb,
              long long k_ss, long long v_sb, long long v_ss, long long o_sb,
              long long o_ss, int causal, float scale) {
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int KP = D + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * D;
  float* Vs = Ks + kBlockK * KP;
  float* Ps = Vs + kBlockK * D;

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBlockQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < kBlockQ * D; idx += kWarps * 32) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[idx] = s < S ? q[b * q_sb + s * q_ss + h * D + d] * scale : 0.f;
  }

  int n_tiles, n_full;
  tile_bounds(q0, S, Sk, causal, kBlockK, &n_tiles, &n_full);
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = acx::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * kRows;  // this warp's first row within the tile
  float* P = Ps + warp * kBlockK * kPPitch;

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * kBlockK;
    __syncthreads();  // Qs written / previous tile fully consumed
    for (int idx = tid; idx < kBlockK * D; idx += kWarps * 32) {
      const int r = idx / D, d = idx % D, c = c0 + r;
      const bool in = c < Sk;
      Ks[r * KP + d] = in ? k[b * k_sb + c * k_ss + h * D + d] : 0.f;
      Vs[r * D + d] = in ? v[b * v_sb + c * v_ss + h * D + d] : 0.f;
    }
    __syncthreads();

    // Logits of this lane's key against the warp's rows.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2],
                  k3 = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }

    // Online-softmax update, one row at a time across the warp.
    const bool masked = j >= n_full;
    const int c = c0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      bool vis = true;
      if (masked) vis = c < Sk && (!causal || c <= q0 + row0 + r);
      const float sv = vis ? s[r] : acx::kNegInf;
      const float m_new = fmaxf(m[r], acx::warp_max(sv));
      const float p = vis ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = corr * l[r] + acx::warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < DPL; ++cc) acc[r][cc] *= corr;
      P[lane * kPPitch + r] = p;
    }
    __syncwarp();

    // acc += P V: lanes own output columns, keys are the reduction.
    const int n_keys = min(kBlockK, Sk - c0);
    for (int jj = 0; jj < n_keys; ++jj) {
      float pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        const float4 t = *reinterpret_cast<const float4*>(P + jj * kPPitch + r);
        pr[r] = t.x;
        pr[r + 1] = t.y;
        pr[r + 2] = t.z;
        pr[r + 3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < DPL; ++cc) {
        const float vv = Vs[jj * D + lane + 32 * cc];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][cc] = fmaf(pr[r], vv, acc[r][cc]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s_idx = q0 + row0 + r;
    if (s_idx < S) {
#pragma unroll
      for (int cc = 0; cc < DPL; ++cc)
        o[b * o_sb + s_idx * o_ss + h * D + lane + 32 * cc] = acc[r][cc] / l[r];
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, int, int,
                           long long, long long, long long, long long,
                           long long, long long, long long, long long, int,
                           float);

template <typename T>
cudaError_t launch(FwdKernel<T> kernel, int smem, const void* q,
                   const void* k, const void* v, void* o, int B, int S, int Sk,
                   int H, int D, const long long* st, int causal,
                   cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

// Above 48 KB a block's shared memory must be opted into, once per kernel.
template <typename T>
cudaError_t allow_smem(FwdKernel<T> kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t dispatch(int dtype, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int Sk, int H, const long long* st,
                     int causal, cudaStream_t stream) {
  if (dtype == acx::kBF16) {
    static const cudaError_t attr =
        allow_smem<uint16_t>(flash_fwd_bf16<D>, bf16_smem_bytes<D>());
    if (attr != cudaSuccess) return attr;
    return launch<uint16_t>(flash_fwd_bf16<D>, bf16_smem_bytes<D>(), q, k, v,
                            o, B, S, Sk, H, D, st, causal, stream);
  }
  if (dtype == acx::kF32) {
    static const cudaError_t attr =
        allow_smem<float>(flash_fwd_f32<D>, f32_smem_bytes<D>());
    if (attr != cudaSuccess) return attr;
    return launch<float>(flash_fwd_f32<D>, f32_smem_bytes<D>(), q, k, v, o,
                         B, S, Sk, H, D, st, causal, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,S,H,D], k/v [B,Sk,H,D], o [B,S,H,D]; the head stride must be D and
// the element stride 1. strides = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
// o_ss} in elements. Returns the cudaError_t of the launch (0 = launched).
extern "C" int acx_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int S, int Sk,
                                   int H, int D, const long long* strides,
                                   int causal, void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  if (B <= 0 || S <= 0 || Sk <= 0 || H <= 0 || (causal && S != Sk))
    return cudaErrorInvalidValue;
  // Built for GPT-2's head dim alone; another D gets its own instantiation
  // when a configuration that needs it arrives.
  if (D != 64) return cudaErrorInvalidValue;
  return dispatch<64>(dtype, q, k, v, o, B, S, Sk, H, strides, causal,
                      static_cast<cudaStream_t>(stream));
}
