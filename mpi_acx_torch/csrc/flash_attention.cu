// K1: flash-attention forward for Hopper (sm_90a), CUDA C++ behind a plain C
// entry point (loaded with ctypes by mpi_acx_torch/ops/attention.py).
//
// Replaces the TPU kernel mpi_acx_tpu/ops/attention.py:_flash_kernel, the
// body of the pl.pallas_call in _flash_fwd_impl that flash_attention reaches
// (B6), and serves two more TPU entry points:
//  * B10, _flash_kernel(emit_lse=True) in _flash_lse_fwd_impl, which
//    flash_attention_lse reaches: the same kernel with EmitLse set writes
//    the row logsumexp lse[b, h, row] = log sum_k exp(q.k/sqrt(D)) (f32,
//    natural units) beside o. The TPU kernel packs it into column D of one
//    f32 output; here it is a second output.
//  * B7, _flash_stream_kernel in _flash_stream_fwd_impl: the TPU needs a
//    second kernel to hold one K/V tile at a time past its VMEM limit;
//    this kernel streams K/V tiles through shared memory for any Sk, so the
//    streaming entry point launches it unchanged.
// It computes the same function: q pre-scaled by 1/sqrt(D) and rounded to the
// input type, f32 logits, an online softmax whose (m, l, acc) state stays in
// f32 registers, probabilities rounded to the input type before the P.V
// product (l sums the unrounded f32 p), out = acc / l. Keys above the causal
// diagonal and past Sk get probability exactly 0. Any S and Sk are accepted.
//
// bf16: wgmma on TMA-fed stages (flash_fwd_bf16).
//  * A CTA holds 128 query rows as two consumer warpgroups of 64 rows
//    (wgmma's M), or 64 rows with one consumer warpgroup; a third (second)
//    warpgroup is the producer. The wrapper picks 64 rows when all CTAs of
//    64 rows run in one wave, B*H*ceil(S/64) <= the card's SM count (on an
//    H100, serving prefill at B=1, H=12, S <= 704), else 128: within one
//    wave a lone warpgroup has its SM's tensor cores to itself and ends
//    sooner; past it, one wave of 128-row CTAs beats two of 64.
//  * Key tiles are 128 keys: with D = 64 a 64-key tile gives each wgmma of
//    Q.K^T only 4 k-steps of work per barrier round trip and per row
//    max/sum reduction; 128 keys halve both while the logits (64 f32 per
//    thread) and P (32 registers) still fit beside the output accumulators
//    (D / 2 a thread: 32 at D = 64, 64 at D = 128) in the consumers' 232
//    registers.
//  * One producer thread loads by TMA (cp.async.bulk.tensor over 4-D tensor
//    maps [B, S, H, D] with the caller's strides, box [1, rows, 1, 64],
//    128-byte swizzle: a 64-wide bf16 row is exactly 128 bytes, one swizzle
//    atom) into a ring of kStages K/V stages, each with its own full
//    barriers (K apart from V, so Q.K^T starts before V lands) and an empty
//    barrier that every consumer warp arrives on when it is done with the
//    stage. Q comes in once. A D = 128 tile is two atoms, columns 0-63 and
//    64-127, each its own box of the same map, stored one after the other.
//    TMA zero-fills rows past S and Sk; the key tail is still masked.
//    setmaxnreg moves registers from the producer (40) to the consumers.
//  * S = Q.K^T is wgmma m64n128k16 with both operands in swizzled shared
//    memory, D / 16 k-steps, each inside one atom. O += P.V is wgmma
//    m64nDk16 with P in registers: the logits' accumulator layout is
//    exactly the A-fragment layout, so P is packed to bf16 in place and
//    never touches shared memory; V is the B operand read from its
//    row-major tile with the transpose flag, never copied. At D = 128 the
//    product's 128 columns span both atoms of the V tile: the descriptor's
//    leading byte offset steps from the first atom to the second.
//  * D = 64: softmax in raw-logit units. The scale 1/8 is a power of two,
//    so q*(1/8) rounded to bf16 is q scaled exactly (every normal q) and
//    the scaled logit is the raw one times 1/8 exactly. The scale therefore
//    moves into the exponent: m is the raw row max, p = exp2f(s*c - m*c)
//    with c = log2(e)/8, and lse = m/8 + logf(l).
//  * D = 128: 1/sqrt(128) is not a power of two, so the kernel computes
//    what the TPU kernel computes: each consumer warpgroup scales its own Q
//    tile once, in shared memory after the TMA lands (q * (1/sqrt(D)) in
//    f32, rounded to bf16; a proxy fence orders those stores before wgmma
//    reads the tile), and the logits are then used as they are: p =
//    exp2f((s - m) * log2(e)), and m is the scaled row max, so lse = m +
//    logf(l) (the TPU kernel's own form).
//  * Key tiles are visited from the last (diagonal or tail) to the first,
//    so only the first one or two iterations evaluate the mask; tiles
//    above the diagonal are never loaded. q tiles are scheduled heaviest
//    first (no persistent scheduler) so the short ones fill the tail.
//  * The epilogue stores acc / l rounded to bf16; EmitLse is a
//    compile-time flag, so B6's instantiations compile the lse store out.
//    Overlap of one warpgroup's softmax with the other's products is left
//    to the warp schedulers (FA3's explicit ping-pong is later work).
// f32: true-f32 FMAs (flash_fwd_f32; the tensor cores' f32 input mode is
// TF32, which would break the f32 contract): 16 rows per warp, one key per
// lane, K/V tiles staged once in shared memory and reused by all 64 rows.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s):
//  * B6, serving prefill (B=1, H=12, S = 32..512, causal): the bytes
//    (8*S*H*D, under 1 us) and, below them, the launch: 12-96 CTAs of 64
//    rows, one to four key tiles each. The design keeps the per-tile
//    latency low (one TMA per operand, no staging passes) and the 64-row
//    variant doubles the SMs at work, each with half the tensor work.
//  * B10, training (B=4, S=1024, causal): the bytes (25.4 MB, 7.6 us)
//    just above the operations (6.4 GFLOP, 6.5 us); 384 CTAs of 128 rows.
//    At Llama-3-8B's width (H=32, D=128) the bytes (134.7 MB, 40.2 us)
//    above the operations (34.4 GFLOP, 34.8 us); 1024 CTAs of 128 rows.
//  * B7, long context (B=1, S=16384, causal): the operations (412 GFLOP,
//    0.417 ms); 1536 CTAs of 128 rows, up to 128 key tiles each, where the
//    producer's ring keeps the next tiles in flight behind the products.
//  * B6 at Llama-3-8B's prefill (B=1, H=32, D=128, S = 32..512, causal):
//    the bytes below a microsecond and the operations at most 8.6 GFLOP
//    (8.7 us at S=512); 32-128 CTAs of 64 rows, or 128 of 128.
// Resources (cuobjdump -res-usage, sm_90a): flash_fwd_bf16<2, D, *> is
// allocated 168 registers a thread at launch (384 threads), which
// setmaxnreg turns into 232 for the consumers and 40 for the producer;
// flash_fwd_bf16<1, 64, *> uses 131, <1, 128, *> 166; no instantiation
// spills (chip_smoke.py's phase_sass fails on local memory). Shared
// memory is dynamic (ptxas reports none): bf16_smem_bytes, at D = 64
// 115,792 bytes a CTA of 128 rows and 107,600 of 64, at D = 128 230,480
// and 214,096 (the three-stage ring of 64 KB K/V stages fits the 227 KB a
// block may take; the lse is stored from registers and takes none), so
// one CTA per SM, which the registers require anyway.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kTileKeys = 128;              // bf16: keys per tile
constexpr int kStages = 3;                  // bf16: K/V ring depth
constexpr int kWgRows = 64;                 // bf16: query rows per consumer WG
constexpr int kAtomCols = 64;               // bf16 columns of a 128B atom
constexpr float kLog2e = 1.4426950408889634f;
// One K or V stage, and one warpgroup's Q tile, at head dim D: D / 64
// atoms of rows x 128 bytes, one after the other.
template <int D>
__host__ __device__ constexpr int tile_bytes() { return kTileKeys * D * 2; }
template <int D>
__host__ __device__ constexpr int q_bytes() { return kWgRows * D * 2; }

// Tiles [0, n_full) are visible to every row of the q tile [q0, q0 +
// block_q); tiles [n_full, n_tiles) straddle the diagonal or the key tail
// and are masked.
__device__ __forceinline__ void tile_bounds(int q0, int block_q, int S, int Sk,
                                            int causal, int block_k,
                                            int* n_tiles, int* n_full) {
  if (causal) {
    *n_tiles = (min(q0 + block_q, S) - 1) / block_k + 1;
    *n_full = (q0 + 1) / block_k;
  } else {
    *n_tiles = (Sk + block_k - 1) / block_k;
    *n_full = Sk / block_k;
  }
}

// ---- bf16: wgmma on TMA-fed stages -----------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(acx::from_f32<uint16_t>(lo)) |
         (static_cast<uint32_t>(acx::from_f32<uint16_t>(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of a 4-D map {D, H, S, B} (innermost first), its columns
// from d on, into shared memory; completes the box's bytes of the
// barrier's expected transactions.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b)
      : "memory");
}

// The atoms of a `rows`-row tile at head dim D, from one map: atom a holds
// columns [64a, 64a + 64) at dst + a * rows * 128.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int rows, int s,
                                              int h, int b) {
#pragma unroll
  for (int a = 0; a < D / kAtomCols; ++a)
    tma_load(dst + a * rows * 128, map, bar, a * kAtomCols, s, h, b);
}

// wgmma shared-memory descriptor of a 128B-swizzled tile whose 8-row groups
// are 1024 bytes apart (SBO = 1024 B), tile base 1024-byte aligned. A
// k-step within the 128-byte row advances the start address by its byte
// offset. LBO: unused (16 B) where the operand's extent along the
// contiguous dimension is one atom; for the MN-major V read by an n128
// product it is the byte distance from the first 64 columns' atom to the
// next one's.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of one warpgroup's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders reads of wgmma accumulators after wgmma_wait_all: to the compiler
// the asm of a wgmma yields its outputs at once, so without this it could
// hoist their uses above the wait.
// The same before a wgmma_fence, so that writes to the accumulators and to
// the A fragments stay ahead of the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// S (+)= A.B^T: m64n128k16, A and B K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P.V: m64n64k16, A (P) from registers, B (V) MN-major in
// 128B-swizzled shared memory, read transposed (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P.V at D = 128: m64n128k16, A (P) from registers, B (V) MN-major in
// 128B-swizzled shared memory over two atoms (LBO in the descriptor), read
// transposed.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory of a CTA with NC consumer warpgroups at head dim D: 1024
// bytes of slack to align the tiles to the swizzle's period, Q (64 rows per
// warpgroup), the K and V rings, and the barriers (q_full, k_full[],
// v_full[], empty[]).
template <int NC, int D>
constexpr int bf16_smem_bytes() {
  return 1024 + NC * q_bytes<D>() + 2 * kStages * tile_bytes<D>() +
         8 * (1 + 3 * kStages);
}

// A bf16 pair times `scale` in f32, each rounded back to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  return pack_bf16(__uint_as_float(w << 16) * scale,
                   __uint_as_float(w & 0xffff0000u) * scale);
}

// Accumulator layout of wgmma m64nN (f32), thread t of a warpgroup, warp
// w = t / 32, g = (t % 32) / 4, qd = t % 4: d[4*nb + e] holds row 16w + g
// (e < 2) or 16w + g + 8 (e >= 2), column 8*nb + 2*qd + (e & 1). The bf16
// A fragment of a k16 step ks is {d[8ks..8ks+1], d[8ks+2..+3],
// d[8ks+4..+5], d[8ks+6..+7]}, each pair packed: the logits' accumulators
// of keys [16ks, 16ks + 16) are P's A fragment for that step.
template <int NC, int D, bool EmitLse>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               uint16_t* __restrict__ o, float* __restrict__ lse, int S,
               int Sk, long long o_sb, long long o_ss, int causal,
               float qscale) {
  static_assert(D == 64 || D == 128, "head dim");
  // D = 64 folds the scale into the exponent, D = 128 scales Q (see the
  // note above): m is in raw-logit units in the first, scaled in the second.
  constexpr bool kFold = D == 64;
  constexpr int kRowsPerCta = NC * kWgRows;
  constexpr int kTB = tile_bytes<D>(), kQB = q_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + NC * kQB;
  const uint32_t sv = sk + kStages * kTB;
  const uint32_t q_full = sv + kStages * kTB;
  const uint32_t k_full = q_full + 8;             // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int n_qt = (S + kRowsPerCta - 1) / kRowsPerCta;
  const int q0 = (n_qt - 1 - blockIdx.x) * kRowsPerCta;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128;
  int n_tiles, n_full;
  tile_bounds(q0, kRowsPerCta, S, Sk, causal, kTileKeys, &n_tiles, &n_full);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // Producer. With two consumer warpgroups (384 threads, 168 registers
    // each at launch) it hands its registers to them; with one the block
    // is small enough that every thread already has what it needs.
    if (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == NC * 128) {
      mbar_expect_tx(q_full, NC * kQB);
      for (int w = 0; w < NC; ++w)
        tma_load_tile<D>(sq + w * kQB, &tm_q, q_full, kWgRows,
                         q0 + w * kWgRows, h, b);
      int s = 0;
      uint32_t par = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int c0 = (n_tiles - 1 - it) * kTileKeys;  // last tile first
        mbar_wait(empty + 8 * s, par ^ 1);  // a fresh stage passes at once
        mbar_expect_tx(k_full + 8 * s, kTB);
        tma_load_tile<D>(sk + s * kTB, &tm_k, k_full + 8 * s, kTileKeys, c0,
                         h, b);
        mbar_expect_tx(v_full + 8 * s, kTB);
        tma_load_tile<D>(sv + s * kTB, &tm_v, v_full + 8 * s, kTileKeys, c0,
                         h, b);
        if (++s == kStages) {
          s = 0;
          par ^= 1;
        }
      }
    }
    return;
  }
  if (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // Consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64).
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int row_lo = q0 + wg * kWgRows + warp * 16 + g;  // this thread's rows
  const int row_hi = row_lo + 8;
  const uint32_t q_tile = sq + wg * kQB;
  const float c = kFold ? kLog2e / 8.f : kLog2e;
  float m_lo = acx::neg_inf(), m_hi = acx::neg_inf(), l_lo = 0.f, l_hi = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  if constexpr (!kFold) {
    // q * (1/sqrt(D)) rounded to bf16, in place, by this warpgroup's 128
    // threads over its own tile (the swizzle only permutes the elements);
    // then the stores are made visible to wgmma's async proxy.
    uint4* qv = reinterpret_cast<uint4*>(smem_raw +
                                         (q_tile - smem_addr(smem_raw)));
#pragma unroll
    for (int i = 0; i < kQB / 16 / 128; ++i) {
      uint4 w = qv[t + 128 * i];
      w.x = scale_pair(w.x, qscale);
      w.y = scale_pair(w.y, qscale);
      w.z = scale_pair(w.z, qscale);
      w.w = scale_pair(w.w, qscale);
      qv[t + 128 * i] = w;
    }
    fence_proxy_async();
    wg_sync(wg);
  }
  int s = 0;
  uint32_t par = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int j = n_tiles - 1 - it, c0 = j * kTileKeys;
    // Logits of 64 rows x 128 keys (D = 64: raw, q unscaled; D = 128:
    // scaled). k-step ks reads 16 columns of atom ks / 4.
    float sc[64];
    mbar_wait(k_full + 8 * s, par);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int at = ks / 4, off = 32 * (ks % 4);
      wgmma_ss_n128(sc, sw128_desc(q_tile + at * kWgRows * 128 + off),
                    sw128_desc(sk + s * kTB + at * kTileKeys * 128 + off),
                    ks);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if (j >= n_full) {
#pragma unroll
      for (int nb = 0; nb < kTileKeys / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nb * 8 + 2 * qd + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= Sk || (causal && col > row))
            sc[nb * 4 + e] = acx::neg_inf();
        }
    }

    // Online softmax; a row's 128 logits sit in the 4 threads of a quad.
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nb = 0; nb < kTileKeys / 8; ++nb) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[nb * 4], sc[nb * 4 + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[nb * 4 + 2], sc[nb * 4 + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
    }
    // A row with no visible key yet keeps m = -inf; its exponent offset
    // is then 0 so that masked logits still give exp2f(-inf) = 0.
    const float mc_lo = mx_lo == acx::neg_inf() ? 0.f : mx_lo * c;
    const float mc_hi = mx_hi == acx::neg_inf() ? 0.f : mx_hi * c;
    const float corr_lo = exp2f(fmaf(m_lo, c, -mc_lo));
    const float corr_hi = exp2f(fmaf(m_hi, c, -mc_hi));
    m_lo = mx_lo;
    m_hi = mx_hi;
    uint32_t pa[kTileKeys / 16][4];
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int nb = 0; nb < kTileKeys / 8; ++nb) {
      const float p0 = exp2f(fmaf(sc[nb * 4], c, -mc_lo));
      const float p1 = exp2f(fmaf(sc[nb * 4 + 1], c, -mc_lo));
      const float p2 = exp2f(fmaf(sc[nb * 4 + 2], c, -mc_hi));
      const float p3 = exp2f(fmaf(sc[nb * 4 + 3], c, -mc_hi));
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
    for (int ob = 0; ob < D / 8; ++ob) {
      acc[ob * 4] *= corr_lo;
      acc[ob * 4 + 1] *= corr_lo;
      acc[ob * 4 + 2] *= corr_hi;
      acc[ob * 4 + 3] *= corr_hi;
    }

    // acc += P V: 8 k-steps of 16 keys, each 16 rows of the V tile (2048 B
    // of each atom; at D = 128 the second atom lies kTileKeys * 128 bytes
    // on, the descriptor's LBO).
    mbar_wait(v_full + 8 * s, par);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileKeys / 16; ++ks) {
      if constexpr (D == 64)
        wgmma_rs_n64(acc, pa[ks], sw128_desc(sv + s * kTB + ks * 2048));
      else
        wgmma_rs_n128(acc, pa[ks], sw128_desc(sv + s * kTB + ks * 2048,
                                              kTileKeys * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with it
    if (++s == kStages) {
      s = 0;
      par ^= 1;
    }
  }

  uint16_t* obase = o + b * o_sb + h * D;
#pragma unroll
  for (int ob = 0; ob < D / 8; ++ob) {
    const int d = ob * 8 + 2 * qd;
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(obase + row_lo * o_ss + d) =
          pack_bf16(acc[ob * 4] / l_lo, acc[ob * 4 + 1] / l_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(obase + row_hi * o_ss + d) =
          pack_bf16(acc[ob * 4 + 2] / l_hi, acc[ob * 4 + 3] / l_hi);
  }
  // A row's m and l are the same in the four threads of its quad. D = 64:
  // m is in raw-logit units, and m / 8 is the scaled max exactly; D = 128:
  // m is the max of the scaled logits already.
  if (EmitLse && qd == 0) {
    constexpr float mscale = kFold ? 0.125f : 1.f;
    float* lrow = lse + (static_cast<long long>(b) * gridDim.y + h) * S;
    if (row_lo < S) lrow[row_lo] = m_lo * mscale + logf(l_lo);
    if (row_hi < S) lrow[row_hi] = m_hi * mscale + logf(l_hi);
  }
}

// ---- f32: FMA ---------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRows = 16;                   // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // query rows per block

constexpr int kBlockK = 32;                 // keys per tile: one per lane
constexpr int kPPitch = kRows + 4;          // P tile pitch (16B-aligned rows)

template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (kBlockQ * D                   // Qs: pre-scaled q tile
              + kBlockK * (D + 1)           // Ks: padded, conflict-free
              + kBlockK * D                 // Vs
              + kWarps * kBlockK * kPPitch);  // Ps: per warp, [key][row]
}

template <int D, bool EmitLse>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int Sk, long long q_sb,
              long long q_ss, long long k_sb, long long k_ss, long long v_sb,
              long long v_ss, long long o_sb, long long o_ss, int causal,
              float scale) {
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
  tile_bounds(q0, kBlockQ, S, Sk, causal, kBlockK, &n_tiles, &n_full);
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
      // m[r] and l[r] are warp-wide values (warp_max / warp_sum).
      if (EmitLse && lane == 0)
        lse[(static_cast<long long>(b) * gridDim.y + h) * S + s_idx] =
            m[r] + logf(l[r]);
    }
  }
}

// ---- launch -----------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so the
// library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D bf16 map {D, H, S, B} (innermost first) over [B, S, H, D] with
// element strides sb, ss (head stride D, element stride 1), boxes of `rows`
// rows of one (b, h) and 64 columns (one swizzle atom; a D = 128 tile is
// two boxes), 128-byte swizzle, zero fill out of bounds.
CUresult encode_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                    int D, long long sb, long long ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kAtomCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

float inv_sqrt(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

// Returns 0 when launched, a cudaError_t, or minus the CUresult of a
// failed tensor-map encode.
template <int NC, int D, bool EmitLse>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Sk, int H, const long long* st,
                int causal, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<NC, D>();
  static_assert(smem <= 232448, "a block's shared memory on sm_90");
  // Above 48 KB a block's shared memory must be opted into, once per kernel.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<NC, D, EmitLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mq, mk, mv;
  CUresult r = encode_map(&mq, q, B, S, H, D, st[0], st[1], kWgRows);
  if (r == CUDA_SUCCESS)
    r = encode_map(&mk, k, B, Sk, H, D, st[2], st[3], kTileKeys);
  if (r == CUDA_SUCCESS)
    r = encode_map(&mv, v, B, Sk, H, D, st[4], st[5], kTileKeys);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const dim3 grid((S + NC * kWgRows - 1) / (NC * kWgRows), H, B);
  flash_fwd_bf16<NC, D, EmitLse><<<grid, (NC + 1) * 128, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), lse, S, Sk, st[6], st[7],
      causal, inv_sqrt(D));
  return cudaGetLastError();
}

template <int D, bool EmitLse>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int Sk, int H, const long long* st,
               int causal, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<D, EmitLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_f32<D, EmitLse><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], causal, inv_sqrt(D));
  return cudaGetLastError();
}

// bf16 takes block_q 64 or 128 (query rows per CTA, chosen by the
// wrapper); the f32 kernel's blocks are 64 rows.
template <int D, bool EmitLse>
int dispatch_d(int dtype, const void* q, const void* k, const void* v,
               void* o, float* lse, int B, int S, int Sk, int H,
               const long long* st, int causal, int block_q,
               cudaStream_t stream) {
  if (dtype == acx::kBF16 && block_q == 128)
    return launch_bf16<2, D, EmitLse>(q, k, v, o, lse, B, S, Sk, H, st,
                                      causal, stream);
  if (dtype == acx::kBF16 && block_q == 64)
    return launch_bf16<1, D, EmitLse>(q, k, v, o, lse, B, S, Sk, H, st,
                                      causal, stream);
  if (dtype == acx::kF32 && block_q == kBlockQ)
    return launch_f32<D, EmitLse>(q, k, v, o, lse, B, S, Sk, H, st, causal,
                                  stream);
  return cudaErrorInvalidValue;
}

// Head dims: 64 (GPT-2, MoE) and 128 (Llama-3-8B), for every entry point.
template <bool EmitLse>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int Sk, int H, int D,
             const long long* st, int causal, int block_q,
             cudaStream_t stream) {
  if (D == 64)
    return dispatch_d<64, EmitLse>(dtype, q, k, v, o, lse, B, S, Sk, H, st,
                                   causal, block_q, stream);
  if (D == 128)
    return dispatch_d<128, EmitLse>(dtype, q, k, v, o, lse, B, S, Sk, H, st,
                                    causal, block_q, stream);
  return cudaErrorInvalidValue;
}

cudaError_t check_args(int B, int S, int Sk, int H, int causal) {
  if (B <= 0 || S <= 0 || Sk <= 0 || H <= 0 || (causal && S != Sk))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// q [B,S,H,D], k/v [B,Sk,H,D], o [B,S,H,D] with D of 64 or 128;
// the head stride must be D and the element stride 1. strides = {q_sb,
// q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss} in elements; for bf16 every
// q/k/v stride and base address must be a multiple of 16 bytes (TMA).
// block_q: query rows per CTA (bf16: 64 or 128; f32: 64). Returns 0 when
// launched, else a cudaError_t, or minus the CUresult of a failed
// tensor-map encode.
extern "C" int acx_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int S, int Sk,
                                   int H, int D, const long long* strides,
                                   int causal, int block_q, void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  const cudaError_t bad = check_args(B, S, Sk, H, causal);
  if (bad != cudaSuccess) return bad;
  return dispatch<false>(dtype, q, k, v, o, nullptr, B, S, Sk, H, D, strides,
                         causal, block_q, static_cast<cudaStream_t>(stream));
}

// B10: the same call, which also writes the row logsumexp to lse, a
// contiguous f32 [B, H, S] tensor.
extern "C" int acx_flash_attention_lse(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int dtype, int B, int S, int Sk, int H,
                                       int D, const long long* strides,
                                       int causal, int block_q, void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  if (lse == nullptr) return cudaErrorInvalidValue;
  const cudaError_t bad = check_args(B, S, Sk, H, causal);
  if (bad != cudaSuccess) return bad;
  return dispatch<true>(dtype, q, k, v, o, lse, B, S, Sk, H, D, strides,
                        causal, block_q, static_cast<cudaStream_t>(stream));
}
