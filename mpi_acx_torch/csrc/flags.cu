// B1-B5: the device side of partitioned signalling for Hopper (sm_90a), CUDA
// C++ behind plain C entry points (loaded with ctypes by
// mpi_acx_torch/ops/flags.py).
//
// Replaces the five Pallas kernels of mpi_acx_tpu/ops/flags.py:
//   B1 _pready_kernel        -> acx_flags_pready      (pready_kernel, k = 1)
//   B2 _pready_many_kernel   -> acx_flags_pready      (pready_kernel)
//   B3 _parrived_kernel      -> acx_flags_parrived    (parrived_kernel, k = 1)
//   B4 _parrived_all_kernel  -> acx_flags_parrived    (parrived_kernel)
//   B5 produce_and_pready's kernel -> acx_flags_produce_and_pready
// The flag table is an int32 [n] tensor holding the protocol states of
// include/acx/state.h. The TPU kernels select over the whole table padded
// to the (8, 128) int32 tile; here each index is bounds-checked instead, with
// the same results: marking an index outside [0, n) changes nothing, polling
// one reads "not arrived", and no kernel writes outside the table. An index
// comes either by value (a host int) or from device memory (a tensor on the
// card, read by the kernel, so the caller never syncs).
//
// pready* and parrived* stay separate kernels and no kernel waits on a flag:
// a kernel that marks partitions ready and polls arrivals can deadlock
// (mpi_acx_tpu/ops/flags.py module docstring).
//
// What bounds them on the H100: B1-B4 touch a few dozen bytes, so a call is
// all launch latency; they are single small blocks. B5 streams a partition
// (4 MiB of f32 on the exchange path) in and out, so it is bound by the
// bytes: 16-byte vector loads and stores over a grid-stride loop. Its flag
// word is written by the last block to finish, after a __threadfence by
// every thread, so a reader that sees the flag also sees the whole payload.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPending = 2;    // include/acx/state.h
constexpr int kCompleted = 4;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ int index_at(const int* idxs, int idx0, int i) {
  return idxs != nullptr ? idxs[i] : idx0;
}

// B1 / B2: flags[idxs[i]] = PENDING for every in-range index.
__global__ void pready_kernel(int* __restrict__ flags, int n,
                              const int* __restrict__ idxs, int idx0, int k) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    const int j = index_at(idxs, idx0, i);
    if (j >= 0 && j < n) flags[j] = kPending;
  }
}

// B3 / B4: out = 1 iff every listed slot is in range and COMPLETED (1 for
// an empty list). One block.
__global__ void parrived_kernel(const int* __restrict__ flags, int n,
                                const int* __restrict__ idxs, int idx0, int k,
                                int* __restrict__ out) {
  int ok = 1;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int j = index_at(idxs, idx0, i);
    ok &= (j >= 0 && j < n && flags[j] == kCompleted);
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) *out = ok;
}

// The producers B5 compiles in. The affine one rounds after the product and
// after the sum, as JAX and PyTorch do for `t * a + b`: nvcc would otherwise
// contract it into one FMA with one rounding.
struct Identity {
  __device__ __forceinline__ float operator()(float t) const { return t; }
};
struct Affine {
  float a, b;
  __device__ __forceinline__ float operator()(float t) const {
    return __fadd_rn(__fmul_rn(t, a), b);
  }
};

// B5: payload = produce(x) over `numel` f32 values, then flags[idx] =
// PENDING by the last block. `done` counts finished blocks and is reset by
// the last one, ready for the next launch on the same stream.
template <typename F>
__global__ void produce_kernel(const float* __restrict__ x,
                               float* __restrict__ payload, long long numel,
                               bool vec4, F produce, int* __restrict__ flags,
                               int n, const int* __restrict__ idxp, int idx0,
                               unsigned* __restrict__ done) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec4) {
    const long long n4 = numel / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* p4 = reinterpret_cast<float4*>(payload);
    for (long long i = t0; i < n4; i += stride) {
      float4 v = x4[i];
      v.x = produce(v.x);
      v.y = produce(v.y);
      v.z = produce(v.z);
      v.w = produce(v.w);
      p4[i] = v;
    }
    tail = n4 * 4;
  }
  for (long long i = tail + t0; i < numel; i += stride)
    payload[i] = produce(x[i]);

  __threadfence();    // this thread's payload stores, visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(done, 1u);
    if (prev == gridDim.x - 1) {   // every other block has fenced its stores
      __threadfence();
      const int j = idxp != nullptr ? *idxp : idx0;
      if (j >= 0 && j < n) flags[j] = kPending;
      *done = 0u;
    }
  }
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// idxs == nullptr: the single index idx0 (k = 1), or no index (k = 0).
extern "C" int acx_flags_pready(void* flags, int n, const void* idxs, int idx0,
                                int k, void* stream) {
  cudaGetLastError();  // launch status below is this launch's alone
  if (n < 0 || k < 0 || (idxs == nullptr && k > 1))
    return cudaErrorInvalidValue;
  if (k == 0) return 0;
  const int blocks = (k + kThreads - 1) / kThreads;
  pready_kernel<<<blocks < kMaxBlocks ? blocks : kMaxBlocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(flags), n, static_cast<const int*>(idxs), idx0, k);
  return launch_status();
}

extern "C" int acx_flags_parrived(const void* flags, int n, const void* idxs,
                                  int idx0, int k, void* out, void* stream) {
  cudaGetLastError();
  if (n < 0 || k < 0 || (idxs == nullptr && k > 1))
    return cudaErrorInvalidValue;
  parrived_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), n, static_cast<const int*>(idxs), idx0,
      k, static_cast<int*>(out));
  return launch_status();
}

// producer: 0 identity, 1 affine (t * a + b). idxp == nullptr: index idx0.
extern "C" int acx_flags_produce_and_pready(const void* x, void* payload,
                                            long long numel, int producer,
                                            float a, float b, void* flags,
                                            int n, const void* idxp, int idx0,
                                            void* done, void* stream) {
  cudaGetLastError();
  if (numel <= 0 || n < 0 || done == nullptr) return cudaErrorInvalidValue;
  const bool vec4 = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(payload) % 16 == 0);
  const long long units = vec4 ? (numel + 3) / 4 : numel;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* po = static_cast<float*>(payload);
  int* fl = static_cast<int*>(flags);
  const int* ip = static_cast<const int*>(idxp);
  unsigned* dn = static_cast<unsigned*>(done);
  if (producer == 0)
    produce_kernel<<<(int)blocks, kThreads, 0, st>>>(xi, po, numel, vec4,
                                                     Identity{}, fl, n, ip,
                                                     idx0, dn);
  else if (producer == 1)
    produce_kernel<<<(int)blocks, kThreads, 0, st>>>(xi, po, numel, vec4,
                                                     Affine{a, b}, fl, n, ip,
                                                     idx0, dn);
  else
    return cudaErrorInvalidValue;
  return launch_status();
}
