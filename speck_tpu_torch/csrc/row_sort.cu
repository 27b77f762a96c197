// Row sort kernel (K2) for NVIDIA Hopper (sm_90a): a bitonic network over
// each row of an int32 key, ascending, with 0 to 3 32-bit payloads moved
// alongside.
//
// Replaces: speck_tpu/ops/bitonic.py, bitonic_sort_pairs_pallas (network
// body _network), and for rows of 2^20 and wider blocked_sort_pairs: every
// row sort of the stream (the packed-key chunk sort, the compaction rank
// sort, the column sorts of the merge levels and the wide finish).
//
// What bounds it on an H100: for rows that fit one tile (W <= T, T = 8192
// slots with 3 payloads, 16384 with 1), shared-memory bandwidth: the
// network has log2(W)(log2(W)+1)/2 compare-exchange stages (91 at
// W = 8192), each reading and writing the key and every payload in shared
// memory, while device memory is read and written once. Wider rows add one
// device-memory pass (key and payloads, read and write) for every stage
// whose compare distance is at least T, and are bound by device memory.
//
// What the design does about it: one CTA sorts one tile of T slots whose
// key and payloads sit in dynamic shared memory (up to 128 KiB, opted in
// with cudaFuncSetAttribute past 48 KB), so every stage with distance < T
// stays on chip. For W > T, each merge phase k = 2T .. W runs its stages
// of distance >= T as grid-wide passes over device memory, then finishes
// the phase (distances T/2 .. 1) in shared memory again. The network is
// not stable; the stream's keys order every slot its result depends on.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSmemBudget = 128 * 1024;
constexpr int kMaxThreads = 1024;
constexpr int kGlobalThreads = 256;

template <int NP>
constexpr int tile_cap() {
  int t = 1;
  while (t * 2 * 4 * (1 + NP) <= kSmemBudget) t *= 2;
  return t;
}

template <int NP>
__device__ __forceinline__ void exchange(int* k, int* p0, int* p1, int* p2,
                                         long long i, long long j,
                                         bool asc) {
  const int a = k[i], b = k[j];
  if (asc ? (a > b) : (a < b)) {
    k[i] = b;
    k[j] = a;
    if constexpr (NP > 0) { const int t = p0[i]; p0[i] = p0[j]; p0[j] = t; }
    if constexpr (NP > 1) { const int t = p1[i]; p1[i] = p1[j]; p1[j] = t; }
    if constexpr (NP > 2) { const int t = p2[i]; p2[i] = p2[j]; p2[j] = t; }
  }
}

// Phases k = k_lo .. k_hi of the network on one tile of T slots, for every
// compare distance below T. Reads the tile from *in, writes it to *out
// (the two may be the same buffer: a tile is loaded whole before any
// store).
template <int NP>
__global__ void __launch_bounds__(kMaxThreads)
bitonic_tile_kernel(const int* kin, int* kout, const int* pin0,
                    const int* pin1, const int* pin2, int* pout0, int* pout1,
                    int* pout2, long long W, int T, long long k_lo,
                    long long k_hi) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* s0 = smem + T;
  int* s1 = smem + 2 * T;
  int* s2 = smem + 3 * T;
  const long long tiles = W / T;
  const long long row = blockIdx.x / tiles;
  const long long tile0 = (blockIdx.x % tiles) * (long long)T;
  const long long off = row * W + tile0;

  for (int x = threadIdx.x; x < T; x += blockDim.x) {
    sk[x] = kin[off + x];
    if constexpr (NP > 0) s0[x] = pin0[off + x];
    if constexpr (NP > 1) s1[x] = pin1[off + x];
    if constexpr (NP > 2) s2[x] = pin2[off + x];
  }
  __syncthreads();

  const int half = T >> 1;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (int)((k >> 1) < half ? (k >> 1) : half); j >= 1; j >>= 1) {
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        exchange<NP>(sk, s0, s1, s2, i, i + j, ((tile0 + i) & k) == 0);
      }
      __syncthreads();
    }
  }

  for (int x = threadIdx.x; x < T; x += blockDim.x) {
    kout[off + x] = sk[x];
    if constexpr (NP > 0) pout0[off + x] = s0[x];
    if constexpr (NP > 1) pout1[off + x] = s1[x];
    if constexpr (NP > 2) pout2[off + x] = s2[x];
  }
}

// One stage (phase k, distance j >= T) over device memory, in place.
template <int NP>
__global__ void __launch_bounds__(kGlobalThreads)
bitonic_global_kernel(int* key, int* p0, int* p1, int* p2, long long R,
                      long long W, long long k, long long j) {
  const long long half = W >> 1;
  const long long pairs = R * half;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < pairs; q += (long long)gridDim.x * blockDim.x) {
    const long long row = q / half;
    const long long qq = q - row * half;
    const long long i = ((qq & ~(j - 1)) << 1) | (qq & (j - 1));
    exchange<NP>(key + row * W, p0 ? p0 + row * W : nullptr,
                 p1 ? p1 + row * W : nullptr, p2 ? p2 + row * W : nullptr,
                 i, i + j, (i & k) == 0);
  }
}

template <int NP>
int sort_rows(const int* kin, int* kout, const int* const* pin,
              int* const* pout, long long R, long long W,
              cudaStream_t stream) {
  const int T = (int)(W < tile_cap<NP>() ? W : tile_cap<NP>());
  const size_t smem = (size_t)T * 4 * (1 + NP);
  const int threads = (T / 2 > kMaxThreads) ? kMaxThreads
                      : (T / 2 < 32 ? 32 : T / 2);
  const long long blocks = R * (W / T);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bitonic_tile_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bitonic_tile_kernel<NP><<<(unsigned)blocks, threads, smem, stream>>>(
      kin, kout, pin[0], pin[1], pin[2], pout[0], pout[1], pout[2], W, T, 2,
      T);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long pairs = R * (W >> 1);
  long long gblocks = (pairs + kGlobalThreads - 1) / kGlobalThreads;
  if (gblocks > 132LL * 32) gblocks = 132LL * 32;
  for (long long k = 2LL * T; k <= W; k <<= 1) {
    for (long long j = k >> 1; j >= T; j >>= 1) {
      bitonic_global_kernel<NP><<<(unsigned)gblocks, kGlobalThreads, 0,
                                  stream>>>(kout, pout[0], pout[1], pout[2],
                                            R, W, k, j);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    bitonic_tile_kernel<NP><<<(unsigned)blocks, threads, smem, stream>>>(
        kout, kout, pout[0], pout[1], pout[2], pout[0], pout[1], pout[2], W,
        T, k, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int speck_row_sort(const void* key_in, void* key_out,
                              const void* p0_in, const void* p1_in,
                              const void* p2_in, void* p0_out, void* p1_out,
                              void* p2_out, int n_payloads, long long R,
                              long long W, void* stream) {
  if (R <= 0) return 0;
  if (W < 1 || (W & (W - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int* pin[3] = {(const int*)p0_in, (const int*)p1_in,
                       (const int*)p2_in};
  int* pout[3] = {(int*)p0_out, (int*)p1_out, (int*)p2_out};
  const int* kin = (const int*)key_in;
  int* kout = (int*)key_out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_payloads) {
    case 0: return sort_rows<0>(kin, kout, pin, pout, R, W, s);
    case 1: return sort_rows<1>(kin, kout, pin, pout, R, W, s);
    case 2: return sort_rows<2>(kin, kout, pin, pout, R, W, s);
    case 3: return sort_rows<3>(kin, kout, pin, pout, R, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
