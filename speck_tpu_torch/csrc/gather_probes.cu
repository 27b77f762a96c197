// Gather probe kernels for NVIDIA Hopper (sm_90a): the measurements that
// the design of a fused chunk kernel (expand, sort, contract in one CTA)
// needs, on this card.
//
// sublane_gather replaces: scripts/gather_microbench2.py:143, run (Pallas
// body kernel, :139), the sublane dynamic gather
//   out[i, l] = tab[idx[i, l], l],  idx (rows, 128) int32,
//   tab (S, 128) float32 held on chip (S = 2048: 1 MB).
// run_copy replaces: scripts/gather_microbench2.py:195, runf (Pallas body
// kernel2, :184), and scripts/expand_microbench.py:121, run_pallas (body
// kernel, :111), one function:
//   out[(g*K + k)*L + j] = src[offs[g, k] + j],  0 <= j < L.
//
// What bounds them on an H100: device memory. Each output costs 8 bytes
// (4 of index or source read, 4 written) and no arithmetic to speak of: at
// 4.19M outputs that is 33.6 MB, about 10 us at 3.35 TB/s. The gather's
// table (1 MB) sits in L2 after its first read.
//
// What the designs do about it:
// - sublane_gather: the 1 MB table exceeds a block's 227 KB of shared
//   memory, so a block stages the table's columns for a slice of 16 lanes
//   (S x 16 x 4 B = 128 KB at S = 2048) and walks many index rows of that
//   slice with a grid stride; the random reads hit shared memory, and
//   index and output move through device memory once. A read past the
//   table (idx outside [0, S)) gives 0 instead of faulting.
// - run_copy: one warp per run, 16-byte vector loads and stores. A run's
//   start is any element, so each lane loads the aligned float4 at its
//   place and the next lane's, by a shuffle, supplies the rest; lane 31
//   reads the tail of the run itself. Output runs start at multiples of
//   L = 128k, so stores are aligned float4s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;        // lanes of a table row
constexpr int kSliceLanes = 16;    // lanes staged by one block
constexpr int kGatherThreads = 512;
constexpr int kRowBlocks = 16;     // blocks per lane slice
constexpr int kCopyThreads = 256;  // 8 warps, one run each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kGatherThreads)
sublane_gather_kernel(const int* __restrict__ idx,
                      const float* __restrict__ tab,
                      float* __restrict__ out, long long rows, int S) {
  extern __shared__ float s_tab[];  // [S][kSliceLanes]
  const int lane0 = blockIdx.x * kSliceLanes;
  for (int x = threadIdx.x; x < S * kSliceLanes; x += blockDim.x) {
    const int s = x / kSliceLanes, l = x % kSliceLanes;
    s_tab[x] = tab[(long long)s * kLanes + lane0 + l];
  }
  __syncthreads();

  const int l = threadIdx.x % kSliceLanes;
  const int r0 = threadIdx.x / kSliceLanes;
  const int rows_per_step = blockDim.x / kSliceLanes;
  for (long long i = (long long)blockIdx.y * rows_per_step + r0; i < rows;
       i += (long long)gridDim.y * rows_per_step) {
    const long long g = i * kLanes + lane0 + l;
    const unsigned s = (unsigned)idx[g];
    out[g] = s < (unsigned)S ? s_tab[s * kSliceLanes + l] : 0.f;
  }
}

__global__ void __launch_bounds__(kCopyThreads)
run_copy_kernel(const int* __restrict__ offs, const float* __restrict__ src,
                float* __restrict__ out, long long n_runs, int L) {
  const long long run =
      (long long)blockIdx.x * (kCopyThreads / 32) + threadIdx.x / 32;
  if (run >= n_runs) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long off = offs[run];
  const long long a = off & ~3LL;  // aligned float4 at or before the start
  const int r = (int)(off - a);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* out4 = reinterpret_cast<float4*>(out + run * L);
  for (int c = 0; c < L; c += 128) {
    const float4 v = src4[(a + c) / 4 + lane];
    // the float4 after this lane's: the next lane's, and for lane 31 the
    // first r elements past the aligned window
    float4 w;
    w.x = __shfl_down_sync(kFull, v.x, 1);
    w.y = __shfl_down_sync(kFull, v.y, 1);
    w.z = __shfl_down_sync(kFull, v.z, 1);
    w.w = __shfl_down_sync(kFull, v.w, 1);
    if (lane == 31) {
      const long long t = a + c + 128;
      w.x = r > 0 ? src[t] : 0.f;
      w.y = r > 1 ? src[t + 1] : 0.f;
      w.z = r > 2 ? src[t + 2] : 0.f;
    }
    const float e[8] = {v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w};
    float4 o;
    o.x = e[r];
    o.y = e[r + 1];
    o.z = e[r + 2];
    o.w = e[r + 3];
    out4[c / 4 + lane] = o;
  }
}

}  // namespace

extern "C" int speck_sublane_gather(const void* idx, const void* tab,
                                    void* out, long long rows, int S,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * kSliceLanes * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sublane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(kLanes / kSliceLanes, kRowBlocks);
  sublane_gather_kernel<<<grid, kGatherThreads, smem,
                          (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)tab, (float*)out, rows, S);
  return (int)cudaGetLastError();
}

extern "C" int speck_run_copy(const void* offs, const void* src, void* out,
                              long long n_runs, int L, void* stream) {
  if (n_runs <= 0) return 0;
  if (L < 128 || L % 128 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_runs + kCopyThreads / 32 - 1) /
                           (kCopyThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  run_copy_kernel<<<(unsigned)blocks, kCopyThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int*)offs, (const float*)src, (float*)out, n_runs, L);
  return (int)cudaGetLastError();
}
