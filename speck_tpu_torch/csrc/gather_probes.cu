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
// - sublane_gather (the third design): each block stages the table's
//   columns for a slice of 8 lanes in shared memory (S x 8 x 4 B = 64 KB
//   at S = 2048, by 16-byte loads: the table is read whole from L2 once
//   a block), so three 512-thread blocks share an SM (75% occupancy);
//   16 slices x 24 row blocks = 384 blocks, all resident at once. A
//   thread then takes four neighbouring lanes of one row at a time: one
//   16-byte index load, four shared-memory reads, one 16-byte store; two
//   threads cover a row's slice, so a warp's loads and stores are full
//   32-byte sectors. A read past the table (idx outside [0, S)) gives 0
//   instead of faulting.
//   The first design staged 16-lane slices (128 KB: one 512-thread block
//   an SM, 25% occupancy) with 4-byte index loads and stores: 0.0292 ms
//   of device time at N = 2^22, S = 2048, against a bound of 0.0103. The
//   second read the table from L2 without staging, four 4-byte reads a
//   thread: each read takes a 32-byte L2 sector of its own, 134 MB of L2
//   traffic for 4.19M outputs, and it took 0.0337 ms (NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md).
// - run_copy: one warp per run, 16-byte vector loads and stores. A run's
//   start is any element, so each lane loads the aligned float4 at its
//   place and the next lane's, by a shuffle, supplies the rest; lane 31
//   reads the tail of the run itself. Output runs start at multiples of
//   L = 128k, so stores are aligned float4s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;        // lanes of a table row
constexpr int kSliceLanes = 8;     // lanes staged by one block
constexpr int kGatherThreads = 512;
constexpr int kRowBlocks = 24;     // blocks per lane slice (3 an SM)
constexpr int kCopyThreads = 256;  // 8 warps, one run each
constexpr unsigned kFull = 0xffffffffu;

// One staged value of slice lane k, 0 past the table.
__device__ __forceinline__ float tab_at(const float* s_tab, int s, int k,
                                        int S) {
  return (unsigned)s < (unsigned)S ? s_tab[s * kSliceLanes + k] : 0.f;
}

__global__ void __launch_bounds__(kGatherThreads)
sublane_gather_kernel(const int4* __restrict__ idx,
                      const float4* __restrict__ tab,
                      float4* __restrict__ out, long long rows, int S) {
  extern __shared__ float4 s_tab4[];  // [S][kSliceLanes / 4]
  const int lane0 = blockIdx.x * kSliceLanes;
  // the slice's columns, 16 bytes a load: row s, quad h of the slice
  for (int x = threadIdx.x; x < S * 2; x += blockDim.x) {
    s_tab4[x] = __ldg(tab + (long long)(x >> 1) * (kLanes / 4) +
                      lane0 / 4 + (x & 1));
  }
  __syncthreads();
  const float* s_tab = reinterpret_cast<const float*>(s_tab4);

  // quad j of the slice: row j / 2, lanes lane0 + 4 (j % 2) .. + 3
  const long long quads = rows * 2;
  for (long long j = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       j < quads; j += (long long)gridDim.y * blockDim.x) {
    const int h = (int)(j & 1) * 4;
    const long long q = (j >> 1) * (kLanes / 4) + (lane0 + h) / 4;
    const int4 s = __ldg(idx + q);
    out[q] = make_float4(tab_at(s_tab, s.x, h, S),
                         tab_at(s_tab, s.y, h + 1, S),
                         tab_at(s_tab, s.z, h + 2, S),
                         tab_at(s_tab, s.w, h + 3, S));
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
  // as many row blocks as the rows fill, at most kRowBlocks
  const long long per = (rows * 2 + kGatherThreads - 1) / kGatherThreads;
  const dim3 grid(kLanes / kSliceLanes,
                  (unsigned)(per < kRowBlocks ? per : kRowBlocks));
  sublane_gather_kernel<<<grid, kGatherThreads, smem,
                          (cudaStream_t)stream>>>(
      (const int4*)idx, (const float4*)tab, (float4*)out, rows, S);
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
