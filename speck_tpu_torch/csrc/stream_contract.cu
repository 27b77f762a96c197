// Contract kernels for NVIDIA Hopper (sm_90a): K1 (stream contract) and K3
// (column contract), one tiled segmented scan with a compile-time switch.
//
// K1 replaces: speck_tpu/ops/pallas_kernels.py, stream_contract_runs (Pallas
// body _stream_contract_kernel), the contract stage of every stream chunk,
// merge level and wide finish.
// K3 replaces: speck_tpu/ops/pallas_kernels.py:153, contract_runs (Pallas
// body _contract_kernel, :46), the contract of esc._contract and of
// esc_fixed (whose JAX form computes it as _run_boundaries + _run_sums).
//
// What they compute, per row of a sorted (R, W) rectangle:
//   last[i] = (slot i+1 starts a new run, or i is the row end)
//             and col[i] < n_cols
//   sums[i] = inclusive sum of val over the run that slot i belongs to,
//             restarting where the run key changes.
// K1's run key is (rid, col), rows (rid, col)-sorted; rid may be a full
// plane or a per-row constant (column stride 0). K3's run key is col
// alone, with the JAX form's sentinels: slot -1 holds -1 and slot W holds
// -2, so a row's first and last slots compare against those.
//
// What bounds them on an H100: device memory. K1 reads 12 bytes per slot
// (rid, col, val) and K3 8 (col, val); both write 5 (last, sum), for a
// handful of integer and float operations, far below the card's
// operations-per-byte balance. A (512, 8192) K1 chunk moves ~71 MB, about
// 21 us at 3.35 TB/s; esc_fixed's (65536, 2048) K3 rectangle moves
// ~1.75 GB, about 0.52 ms.
//
// What the design does about it: one pass over the data, no intermediate
// planes in device memory (the plain form makes 2*log2(W) full passes).
// One CTA owns one row and walks it in tiles of 2048 slots (512 threads x
// 4 consecutive slots). Each tile is staged through shared memory so the
// global loads and stores are coalesced. The segmented scan runs
// sequentially over a thread's 4 slots, by warp shuffles across a warp,
// through shared memory across the 16 warps, and carries a (value, flag)
// pair from tile to tile, so a row of any width (up to 2^24 in the wide
// finish) is one CTA. K3 is the same kernel with kHasRid = false: it never
// loads a rid, so it moves 8 + 5 bytes per slot. Sums are taken in another
// order than the Hillis-Steele doubling of the Pallas and plain forms:
// equal at tolerance, the mask exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Segmented-sum element: the sum since the last run start inside the span,
// and whether a run starts inside it. seg_op(a, b) covers a then b.
struct Seg {
  float v;
  int f;
};

__device__ __forceinline__ Seg seg_op(const Seg& a, const Seg& b) {
  Seg r;
  r.v = b.f ? b.v : a.v + b.v;
  r.f = a.f | b.f;
  return r;
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int o) {
  Seg r;
  r.v = __shfl_up_sync(kFull, s.v, o);
  r.f = __shfl_up_sync(kFull, s.f, o);
  return r;
}

template <bool kHasRid>
__global__ void __launch_bounds__(kThreads)
contract_kernel(const int* __restrict__ rid, long long rid_rs,
                long long rid_cs, const int* __restrict__ col,
                const float* __restrict__ val, uint8_t* __restrict__ last,
                float* __restrict__ sums, long long W, int n_cols) {
  __shared__ int s_col[kTile + 2];   // slots base-1 .. base+kTile
  __shared__ int s_rid[kHasRid ? kTile + 2 : 1];
  __shared__ float s_val[kTile];     // values in, run sums out
  __shared__ uint8_t s_last[kTile];
  __shared__ Seg s_warp[kWarps];
  __shared__ Seg s_carry;            // everything before the tile

  const long long row = blockIdx.x;
  const int* crow = col + row * W;
  const float* vrow = val + row * W;
  const int* rrow = kHasRid ? rid + row * rid_rs : nullptr;
  uint8_t* lrow = last + row * W;
  float* srow = sums + row * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Seg ident = {0.f, 0};

  if (tid == 0) s_carry = ident;

  for (long long base = 0; base < W; base += kTile) {
    const int n = (int)(W - base < kTile ? W - base : kTile);
    for (int x = tid; x < n + 2; x += kThreads) {
      const long long g = base - 1 + x;
      // outside the row: the column-only form's sentinels (-1 before, -2
      // after); K1 tests the row ends explicitly instead
      int c = g < 0 ? -1 : -2;
      if (g >= 0 && g < W) c = crow[g];
      s_col[x] = c;
      if constexpr (kHasRid) {
        s_rid[x] = (g >= 0 && g < W) ? rrow[g * rid_cs] : 0;
      }
    }
    for (int x = tid; x < n; x += kThreads) s_val[x] = vrow[base + x];
    __syncthreads();

    // this thread's kItems consecutive slots
    Seg items[kItems];
    Seg agg = ident;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int x = tid * kItems + k;
      items[k] = ident;
      if (x < n) {
        const long long g = base + x;
        const int s = x + 1;  // staged index of slot x
        int chg = s_col[s] != s_col[s - 1];
        int nxt = s_col[s + 1] != s_col[s];
        if constexpr (kHasRid) {
          chg = chg || (g == 0) || s_rid[s] != s_rid[s - 1];
          nxt = nxt || (g == W - 1) || s_rid[s + 1] != s_rid[s];
        }
        s_last[x] = (uint8_t)(nxt && s_col[s] < n_cols);
        items[k].v = s_val[x];
        items[k].f = chg;
      }
      agg = (k == 0) ? items[0] : seg_op(agg, items[k]);
    }

    // inclusive scan of the thread aggregates within the warp
    Seg inc = agg;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Seg up = shfl_up(inc, o);
      if (lane >= o) inc = seg_op(up, inc);
    }
    Seg ex = shfl_up(inc, 1);
    if (lane == 0) ex = ident;
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();

    // inclusive scan of the warp totals
    if (warp == 0) {
      Seg w = lane < kWarps ? s_warp[lane] : ident;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const Seg up = shfl_up(w, o);
        if (lane >= o) w = seg_op(up, w);
      }
      if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();

    Seg run = seg_op(s_carry, warp > 0 ? s_warp[warp - 1] : ident);
    run = seg_op(run, ex);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int x = tid * kItems + k;
      if (x < n) {
        run = seg_op(run, items[k]);
        s_val[x] = run.v;
      }
    }
    __syncthreads();

    if (tid == 0) s_carry = seg_op(s_carry, s_warp[kWarps - 1]);
    for (int x = tid; x < n; x += kThreads) {
      srow[base + x] = s_val[x];
      lrow[base + x] = s_last[x];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int speck_stream_contract(const void* rid, long long rid_rs,
                                     long long rid_cs, const void* col,
                                     const void* val, void* last, void* sums,
                                     long long R, long long W, int n_cols,
                                     void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  contract_kernel<true><<<(unsigned)R, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rid, rid_rs, rid_cs, (const int*)col, (const float*)val,
      (uint8_t*)last, (float*)sums, W, n_cols);
  return (int)cudaGetLastError();
}

extern "C" int speck_contract_runs(const void* col, const void* val,
                                   void* last, void* sums, long long R,
                                   long long W, int n_cols, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  contract_kernel<false><<<(unsigned)R, kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, 0, 0, (const int*)col, (const float*)val, (uint8_t*)last,
      (float*)sums, W, n_cols);
  return (int)cudaGetLastError();
}

extern "C" const char* speck_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
