// Row sort kernel (K2) for NVIDIA Hopper (sm_90a): each row of an int32 key
// sorted ascending and stably, with 0 to 3 32-bit payloads permuted alike.
// The result equals a stable sort's: equal keys keep their slot order.
//
// Replaces: speck_tpu/ops/bitonic.py:172, bitonic_sort_pairs_pallas (a
// bitonic network over (8, W <= 65536) blocks in VMEM), and for rows of
// 2^20 and wider blocked_sort_pairs: every row sort of the stream (the
// packed-key chunk sort, the compaction rank sort, the column sorts of the
// merge levels and the wide finish) and of esc_fixed (the owner-fill key
// and rank sorts, the column sort, the compaction rank sort).
//
// What bounds it on an H100: device memory. The function reads the key and
// each payload once and writes each once, 8 * (1 + payloads) bytes a slot:
// (65536, 4096) with 2 payloads moves 6.4 GB, 1.92 ms at 3.35 TB/s. A
// compare-exchange network instead moves the key and every payload through
// log2(W) * (log2(W) + 1) / 2 stages of shared memory (78 at W = 4096).
//
// What the design does about it:
// - Only (key, slot) pairs are sorted. Each payload is then read once,
//   coalesced, into shared memory and written once, coalesced, through
//   the slot index.
// - A row of one tile (W <= 8192 slots) is one CTA: a stable LSD radix
//   sort of 8-bit digits in shared memory. A pass ranks each warp's keys in
//   slot order (peers by one ballot per digit bit, warp-private digit
//   counts), scans the (digit, warp) counts in one block-wide exclusive
//   scan, and scatters (key, 16-bit slot) stably.
// - Per-row key-range compression: 32-bit block reductions find the row's
//   minimum lo, maximum hi and hi2, the largest key below hi. Keys map to
//   key - lo as uint32, and hi to hi2 - lo + 1, which keeps the order, so
//   padding keys (INT32_MAX) no longer force 31-bit passes: a row takes
//   ceil(bits / 8) passes for the bit length of its largest mapped key,
//   none if its keys are all equal. esc_fixed's banded column sort takes
//   1, its owner and rank keys 2.
// - A wider row: each 8192-slot tile is sorted as above into a scratch pair
//   of planes (key, 32-bit slot), then log2(W / 8192) merge passes run over
//   all rows at once, one CTA per merge-path partition of 2048 outputs
//   (co-rank search on its diagonals, ties to the left run, so stable). The
//   last pass writes the key and gathers each payload once by slot, a
//   random read within the row: at 2^20 slots a payload row is 4 MB and
//   stays in the 50 MB L2; the giant-row finish (2^24, 64 MB) reads past it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTile = 8192;       // slots one CTA sorts in shared memory
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kTileItems = 16;       // slots a thread holds from T = 512 up
constexpr int kMaxWarps = kMaxTile / (32 * kTileItems);
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kMergeThreads * kMergeItems;
constexpr unsigned kFull = 0xffffffffu;

struct Payloads {
  const int* in[3];
  int* out[3];
  int n;
};

__host__ __device__ constexpr int tile_pad(int T) { return T < 32 ? 32 : T; }

// Dynamic shared memory of a tile of T slots sorted by `warps` warps: the
// mapped keys (4 bytes a slot), the slots (2), the per-warp digit counts,
// and the reduction and scan scratch.
__host__ __device__ constexpr size_t tile_smem(int T, int warps) {
  return (size_t)tile_pad(T) * 6 + (size_t)warps * kDigits * 4 +
         kMaxWarps * 4 * sizeof(int);
}

// The minimum (MIN) or maximum of v over the block, in every thread; red
// holds one value per warp.
template <bool MIN>
__device__ __forceinline__ int block_reduce(int v, int* red, int lane,
                                            int warp, int warps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int x = __shfl_xor_sync(kFull, v, o);
    v = MIN ? min(v, x) : max(v, x);
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  for (int w = 0; w < warps; ++w) v = MIN ? min(v, red[w]) : max(v, red[w]);
  return v;
}

// The lanes of `act` whose digit equals this lane's: one ballot per digit
// bit (__match_any_sync computes the same mask, more slowly).
__device__ __forceinline__ unsigned digit_peers(unsigned d, unsigned act) {
  unsigned peers = act;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const unsigned bit = (d >> b) & 1u;
    // the vote where this lane's bit is set, its complement where not
    peers &= __ballot_sync(act, bit) ^ (bit - 1u);
  }
  return peers;
}

// Exclusive sum of v over the block's threads in thread order (wsum holds
// one total per warp; the caller syncs before wsum is written again).
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v,
                                                        unsigned* wsum,
                                                        int lane, int warp) {
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  return before + x - v;
}

// One CTA sorts one tile of T slots (T a power of two, T <= kMaxTile) of a
// row of W. Thread (warp, lane) holds item r at slot
// warp * 32 * ITEMS + r * 32 + lane: a warp's items are in slot order round
// by round, and the warps are in slot order. Without MULTI the tile is the
// row: the keys and the payloads go to their outputs. With MULTI the sorted
// keys and their slots in the row go to the scratch planes key_out and
// slot_out for the merge passes.
template <int ITEMS, bool MULTI>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
radix_tile_kernel(const int* __restrict__ key_in, int* __restrict__ key_out,
                  int* __restrict__ slot_out, Payloads pay, long long W,
                  int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = tile_pad(T);
  const int warps = blockDim.x >> 5;
  unsigned* skey = reinterpret_cast<unsigned*>(smem);
  unsigned short* sslot = reinterpret_cast<unsigned short*>(skey + Tp);
  unsigned* hist = reinterpret_cast<unsigned*>(sslot + Tp);
  int* red = reinterpret_cast<int*>(hist + warps * kDigits);
  unsigned* wsum = reinterpret_cast<unsigned*>(red + 3 * kMaxWarps);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int first = warp * 32 * ITEMS + lane;
  // T < 32: one warp whose lanes >= T hold nothing
  const unsigned act = T < 32 ? (1u << T) - 1u : kFull;
  const bool live = T >= 32 || lane < T;
  const long long tiles = W / T;
  const long long row = blockIdx.x / tiles;
  const long long tile0 = (blockIdx.x - row * tiles) * (long long)T;
  const long long off = row * W + tile0;

  // 1. load the keys; reduce lo and hi, then hi2 = the largest key below
  // hi (rows with two keys or more; INT_MIN, below every other key, is
  // neutral there)
  unsigned u[ITEMS];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    u[r] = 0;
    if (live) {
      const int k = key_in[off + first + r * 32];
      u[r] = (unsigned)k;
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
  lo = block_reduce<true>(lo, red, lane, warp, warps);
  hi = block_reduce<false>(hi, red + kMaxWarps, lane, warp, warps);
  int hi2 = INT_MIN;
  if (lo != hi) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      if (live && (int)u[r] != hi) hi2 = max(hi2, (int)u[r]);
    hi2 = block_reduce<false>(hi2, red + 2 * kMaxWarps, lane, warp, warps);
  }

  // 2. the order-keeping map to uint32 and the number of digit passes
  const int khi = hi;
  const unsigned ulo = (unsigned)lo;
  const unsigned uhi = lo == hi ? 0u : (unsigned)hi2 - ulo + 1u;
  const int passes =
      uhi == 0u ? 0 : (32 - __clz(uhi) + kDigitBits - 1) / kDigitBits;
  unsigned sl[ITEMS];  // slot in the tile | rank in the warp << 16
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    u[r] = (int)u[r] == khi ? uhi : u[r] - ulo;
    sl[r] = (unsigned)(first + r * 32);
  }

  // 3. LSD passes: rank in the warp, scan the counts, scatter stably
  unsigned* whist = hist + warp * kDigits;
  const int per = blockDim.x >= kDigits ? 1 : kDigits / (int)blockDim.x;
  const int d0 = threadIdx.x * per;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    for (int d = lane; d < kDigits; d += 32) whist[d] = 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (live) {
        const unsigned d = (u[r] >> shift) & (kDigits - 1);
        const unsigned peers = digit_peers(d, act);
        const unsigned seen = whist[d];
        __syncwarp(act);
        if ((peers & lt) == 0u) whist[d] = seen + __popc(peers);
        __syncwarp(act);
        sl[r] |= (seen + __popc(peers & lt)) << 16;
      }
    }
    __syncthreads();

    // (digit, warp) counts to exclusive offsets, digit-major
    unsigned total = 0;
    if (d0 < kDigits)
      for (int d = d0; d < d0 + per; ++d)
        for (int w = 0; w < warps; ++w) total += hist[w * kDigits + d];
    unsigned run = block_exclusive_sum(total, wsum, lane, warp);
    if (d0 < kDigits)
      for (int d = d0; d < d0 + per; ++d)
        for (int w = 0; w < warps; ++w) {
          const unsigned c = hist[w * kDigits + d];
          hist[w * kDigits + d] = run;
          run += c;
        }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (live) {
        const unsigned d = (u[r] >> shift) & (kDigits - 1);
        const unsigned dst = whist[d] + (sl[r] >> 16);
        skey[dst] = u[r];
        sslot[dst] = (unsigned short)(sl[r] & 0xffffu);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (live) {
        u[r] = skey[first + r * 32];
        sl[r] = sslot[first + r * 32];
      }
    }
  }

  // 4. write the keys (mapped back) and move each payload once
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (live) {
      const long long p = off + first + r * 32;
      key_out[p] = u[r] == uhi ? khi : (int)(u[r] + ulo);
      if (MULTI) slot_out[p] = (int)(tile0 + (sl[r] & 0xffffu));
    }
  }
  if (MULTI) return;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (q >= pay.n) break;
    __syncthreads();  // every read of skey before this is done
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      if (live) skey[first + r * 32] = pay.in[q][off + first + r * 32];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      if (live) pay.out[q][off + first + r * 32] = skey[sl[r] & 0xffffu];
  }
}

// The number of slots of a (sorted a, sorted b) merge's first `diag`
// outputs that come from a, taking a's element first on equal keys.
__device__ __forceinline__ int co_rank(const int* a, const int* b, int na,
                                       int nb, int diag) {
  int lo = diag > nb ? diag - nb : 0;
  int hi = diag < na ? diag : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// co_rank by one warp in device memory: each step the 32 lanes probe 32
// evenly spaced points of the remaining range at once, which cuts it 32-fold
// (4 dependent loads for a run of 2^19, not 19).
__device__ __forceinline__ long long co_rank_warp(const int* a, const int* b,
                                                  long long na, long long nb,
                                                  long long diag, int lane) {
  long long lo = diag > nb ? diag - nb : 0;
  long long hi = diag < na ? diag : na;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + lane * step;
    // a[p] comes before b's element on that diagonal; true on a prefix of
    // the lanes
    const bool before = p < hi && a[p] <= b[diag - 1 - p];
    const int c = __popc(__ballot_sync(kFull, before));
    const long long next_hi = lo + c * step;
    if (c > 0) lo += (c - 1) * step + 1;
    if (next_hi < hi) hi = next_hi;
  }
  return lo;
}

// shared-memory index with one pad word per 32, so that threads writing
// kMergeItems consecutive outputs each hit distinct banks
__device__ __forceinline__ int padded(int x) { return x + (x >> 5); }

// One merge pass over all rows: adjacent sorted runs of w (key, slot) pairs
// become runs of 2w. A CTA writes kMergeTile outputs of one merged run: two
// co-rank searches in device memory bound its inputs, which it stages in
// shared memory; each thread then merges kMergeItems outputs from its own
// diagonal. FINAL writes the key and gathers each payload by slot instead
// of writing the slots.
template <bool FINAL>
__global__ void __launch_bounds__(kMergeThreads)
merge_pass_kernel(const int* __restrict__ kin, const int* __restrict__ sin,
                  int* __restrict__ kout, int* __restrict__ sout,
                  Payloads pay, long long W, long long w) {
  constexpr int kPadded = kMergeTile + kMergeTile / 32;
  __shared__ int sk[kPadded];
  __shared__ int ss[kPadded];
  __shared__ long long split[2];
  const long long first = (long long)blockIdx.x * kMergeTile;
  const long long row = first / W;
  const long long pos = first - row * W;
  const long long run0 = row * W + (pos & ~(2 * w - 1));
  const long long diag0 = pos & (2 * w - 1);
  if (threadIdx.x < 64) {  // warp 0 the first diagonal, warp 1 the last
    const int warp = threadIdx.x >> 5;
    const long long s = co_rank_warp(kin + run0, kin + run0 + w, w, w,
                                     diag0 + warp * kMergeTile,
                                     threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  const long long i0 = split[0];
  const long long j0 = diag0 - i0;
  const int na = (int)(split[1] - i0);
  const int nb = kMergeTile - na;
  for (int x = threadIdx.x; x < kMergeTile; x += kMergeThreads) {
    const long long src = x < na ? run0 + i0 + x : run0 + w + j0 + (x - na);
    sk[x] = kin[src];
    ss[x] = sin[src];
  }
  __syncthreads();

  const int d = threadIdx.x * kMergeItems;
  int ia = co_rank(sk, sk + na, na, nb, d);
  int ib = d - ia;
  int ok[kMergeItems], os[kMergeItems];
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    const bool take_a = ia < na && (ib >= nb || sk[ia] <= sk[na + ib]);
    const int x = take_a ? ia++ : na + ib++;
    ok[k] = sk[x];
    os[k] = ss[x];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    sk[padded(d + k)] = ok[k];
    ss[padded(d + k)] = os[k];
  }
  __syncthreads();

  for (int x = threadIdx.x; x < kMergeTile; x += kMergeThreads) {
    const long long o = first + x;
    const int slot = ss[padded(x)];
    kout[o] = sk[padded(x)];
    if (FINAL) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (q < pay.n) pay.out[q][o] = pay.in[q][row * W + slot];
    } else {
      sout[o] = slot;
    }
  }
}

template <int ITEMS, bool MULTI>
int launch_tiles(const int* kin, int* kout, int* sout, const Payloads& pay,
                 long long R, long long W, int T, cudaStream_t stream) {
  const int warps = T >= 32 * ITEMS ? T / (32 * ITEMS) : 1;
  const size_t smem = tile_smem(T, warps);
  const long long blocks = R * (W / T);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // opt in past 48 KB once per device, for the largest tile: the call
    // costs host time on every launch otherwise
    static unsigned opted = 0;  // bit d: done on device d
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 32 || !(opted >> dev & 1u)) {
      e = cudaFuncSetAttribute(radix_tile_kernel<ITEMS, MULTI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tile_smem(kMaxTile, kMaxWarps));
      if (e != cudaSuccess) return (int)e;
      if (dev < 32) opted |= 1u << dev;
    }
  }
  radix_tile_kernel<ITEMS, MULTI><<<(unsigned)blocks, warps * 32, smem,
                                    stream>>>(kin, kout, sout, pay, W, T);
  return (int)cudaGetLastError();
}

// Rows of one tile: 16 items a thread from T = 512 up, one warp below.
int sort_single_tiles(const int* kin, int* kout, const Payloads& pay,
                      long long R, long long W, cudaStream_t s) {
  const int T = (int)W;
  if (T >= 512)
    return launch_tiles<16, false>(kin, kout, nullptr, pay, R, W, T, s);
  if (T >= 256)
    return launch_tiles<8, false>(kin, kout, nullptr, pay, R, W, T, s);
  if (T >= 128)
    return launch_tiles<4, false>(kin, kout, nullptr, pay, R, W, T, s);
  if (T >= 64)
    return launch_tiles<2, false>(kin, kout, nullptr, pay, R, W, T, s);
  return launch_tiles<1, false>(kin, kout, nullptr, pay, R, W, T, s);
}

// Rows of several tiles: tiles into scratch set 0, then the merge passes,
// alternating between scratch sets 0 and 1 (each a key and a slot plane of
// R * W), the last one into the outputs.
int sort_multi_tiles(const int* kin, int* kout, const Payloads& pay,
                     long long R, long long W, int T, int* scratch,
                     cudaStream_t s) {
  const long long RW = R * W;
  int e = launch_tiles<kTileItems, true>(kin, scratch, scratch + RW,
                                         Payloads{}, R, W, T, s);
  if (e != 0) return e;
  const long long blocks = RW / kMergeTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int set = 0;
  for (long long w = T; w < W; w <<= 1, set ^= 1) {
    const int* ksrc = scratch + 2 * RW * set;
    int* kdst = scratch + 2 * RW * (set ^ 1);
    if (2 * w == W)
      merge_pass_kernel<true><<<(unsigned)blocks, kMergeThreads, 0, s>>>(
          ksrc, ksrc + RW, kout, nullptr, pay, W, w);
    else
      merge_pass_kernel<false><<<(unsigned)blocks, kMergeThreads, 0, s>>>(
          ksrc, ksrc + RW, kdst, kdst + RW, Payloads{}, W, w);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return 0;
}

bool pow2(long long x) { return x >= 1 && (x & (x - 1)) == 0; }

}  // namespace

// Sort each of the R rows of W slots of key_in into key_out, moving
// n_payloads payloads alike. `tile` is the slots one CTA sorts (W itself
// for a row of one tile); below W, the merge passes need `scratch`, one
// (key, slot) plane pair of R * W int32 for a single merge pass and two
// pairs for more.
extern "C" int speck_row_sort(const void* key_in, void* key_out,
                              const void* p0_in, const void* p1_in,
                              const void* p2_in, void* p0_out, void* p1_out,
                              void* p2_out, int n_payloads, long long R,
                              long long W, long long tile, void* scratch,
                              void* stream) {
  if (R <= 0) return 0;
  if (!pow2(W) || !pow2(tile) || tile > W || tile > kMaxTile ||
      n_payloads < 0 || n_payloads > 3)
    return (int)cudaErrorInvalidValue;
  Payloads pay{{(const int*)p0_in, (const int*)p1_in, (const int*)p2_in},
               {(int*)p0_out, (int*)p1_out, (int*)p2_out},
               n_payloads};
  const int* kin = (const int*)key_in;
  int* kout = (int*)key_out;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == W) return sort_single_tiles(kin, kout, pay, R, W, s);
  if (tile < kMergeTile / 2 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  return sort_multi_tiles(kin, kout, pay, R, W, (int)tile, (int*)scratch, s);
}
