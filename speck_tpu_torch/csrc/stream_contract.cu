// Contract kernels for NVIDIA Hopper (sm_90a): K1 (stream contract) and K3
// (column contract), one flat segmented scan with compile-time switches.
//
// K1 replaces: speck_tpu/ops/pallas_kernels.py:122, stream_contract_runs
// (Pallas body _stream_contract_kernel, :95), the contract stage of every
// stream chunk, merge level and wide finish.
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
// -2, so a row's last slot ends a run unless its column is -2. A row head
// restarts the sums in both (the JAX doubling shifts zeros in there).
//
// What bounds them on an H100: device memory. K1 reads 12 bytes a slot
// with a rid plane (rid, col, val) and 8 with a per-row rid, which it never
// reads: a row head is a run start already, and the rid is constant along
// the row. Both write 5 (last, sum): 17 and 13 bytes a slot, for a handful
// of integer and float operations, far below the card's operations-per-byte
// balance. A (512, 8192) chunk moves 71 MB, 21.3 us at 3.35 TB/s; the
// giant row's (1, 2^23) finish 109 MB, 32.6 us. K3 moves 13 bytes a slot:
// esc_fixed's (65536, 2048) rectangle 1.75 GB, 0.52 ms.
//
// Why the first design lost: one CTA owned one row and walked it serially
// in 2048-slot tiles, five __syncthreads() a tile, 4-byte loads staged
// through shared memory, 1-byte stores. A (512, 8192) chunk filled the card
// (0.0738 ms against 0.0213), but a row wider than a few tiles ran on one
// SM: (4, 65536) with a per-row rid took 0.1170 ms against a 0.0010 bound,
// about 3.7 us a tile, 32 tiles in series; the giant row's (1, 2^23)
// finish, 4096 tiles on one SM, about 15 ms (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md).
//
// What this design does about it:
// - Flat tiles. The rectangle is R*W contiguous slots; a CTA takes one tile
//   of kTile = 4096 slots (256 threads x 16 consecutive slots), so a shape
//   spreads over as many SMs as it has tiles, whatever its rows. Slots with
//   g % W == 0 are forced run starts.
// - 16-byte accesses. A thread loads its 16 slots of col, val (and rid) as
//   int4/float4, stores its sums as four float4 and its 16 last flags as
//   one 16-byte word. The neighbour slots come by warp shuffle; a warp's
//   edge lanes read slots g-1 and g+16 directly. The ragged last tile takes
//   a masked scalar path.
// - One pass: the sums are a segmented scan over (value, run-start) pairs,
//   sequential over a thread's 16 slots, by shuffles across a warp and
//   through shared memory across the 8 warps.
// - Carry across tiles by decoupled look-back (Merrill and Garland, NVIDIA
//   2016). A tile takes its id from a global atomic counter, so every
//   lower tile is already running and the look-back cannot deadlock. A
//   tile that holds a run start publishes its inclusive prefix at once (the
//   sum since its last run start); a tile without one publishes its
//   aggregate, looks back for its carry and then publishes its prefix. A
//   tile whose first slot starts a run needs no carry and does not look.
//   The look-back stops at the nearest published prefix, so with runs
//   shorter than a tile it is one step. Where W divides the tile (K3 on
//   esc_fixed's power-of-two rows) every tile starts at a row head: the
//   wrapper passes no scratch, the tile is blockIdx.x, and nothing is
//   published or read back.
// - Deterministic sums. The look-back finds the nearest prefix P_q, then
//   folds forward in tile order, carry = P_q, then carry = carry + A_j for
//   each later tile j (or carry = P_j where that tile has published its
//   prefix meanwhile, which is the same float, since every P_j is that
//   same left fold). Aggregates are never added to each other first, so a
//   tile's carry is the same float sequence whichever predecessor had
//   published: two launches give bit-identical sums.
// - Scratch: word 0 the tile counter, then one 8-byte status word a tile
//   (low half the float value, high half the flags: aggregate or prefix;
//   a double takes a record of three words, below).
//   The wrapper allocates it (torch.empty) and the launcher clears it on
//   the caller's stream before the kernel, by a kernel of its own
//   (contract_scratch_clear), so that a profile counts the clear with K1 by
//   name: no epoch tag, no state kept between launches, and a CUDA graph
//   that replays the launch replays the clear too. The kernel allocates
//   nothing. The wrapper checks that every input is 16-byte aligned.
// Sums are taken in another order than the Hillis-Steele doubling of the
// Pallas and plain forms: equal at tolerance, the mask exactly.
//
// float64 (the reference's double instantiation; its JAX form contracts f64
// in plain jnp): the same kernel with T = double, 16-byte loads and stores
// of two values. A double and its flags do not fit one 8-byte word, so a
// tile's status is a record of three words: flags, aggregate, prefix. Each
// value slot is written once: the writer stores the value, then
// __threadfence(), then the flags (a release store); a reader loads the
// flags (an acquire load) and then the slot they name. Overwriting one value
// slot from aggregate to prefix would let a reader pair an old flag with a
// new value. The fold stays in tile order, so two launches give the same
// bits as in float32. The scratch is 1 + 3 * tiles words. It moves 25 bytes
// a slot with a rid plane, 21 with a per-row rid, and K3 21.
//
// __half and __nv_bfloat16 (the reference contracts 16-bit values in plain
// jnp): the same kernel loads 16 bits a value (two 16-byte loads for a
// thread's 16 slots), sums in float with float's one-word status, and
// stores each sum once in the value's type (Acc<S>, by the conversion
// intrinsics). 13 bytes a slot with a rid plane, 9 with a per-row rid and
// in K3: (512, 8192) 0.0163 ms at 3.35 TB/s, K3's (65536, 2048) 0.36 ms.
// Sums agree with the plain version's float32 sums rounded once to within
// a rounding on each side; 60-64 registers.
//
// nvcc -Xptxas -v (sm_90a): contract_kernel<true, false> (K1, rid plane)
// 64 registers, <false, false> (K1, per-row rid) 60, <false, true> (K3)
// 72, contract_scratch_clear 24; no spills, no stack, 76 bytes of static
// shared memory. Device time with the clear (about 1 us) on an H100 80GB
// HBM3 at 700 W (probes/contract_profile.py, PERF.md): 0.0308 ms at
// (512, 8192), 1.45x the bound; 0.0648 ms at (1, 2^23), 1.99x; K3 0.581 ms
// at (65536, 2048). CUDA events around one wrapper call read more at the
// small shapes: the wrapper's host time and the two launches lead there.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// flags in a tile's status (0: nothing published yet)
constexpr unsigned kAggregate = 1u;  // value: the tile's own sum (no start)
constexpr unsigned kPrefix = 2u;     // value: the sum since the last start

// Segmented-sum element: the sum since the last run start inside the span,
// and whether a run starts inside it. seg_op(a, b) covers a then b.
template <typename T>
struct Seg {
  T v;
  int f;
};

template <typename T>
__device__ __forceinline__ Seg<T> seg_op(const Seg<T>& a, const Seg<T>& b) {
  Seg<T> r;
  r.v = b.f ? b.v : a.v + b.v;
  r.f = a.f | b.f;
  return r;
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(const Seg<T>& s, int o) {
  Seg<T> r;
  r.v = __shfl_up_sync(kFull, s.v, o);
  r.f = __shfl_up_sync(kFull, s.f, o);
  return r;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long w) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

// A value plane's storage type S and the type its sums are taken in:
// float and double sum in themselves; __half and __nv_bfloat16 load into
// float, sum there and store 16 bits once, converting only by the
// intrinsics (PyTorch's build flags forbid the implicit conversions).
template <typename S>
struct Acc {
  using T = S;
  __device__ static T in(S x) { return x; }
  __device__ static S out(T x) { return x; }
};
template <>
struct Acc<__half> {
  using T = float;
  __device__ static float in(__half x) { return __half2float(x); }
  __device__ static __half out(float x) { return __float2half(x); }
};
template <>
struct Acc<__nv_bfloat16> {
  using T = float;
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

// A tile's published status in the scratch after the tile counter.
template <typename T>
struct TileStatus;

// float: one 8-byte word a tile, the flags in the high half and the value's
// bits in the low half, written and read whole.
template <>
struct TileStatus<float> {
  static constexpr long long kWords = 1;
  __device__ static void publish(unsigned long long* status, long long t,
                                 float v, unsigned flags) {
    st_relaxed(status + t,
               ((unsigned long long)flags << 32) | __float_as_uint(v));
  }
  __device__ static unsigned read(const unsigned long long* status,
                                  long long j, float* v) {
    const unsigned long long w = ld_relaxed(status + j);
    *v = __uint_as_float((unsigned)w);
    return (unsigned)(w >> 32);
  }
};

// double: a record of three words a tile (flags, aggregate, prefix); each
// value slot is written once, before the flags that name it.
template <>
struct TileStatus<double> {
  static constexpr long long kWords = 3;
  __device__ static void publish(unsigned long long* status, long long t,
                                 double v, unsigned flags) {
    unsigned long long* rec = status + kWords * t;
    st_relaxed(rec + (flags == kPrefix ? 2 : 1),
               (unsigned long long)__double_as_longlong(v));
    __threadfence();
    st_release(rec, flags);
  }
  __device__ static unsigned read(const unsigned long long* status,
                                  long long j, double* v) {
    const unsigned long long* rec = status + kWords * j;
    const unsigned flags = (unsigned)ld_acquire(rec);
    *v = flags == 0u ? 0.0
                     : __longlong_as_double((long long)ld_relaxed(
                           rec + ((flags & kPrefix) ? 2 : 1)));
    return flags;
  }
};

// The inclusive prefix through tile t - 1, for tile t >= 1 (tile 0 always
// publishes a prefix: slot 0 starts a run). Called by one whole warp.
template <typename T>
__device__ T look_back(const unsigned long long* status, long long t,
                       int lane) {
  // backward, 32 tiles a step: lane i reads tile end - i; wait until the
  // whole window has published, stop at the window with a prefix
  long long end = t - 1;
  unsigned f;
  T v;
  unsigned pmask;
  while (true) {
    const long long j = end - lane;
    do {
      if (j >= 0) {
        f = TileStatus<T>::read(status, j, &v);
      } else {
        f = kPrefix;
        v = T(0);
      }
    } while (__any_sync(kFull, f == 0u));
    pmask = __ballot_sync(kFull, (f & kPrefix) != 0u);
    if (pmask) break;
    end -= 32;
  }
  // forward, a left fold in tile order from the nearest prefix
  int k = __ffs(pmask) - 1;
  T c = __shfl_sync(kFull, v, k);
  while (true) {
    for (int i = k - 1; i >= 0; --i) {
      const T vi = __shfl_sync(kFull, v, i);
      const unsigned fi = __shfl_sync(kFull, f, i);
      c = (fi & kPrefix) ? vi : c + vi;
    }
    if (end == t - 1) return c;
    end += 32;
    // published: seen on the way back
    f = TileStatus<T>::read(status, end - lane, &v);
    k = 32;
  }
}

// 16 bytes of values from p: four floats or two doubles.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 b = *reinterpret_cast<const float4*>(p);
  v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 b = *reinterpret_cast<const double2*>(p);
  v[0] = b.x; v[1] = b.y;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
// 16 bytes of a 16-bit plane: eight values, converted to and from float.
template <typename S>
__device__ __forceinline__ void load16(const S* p, float* v) {
  const uint4 b = *reinterpret_cast<const uint4*>(p);
  const S* h = reinterpret_cast<const S*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = Acc<S>::in(h[i]);
}
template <typename S>
__device__ __forceinline__ void store16(S* p, const float* v) {
  uint4 b;
  S* h = reinterpret_cast<S*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = Acc<S>::out(v[i]);
  *reinterpret_cast<uint4*>(p) = b;
}

// A thread's kItems slots from g0 on: 16-byte loads in a full tile,
// masked scalar loads in the ragged last one.
template <typename S, bool kRidPlane, typename T = typename Acc<S>::T>
__device__ __forceinline__ void load_items(const int* __restrict__ rid,
                                           const int* __restrict__ col,
                                           const S* __restrict__ val,
                                           long long N, long long g0,
                                           bool full, int* c, int* r, T* v) {
  constexpr int kPer16 = 16 / sizeof(S);
  if (full) {
    const int4* c4 = reinterpret_cast<const int4*>(col + g0);
    const int4* r4 =
        kRidPlane ? reinterpret_cast<const int4*>(rid + g0) : nullptr;
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 a = c4[q];
      c[4 * q] = a.x; c[4 * q + 1] = a.y; c[4 * q + 2] = a.z;
      c[4 * q + 3] = a.w;
      if constexpr (kRidPlane) {
        const int4 e = r4[q];
        r[4 * q] = e.x; r[4 * q + 1] = e.y; r[4 * q + 2] = e.z;
        r[4 * q + 3] = e.w;
      } else {
        r[4 * q] = r[4 * q + 1] = r[4 * q + 2] = r[4 * q + 3] = 0;
      }
    }
#pragma unroll
    for (int q = 0; q < kItems / kPer16; ++q) {
      load16(val + g0 + kPer16 * q, v + kPer16 * q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long g = g0 + k;
      c[k] = g < N ? col[g] : 0;
      v[k] = g < N ? Acc<S>::in(val[g]) : T(0);
      r[k] = (kRidPlane && g < N) ? rid[g] : 0;
    }
  }
}

template <typename S, bool kRidPlane, bool kColSentinel>
__global__ void __launch_bounds__(kThreads)
contract_kernel(const int* __restrict__ rid, const int* __restrict__ col,
                const S* __restrict__ val, uint8_t* __restrict__ last,
                S* __restrict__ sums, long long N, long long W, int n_cols,
                unsigned long long* __restrict__ scratch) {
  using T = typename Acc<S>::T;
  __shared__ unsigned s_tile;
  __shared__ Seg<T> s_warp[kWarps];
  __shared__ T s_carry;
  __shared__ int s_start;  // the tile's first slot starts a run

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Rows that divide the tile start a run at every tile's first slot: no
  // tile needs a carry, so the wrapper passes no scratch and the tile is
  // blockIdx.x. Otherwise the tile is the next from the tile counter.
  long long t = blockIdx.x;
  if (scratch != nullptr) {
    if (tid == 0) {
      s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    }
    __syncthreads();
    t = s_tile;
  }
  const long long g0 = t * kTile + (long long)tid * kItems;
  const bool full = (t + 1) * kTile <= N;
  int c[kItems], r[kItems];
  T v[kItems];
  load_items<S, kRidPlane>(rid, col, val, N, g0, full, c, r, v);

  // slot g0 - 1: the previous lane's last slot; lane 0 reads it
  int c_prev = __shfl_up_sync(kFull, c[kItems - 1], 1);
  int r_prev = __shfl_up_sync(kFull, r[kItems - 1], 1);
  if (lane == 0 && g0 > 0 && g0 <= N) {
    c_prev = col[g0 - 1];
    if constexpr (kRidPlane) r_prev = rid[g0 - 1];
  }

  // run starts (bit k: slot g0 + k) and row ends; p walks the position in
  // the row, so slot N (past the end) reads as a row head
  const unsigned w32 = (unsigned)W;
  unsigned p = (unsigned)(g0 % W);
  unsigned head = 0, row_end = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool h = p == 0 || c[k] != c_prev || (kRidPlane && r[k] != r_prev);
    head |= (unsigned)h << k;
    if (p == w32 - 1) row_end |= 1u << k;
    c_prev = c[k];
    r_prev = r[k];
    p = p + 1 == w32 ? 0 : p + 1;
  }
  // slot g0 + kItems: the next lane's first; lane 31 decides it itself
  unsigned nxt = __shfl_down_sync(kFull, head & 1u, 1);
  if (lane == 31) {
    const long long gn = g0 + kItems;
    if (gn >= N || p == 0) {
      nxt = 1;
    } else {
      nxt = col[gn] != c[kItems - 1];
      if constexpr (kRidPlane) nxt |= rid[gn] != r[kItems - 1];
    }
  }
  unsigned lastm = (head >> 1) | (nxt << (kItems - 1));
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    live |= (unsigned)(c[k] < n_cols) << k;
    if constexpr (kColSentinel) {
      // a row's last slot is compared with the sentinel -2
      if ((row_end >> k) & 1u) {
        lastm = (lastm & ~(1u << k)) | ((unsigned)(c[k] != -2) << k);
      }
    }
  }
  lastm &= live;

  // this thread's aggregate, then an inclusive scan within the warp
  Seg<T> agg = {v[0], (int)(head & 1u)};
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    agg = seg_op(agg, Seg<T>{v[k], (int)((head >> k) & 1u)});
  }
  Seg<T> inc = agg;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg<T> up = shfl_up(inc, o);
    if (lane >= o) inc = seg_op(up, inc);
  }
  Seg<T> ex = shfl_up(inc, 1);
  if (lane == 0) ex = Seg<T>{T(0), 0};
  if (lane == 31) s_warp[warp] = inc;
  if (tid == 0) s_start = head & 1u;
  __syncthreads();

  // warp 0: scan the warp totals, publish, look back for the carry
  if (warp == 0) {
    Seg<T> w = lane < kWarps ? s_warp[lane] : Seg<T>{T(0), 0};
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const Seg<T> up = shfl_up(w, o);
      if (lane >= o) w = seg_op(up, w);
    }
    if (lane < kWarps) s_warp[lane] = w;
    T carry = T(0);
    if (scratch != nullptr) {
      unsigned long long* status = scratch + 1;
      const T total_v = __shfl_sync(kFull, w.v, kWarps - 1);
      const int total_f = __shfl_sync(kFull, w.f, kWarps - 1);
      if (lane == 0) {
        TileStatus<T>::publish(status, t, total_v,
                               total_f ? kPrefix : kAggregate);
      }
      if (!s_start) {
        carry = look_back<T>(status, t, lane);
        if (lane == 0 && !total_f) {
          TileStatus<T>::publish(status, t, carry + total_v, kPrefix);
        }
      }
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  Seg<T> run = {s_carry, 0};
  if (warp > 0) run = seg_op(run, s_warp[warp - 1]);
  run = seg_op(run, ex);
  T out[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = seg_op(run, Seg<T>{v[k], (int)((head >> k) & 1u)});
    out[k] = run.v;
  }

  if (full) {
    constexpr int kPer16 = 16 / sizeof(S);
#pragma unroll
    for (int q = 0; q < kItems / kPer16; ++q) {
      store16(sums + g0 + kPer16 * q, out + kPer16 * q);
    }
    // one byte a flag: spread bit k of lastm to byte k
    unsigned b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned n4 = (lastm >> (4 * q)) & 0xfu;
      b[q] = (n4 & 1u) | ((n4 >> 1) & 1u) << 8 | ((n4 >> 2) & 1u) << 16 |
             ((n4 >> 3) & 1u) << 24;
    }
    *reinterpret_cast<uint4*>(last + g0) = make_uint4(b[0], b[1], b[2], b[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long g = g0 + k;
      if (g < N) {
        sums[g] = Acc<S>::out(out[k]);
        last[g] = (uint8_t)((lastm >> k) & 1u);
      }
    }
  }
}

// Zeroes the n words of a launch's scratch (the tile counter and the status
// words) before the launch.
__global__ void __launch_bounds__(kThreads)
contract_scratch_clear(unsigned long long* __restrict__ scratch,
                       long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    scratch[i] = 0ull;
  }
}

template <typename S, bool kRidPlane, bool kColSentinel>
int launch(const void* rid, const void* col, const void* val, void* last,
           void* sums, long long R, long long W, int n_cols, void* scratch,
           void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (W > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long N = R * W;
  const long long tiles = (N + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL || (scratch == nullptr && kTile % W != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (scratch != nullptr) {
    const long long n = 1 + TileStatus<typename Acc<S>::T>::kWords * tiles;
    const long long blocks = (n + kThreads - 1) / kThreads;
    contract_scratch_clear<<<(unsigned)(blocks < 1024 ? blocks : 1024),
                             kThreads, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)scratch, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  contract_kernel<S, kRidPlane, kColSentinel>
      <<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
          (const int*)rid, (const int*)col, (const S*)val, (uint8_t*)last,
          (S*)sums, N, W, n_cols, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

template <typename T>
int stream_contract(const void* rid, const void* col, const void* val,
                    void* last, void* sums, long long R, long long W,
                    int n_cols, void* scratch, void* stream) {
  if (rid != nullptr) {
    return launch<T, true, false>(rid, col, val, last, sums, R, W, n_cols,
                                  scratch, stream);
  }
  return launch<T, false, false>(nullptr, col, val, last, sums, R, W, n_cols,
                                 scratch, stream);
}

}  // namespace

// rid: a contiguous (R, W) plane, or null for a per-row rid (never read).
// scratch: 1 + ceil(R * W / 4096) 8-byte words for float values, 1 + 3 *
// ceil(R * W / 4096) for double (the tile counter and the status; cleared
// here), or null where W divides 4096 (no tile needs a carry).
extern "C" int speck_stream_contract(const void* rid, const void* col,
                                     const void* val, void* last, void* sums,
                                     long long R, long long W, int n_cols,
                                     void* scratch, void* stream) {
  return stream_contract<float>(rid, col, val, last, sums, R, W, n_cols,
                                scratch, stream);
}

extern "C" int speck_stream_contract_f64(const void* rid, const void* col,
                                         const void* val, void* last,
                                         void* sums, long long R, long long W,
                                         int n_cols, void* scratch,
                                         void* stream) {
  return stream_contract<double>(rid, col, val, last, sums, R, W, n_cols,
                                 scratch, stream);
}

extern "C" int speck_contract_runs(const void* col, const void* val,
                                   void* last, void* sums, long long R,
                                   long long W, int n_cols, void* scratch,
                                   void* stream) {
  return launch<float, false, true>(nullptr, col, val, last, sums, R, W,
                                    n_cols, scratch, stream);
}

extern "C" int speck_contract_runs_f64(const void* col, const void* val,
                                       void* last, void* sums, long long R,
                                       long long W, int n_cols, void* scratch,
                                       void* stream) {
  return launch<double, false, true>(nullptr, col, val, last, sums, R, W,
                                     n_cols, scratch, stream);
}

// The same four with 16-bit values (sums taken in float, stored once in
// the value's type; the status is float's one word a tile).
extern "C" int speck_stream_contract_bf16(const void* rid, const void* col,
                                          const void* val, void* last,
                                          void* sums, long long R,
                                          long long W, int n_cols,
                                          void* scratch, void* stream) {
  return stream_contract<__nv_bfloat16>(rid, col, val, last, sums, R, W,
                                        n_cols, scratch, stream);
}

extern "C" int speck_stream_contract_f16(const void* rid, const void* col,
                                         const void* val, void* last,
                                         void* sums, long long R, long long W,
                                         int n_cols, void* scratch,
                                         void* stream) {
  return stream_contract<__half>(rid, col, val, last, sums, R, W, n_cols,
                                 scratch, stream);
}

extern "C" int speck_contract_runs_bf16(const void* col, const void* val,
                                        void* last, void* sums, long long R,
                                        long long W, int n_cols,
                                        void* scratch, void* stream) {
  return launch<__nv_bfloat16, false, true>(nullptr, col, val, last, sums, R,
                                            W, n_cols, scratch, stream);
}

extern "C" int speck_contract_runs_f16(const void* col, const void* val,
                                       void* last, void* sums, long long R,
                                       long long W, int n_cols, void* scratch,
                                       void* stream) {
  return launch<__half, false, true>(nullptr, col, val, last, sums, R, W,
                                     n_cols, scratch, stream);
}

extern "C" const char* speck_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
