// Expand kernel for NVIDIA Hopper (sm_90a): K4, the expand stage of a
// stream chunk (ops/expand.py stream_expand; its plain torch form is
// expand_plain there).
//
// K4 replaces no TPU kernel: the reference's expand is XLA
// (the chunk expand of speck_tpu/ops/stream.py, boundary scatters and
// forward fills). It was added because the torch form of the same stage was the
// largest piece of torch glue on the card: about 26 launches a chunk (two
// searchsorted decodes over the chunk's slots, the record window's four
// gathers, int64 copies of every int32 index, a gather of B per product,
// the where's), some 500-700 MB of traffic a (512, 8192) chunk, the
// largest share of every cell's device time.
//
// What it computes, for slot s of chunk [chunk_start, chunk_start + slots),
// t = chunk_start + s (int32 stream positions):
//   rid[s] = #(e <= t) - 1                          (the sorted row)
//   rec    = #(p0w <= t) - 1 over the record window p0w = p0[base, base+K)
//            with base = clamp(sid_base - 1, 0, nnz_a - K) where K < nnz_a,
//            else 0 (the plain form's window, sid_base read on the card)
//   live   = rec >= 0 and t < pend[rec] and rid >= 0
//   col[s] = live ? B column at su[rec] + t : n_cols
//   val[s] = live ? a[rec] * B value at su[rec] + t : 0
// with B the packed (col, float32 bits) record of a float32 A (a[rec] the
// bits in sa) or B's columns and values apart (a[rec] = a_data[clamp(
// sa[rec], 0, n_a - 1)], sa the A-source map). The product takes the type
// torch's multiply gives the promoted pair: float and double multiply in
// their own type (__fmul_rn, __dmul_rn: no contraction), a 16-bit product
// is taken in float and rounded once (__float2half_rn, __float2bfloat16_rn),
// so every slot equals the plain form's bit for bit, dead slots included.
//
// What bounds it on an H100: device memory. It writes rid, col and val (12
// bytes a slot in float32, 16 in float64, 10 in 16 bits) and reads each
// live product's B entry once (8 bytes packed; 4 + the value's apart):
// records hold consecutive B entries, so the reads stream. The row and
// record starts it searches are a few bytes a slot. A (512, 8192) chunk
// of the graph's float32 stream moves about 80 MB, 25 us at 3.35 TB/s.
//
// Design:
// - One CTA a tile of kTile = 2048 consecutive slots, 256 threads x 8
//   consecutive slots each, so that rid, col and val leave as 16-byte
//   stores, a warp's 1 KB of a plane at a time.
// - Four warps find the tile's bounds in device memory at once: the rows
//   whose starts lie in the tile's span and the window's records likewise
//   (a warp-wide 32-ary search, one load a lane a step, ~5 steps over
//   millions of entries). The window is read in place at base: no copy.
// - Those starts (at most one a slot when they are strictly increasing,
//   kTile of each) go to shared memory, with each record's pend, su and A
//   value (the unpacked A gathered once a record, not once a product).
//   A tile whose span holds more starts than that (equal starts: rows
//   without products, the uncompacted records of empty B rows) searches
//   device memory instead; nothing else changes.
// - A thread finds its first slot's row and record by a gallop and a
//   binary search in shared memory from the tile's lower bounds, then
//   walks forward slot by slot (one compare, as a slot rarely starts a row
//   or a record).
// - The value type is a template parameter of the output (float, double,
//   __half, __nv_bfloat16) and of the packing; the operands' own types are
//   read by a type code, so five builds cover every pair of value types.
// - sid_base is read on the card: no readback, no synchronize. The kernel
//   allocates nothing; the wrapper allocates the three planes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

// value type codes (ops/expand.py _TYPE_CODE)
constexpr int kF32 = 0;
constexpr int kF64 = 1;
constexpr int kBF16 = 2;
constexpr int kF16 = 3;

struct ExpandArgs {
  const int* e;           // (m,) sorted row starts
  long long m;
  const int* p0;          // (nnz_a,) record starts, ascending
  const int* su;          // B position minus stream position
  const int* sa;          // A value bits (packed) or A-source map
  const int* pend;        // record product ends
  long long nnz_a;
  long long window;       // K: records the chunk may read
  const int* sid_base;    // device scalar
  const int2* b_rec;      // packed (nnz_b, 2) record, or null: unpacked
  const void* a_data;
  long long n_a;
  int a_type;
  const int* b_indices;
  const void* b_data;
  int b_type;
  long long nnz_b;
  long long chunk_start;
  long long slots;        // G * W
  int n_cols;
  int* rid;
  int* col;
  void* val;
};

// A value of type code `type` at p[i], in the type M the product takes.
template <typename M>
__device__ __forceinline__ M load_value(const void* p, long long i,
                                        int type) {
  switch (type) {
    case kF64:
      return (M)(static_cast<const double*>(p)[i]);
    case kBF16:
      return (M)__bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16:
      return (M)__half2float(static_cast<const __half*>(p)[i]);
    default:
      return (M)(static_cast<const float*>(p)[i]);
  }
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

// The product's storage type O from the type M it is taken in.
template <typename O>
struct Out {
  __device__ static O of(O x) { return x; }
};
template <>
struct Out<__half> {
  __device__ static __half of(float x) { return __float2half_rn(x); }
};
template <>
struct Out<__nv_bfloat16> {
  __device__ static __nv_bfloat16 of(float x) {
    return __float2bfloat16_rn(x);
  }
};

// A record's A value: the bits of a float32 A, or A's value through the
// A-source map (clamped into A, as the plain form clamps it).
template <typename M, bool kPacked>
__device__ __forceinline__ M a_value(const ExpandArgs& a, int s) {
  if constexpr (kPacked) {
    return __int_as_float(s);
  } else {
    long long i = s < 0 ? 0 : (long long)s;
    if (i > a.n_a - 1) i = a.n_a - 1;
    return load_value<M>(a.a_data, i, a.a_type);
  }
}

// Ascending int32 starts, held in shared memory from index `off` on or in
// device memory (off 0).
struct Starts {
  const int* p;
  long long off;
  __device__ __forceinline__ int operator[](long long i) const {
    return p[i - off];
  }
};

// The first index in [lo, hi) whose start exceeds t, where every index
// below lo holds a start <= t (hi where none does): a gallop from lo, then
// a binary search.
__device__ __forceinline__ long long upper_from(const Starts& a, long long lo,
                                                long long hi, int t) {
  if (lo >= hi || a[lo] > t) return lo;
  long long at = lo, step = 1;  // a[at] <= t
  while (at + step < hi && a[at + step] <= t) {
    at += step;
    step <<= 1;
  }
  long long l = at + 1, h = at + step < hi ? at + step : hi;
  while (l < h) {
    const long long mid = (l + h) >> 1;
    if (a[mid] <= t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l;
}

// #(a[0, n) <= t) for ascending a in device memory, by one whole warp: a
// 32-ary search (each lane probes one of 32 points a step), then one
// probe a lane over the last 32 entries.
__device__ long long warp_upper_bound(const int* __restrict__ a, long long n,
                                      int t, int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const unsigned gt =
        __ballot_sync(kFull, a[lo + len * (lane + 1) / 33] > t);
    if (gt == 0u) {
      lo += len * 32 / 33 + 1;
    } else {
      const int j = __ffs(gt) - 1;
      hi = lo + len * (j + 1) / 33;
      lo = j == 0 ? lo : lo + len * j / 33 + 1;
    }
  }
  const long long p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && a[p] <= t));
}

// Eight values of one thread to p (16-byte aligned): two float4, four
// double2, or one 16-byte word of 16-bit values.
__device__ __forceinline__ void store8(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(double* p, const double* v) {
  double2* q = reinterpret_cast<double2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = make_double2(v[2 * i], v[2 * i + 1]);
}
template <typename S>
__device__ __forceinline__ void store8(S* p, const S* v) {
  uint4 b;
  S* h = reinterpret_cast<S*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = v[i];
  *reinterpret_cast<uint4*>(p) = b;
}
__device__ __forceinline__ void store8(int* p, const int* v) {
  int4* q = reinterpret_cast<int4*>(p);
  q[0] = make_int4(v[0], v[1], v[2], v[3]);
  q[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// Shared memory of a tile: the rows' starts, the records' starts, pends,
// su and A values (M), kTile each.
template <typename M>
constexpr int smem_bytes() {
  return kTile * (4 * (int)sizeof(int) + (int)sizeof(M));
}

template <typename M, typename O, bool kPacked>
__global__ void __launch_bounds__(kThreads, 4)
stream_expand_kernel(const ExpandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_e = reinterpret_cast<int*>(smem);
  int* s_p0 = s_e + kTile;
  int* s_pend = s_p0 + kTile;
  int* s_u = s_pend + kTile;
  M* s_a = reinterpret_cast<M*>(s_u + kTile);
  __shared__ long long s_bound[4];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long first = (long long)blockIdx.x * kTile;
  const long long end = first + kTile < a.slots ? first + kTile : a.slots;
  const int t_lo = (int)(a.chunk_start + first);
  const int t_hi = (int)(a.chunk_start + end - 1);
  long long base = 0;
  if (a.window < a.nnz_a) {
    const long long sb = (long long)*a.sid_base - 1;
    base = sb < 0 ? 0 : (sb > a.nnz_a - a.window ? a.nnz_a - a.window : sb);
  }
  const int* p0w = a.p0 + base;

  // the tile's bounds: rows and window records with a start <= t_lo and
  // <= t_hi
  if (warp < 4) {
    const bool rows = warp < 2;
    const long long ub = warp_upper_bound(rows ? a.e : p0w,
                                          rows ? a.m : a.window,
                                          (warp & 1) ? t_hi : t_lo, lane);
    if (lane == 0) s_bound[warp] = ub;
  }
  __syncthreads();
  const long long rb0 = s_bound[0], rb1 = s_bound[1];
  const long long qb0 = s_bound[2], qb1 = s_bound[3];
  // the record at or before t_lo, then those starting in the tile's span
  const long long qs = qb0 > 0 ? qb0 - 1 : 0;
  const bool rows_sh = rb1 - rb0 <= kTile;
  const bool recs_sh = qb1 - qs <= kTile;
  if (rows_sh) {
    for (long long i = tid; i < rb1 - rb0; i += kThreads) {
      s_e[i] = a.e[rb0 + i];
    }
  }
  if (recs_sh) {
    for (long long i = tid; i < qb1 - qs; i += kThreads) {
      const long long g = base + qs + i;
      s_p0[i] = a.p0[g];
      s_pend[i] = a.pend[g];
      s_u[i] = a.su[g];
      s_a[i] = a_value<M, kPacked>(a, a.sa[g]);
    }
  }
  __syncthreads();

  const Starts rows = rows_sh ? Starts{s_e, rb0} : Starts{a.e, 0};
  const Starts starts = recs_sh ? Starts{s_p0, qs} : Starts{p0w, 0};
  const long long s0 = first + (long long)tid * kItems;
  const O zero = Out<O>::of(M(0));
  int r_out[kItems], c_out[kItems];
  O v_out[kItems];
  long long ri = rb0, qi = qb0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long s = s0 + k;
    int rid = 0, c = a.n_cols;
    O v = zero;
    if (s < end) {
      const int t = (int)(a.chunk_start + s);
      ri = upper_from(rows, ri, rb1, t);
      qi = upper_from(starts, qi, qb1, t);
      rid = (int)(ri - 1);
      const long long rec = qi - 1;
      if (rec >= 0 && rid >= 0) {
        const long long j = recs_sh ? rec - qs : base + rec;
        if (t < (recs_sh ? s_pend[j] : a.pend[j]) && a.nnz_b > 0) {
          const int u = recs_sh ? s_u[j] : a.su[j];
          const M av = recs_sh ? s_a[j] : a_value<M, kPacked>(a, a.sa[j]);
          // the B position in int32, as torch adds it; clamped into B
          long long b = (long long)(int)((unsigned)u + (unsigned)t);
          b = b < 0 ? 0 : (b > a.nnz_b - 1 ? a.nnz_b - 1 : b);
          if constexpr (kPacked) {
            const int2 r = a.b_rec[b];
            c = r.x;
            v = Out<O>::of(mul(av, __int_as_float(r.y)));
          } else {
            c = a.b_indices[b];
            v = Out<O>::of(mul(av, load_value<M>(a.b_data, b, a.b_type)));
          }
        }
      }
    }
    r_out[k] = rid;
    c_out[k] = c;
    v_out[k] = v;
  }

  O* val = static_cast<O*>(a.val);
  if (s0 + kItems <= a.slots) {
    store8(a.rid + s0, r_out);
    store8(a.col + s0, c_out);
    store8(val + s0, v_out);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (s0 + k < a.slots) {
        a.rid[s0 + k] = r_out[k];
        a.col[s0 + k] = c_out[k];
        val[s0 + k] = v_out[k];
      }
    }
  }
}

template <typename M, typename O, bool kPacked>
int launch(const ExpandArgs& a, void* stream) {
  if (a.slots <= 0) return 0;
  const long long tiles = (a.slots + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL || a.window < 0 || a.window > a.nnz_a) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = smem_bytes<M>();
  if (smem > 40 * 1024) {
    // above the default limit with the static words: ask for it
    const cudaError_t err = cudaFuncSetAttribute(
        stream_expand_kernel<M, O, kPacked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  stream_expand_kernel<M, O, kPacked>
      <<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One chunk's (rid, col, val). b_rec non-null: the packed float32 record
// (a_data, b_indices, b_data unused, out_type float32); null: B's columns
// and values apart, with the A, B and product types by code (0 float32,
// 1 float64, 2 bfloat16, 3 float16). sid_base: a device int32 scalar.
// window: min(nnz_a, the plan's chunk slots + 2).
extern "C" int speck_stream_expand(
    const void* e, long long m, const void* p0, const void* su,
    const void* sa, const void* pend, long long nnz_a, long long window,
    const void* sid_base, const void* b_rec,
    const void* a_data, long long n_a, int a_type, const void* b_indices,
    const void* b_data, int b_type, long long nnz_b, int out_type,
    long long chunk_start, long long slots, int n_cols, void* rid, void* col,
    void* val, void* stream) {
  ExpandArgs a;
  a.e = static_cast<const int*>(e);
  a.m = m;
  a.p0 = static_cast<const int*>(p0);
  a.su = static_cast<const int*>(su);
  a.sa = static_cast<const int*>(sa);
  a.pend = static_cast<const int*>(pend);
  a.nnz_a = nnz_a;
  a.window = window;
  a.sid_base = static_cast<const int*>(sid_base);
  a.b_rec = static_cast<const int2*>(b_rec);
  a.a_data = a_data;
  a.n_a = n_a;
  a.a_type = a_type;
  a.b_indices = static_cast<const int*>(b_indices);
  a.b_data = b_data;
  a.b_type = b_type;
  a.nnz_b = nnz_b;
  a.chunk_start = chunk_start;
  a.slots = slots;
  a.n_cols = n_cols;
  a.rid = static_cast<int*>(rid);
  a.col = static_cast<int*>(col);
  a.val = val;
  if (b_rec != nullptr) {
    return out_type == kF32 ? launch<float, float, true>(a, stream)
                            : (int)cudaErrorInvalidValue;
  }
  switch (out_type) {
    case kF32:
      return launch<float, float, false>(a, stream);
    case kF64:
      return launch<double, double, false>(a, stream);
    case kBF16:
      return launch<float, __nv_bfloat16, false>(a, stream);
    case kF16:
      return launch<float, __half, false>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
