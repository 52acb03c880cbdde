// K1: windowed segment aggregate (masked count/sum/min/max per segment).
//
// Replaces the Pallas kernel cnosdb_tpu/ops/pallas_kernels.py::_kernel
// (launched by _windowed_partials, wrapped by segment_partials_pallas) and
// the XLA window fold after it: the result here is the final
// [num_segments] count/sum/min/max, fold included, from one launch.
//
// Storage layout makes the segment ids of a 256-row tile a narrow
// contiguous range [base, base + span), and the rows of a tile come in
// storage order, in runs of equal segment id. The TPU kernel reduced
// every tile into a dense 2048-slot window with an [R, W] masked
// broadcast; here a warp reduces one tile over only its actual span:
//
//   1. One warp per tile, four tiles per block. Each thread loads eight
//      consecutive rows (16-byte vectors of values and segment ids, one
//      8-byte load of valid flags) and reduces its own runs of equal
//      segment id serially, in row order. A thread per two rows with a
//      shuffle scan over all of them was instruction-bound: the shuffles, not
//      the bytes, set its time at 10 M rows.
//   2. The warp joins the threads' last runs with a segmented shuffle
//      scan (head flags, a fixed Hillis-Steele tree), and writes one
//      partial per run end into shared memory in row order (an exclusive
//      scan of the threads' partial counts gives each its place).
//   3. The owner of each window slot (a lane) combines that slot's run
//      partials in row order and writes the tile's partial.
//   4. One launch, no second pass: each segment has an arrival counter
//      whose target is the number of tiles that cover it (the layout's
//      seg_start run length). The tile writes its partials, fences, and
//      adds one to the counter of each segment it covers; the tile that
//      completes a counter folds that segment's partials in tile order
//      (the layout places them contiguously, in that order), writes the
//      result and resets the counter to 0. Segments no tile covers get the empty result.
//
// No float atomics: every partial is written once and folded in a fixed
// order, and the shuffle tree is fixed, so two runs give the same bits.
// min/max propagate NaN as jnp.min / np.minimum do (fmin/fmax would drop
// it).
//
// Bound on this card: bytes. It reads 13 B per row (8 value, 1 valid, 4
// segment id) and the layout, and writes 28 B per segment; there is no
// arithmetic to speak of. Each row crosses device memory once; the
// partials (28 B per covered slot) stay in L2 between the tile that writes
// them and the one that folds them. At the main path's few thousand rows
// the launch itself is the cost, so the host wrapper stages everything
// through one copy each way around this single launch, all enqueued by one
// C call (segment_window_call_*) that holds the Python GIL for its few
// microseconds: the executor calls the wrapper from eight threads, and
// every release of the GIL is a chance to queue behind another thread.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int R_TILE = 256;
constexpr int RPT = R_TILE / 32;          // rows per thread: a warp a tile
constexpr int WARPS = 4;                  // tiles per block
constexpr int THREADS = 32 * WARPS;

template <typename T> struct Lim;
template <> struct Lim<double> {
  typedef double2 Vec;
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000ULL); }
  __device__ static double lo() { return __longlong_as_double(0xfff0000000000000ULL); }
  __device__ static bool nan(double x) { return x != x; }
  __device__ static double add(double a, double b) { return a + b; }
};
template <> struct Lim<long long> {
  typedef longlong2 Vec;
  __device__ static long long hi() { return 0x7fffffffffffffffLL; }
  __device__ static long long lo() { return (long long)0x8000000000000000ULL; }
  __device__ static bool nan(long long) { return false; }
  // two's-complement wrap, as the column's own integer arithmetic does
  __device__ static long long add(long long a, long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
};

template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  if (Lim<T>::nan(a)) return a;
  if (Lim<T>::nan(b)) return b;
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (Lim<T>::nan(a)) return a;
  if (Lim<T>::nan(b)) return b;
  return b > a ? b : a;
}

// count/sum/min/max of some rows; combine(a, b) keeps a's rows first
template <typename T> struct Part {
  int32_t c;
  T s, lo, hi;
};

template <typename T>
__device__ __forceinline__ Part<T> empty_part() {
  return Part<T>{0, T(0), Lim<T>::hi(), Lim<T>::lo()};
}

template <typename T>
__device__ __forceinline__ Part<T> row_part(T x, bool ok) {
  return ok ? Part<T>{1, x, x, x} : empty_part<T>();
}

template <typename T>
__device__ __forceinline__ Part<T> combine(const Part<T>& a, const Part<T>& b) {
  return Part<T>{a.c + b.c, Lim<T>::add(a.s, b.s), min_nan(a.lo, b.lo),
                 max_nan(a.hi, b.hi)};
}

template <typename T>
__device__ __forceinline__ Part<T> shfl_up(const Part<T>& p, int d) {
  return Part<T>{__shfl_up_sync(0xffffffffu, p.c, d),
                 __shfl_up_sync(0xffffffffu, p.s, d),
                 __shfl_up_sync(0xffffffffu, p.lo, d),
                 __shfl_up_sync(0xffffffffu, p.hi, d)};
}

// A thread's eight consecutive rows of a tile; a segment id of -1 marks
// rows past the end, bit k of `ok` row k's valid flag.
template <typename T>
__device__ __forceinline__ void load_rows(const T* values,
                                          const int8_t* valid,
                                          const int32_t* seg, int64_t r,
                                          int64_t n_rows, int vec,
                                          T (&x)[RPT], int32_t (&sg)[RPT],
                                          unsigned& ok) {
  ok = 0;
  if (vec && r + RPT <= n_rows) {
    typedef typename Lim<T>::Vec V;
    const V* vp = reinterpret_cast<const V*>(values + r);
#pragma unroll
    for (int k = 0; k < RPT / 2; ++k) {
      const V v = __ldcs(vp + k);
      x[2 * k] = v.x;
      x[2 * k + 1] = v.y;
    }
    const int4* sp = reinterpret_cast<const int4*>(seg + r);
#pragma unroll
    for (int k = 0; k < RPT / 4; ++k) {
      const int4 q = __ldcs(sp + k);
      sg[4 * k] = q.x; sg[4 * k + 1] = q.y;
      sg[4 * k + 2] = q.z; sg[4 * k + 3] = q.w;
    }
    const unsigned long long m =
        __ldcs(reinterpret_cast<const unsigned long long*>(valid + r));
#pragma unroll
    for (int k = 0; k < RPT; ++k) ok |= ((m >> (8 * k)) & 0xff) ? 1u << k : 0u;
    return;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int64_t i = r + k;
    x[k] = i < n_rows ? values[i] : T(0);
    sg[k] = i < n_rows ? seg[i] : -1;
    ok |= (i < n_rows && valid[i] != 0) ? 1u << k : 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_window(const T* __restrict__ values, const int8_t* __restrict__ valid,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ bases,
               const int64_t* __restrict__ slot_off,
               const int32_t* __restrict__ fold_pos,
               const int64_t* __restrict__ seg_start,
               int32_t* __restrict__ arrivals, int32_t* __restrict__ p_cnt,
               T* __restrict__ p_sum, T* __restrict__ p_min,
               T* __restrict__ p_max, int32_t* __restrict__ cnt,
               T* __restrict__ sum, T* __restrict__ mn, T* __restrict__ mx,
               int64_t n_rows, int64_t n_tiles, int64_t num_segments,
               int vec) {
  // each warp's run partials, in row order (a tile has at most R_TILE)
  __shared__ int32_t q_slot[WARPS][R_TILE];
  __shared__ int32_t q_cnt[WARPS][R_TILE];
  __shared__ T q_sum[WARPS][R_TILE];
  __shared__ T q_lo[WARPS][R_TILE];
  __shared__ T q_hi[WARPS][R_TILE];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * WARPS + warp;   // this warp's tile

  if (t < n_tiles) {
    const int32_t base = bases[t];
    T x[RPT];
    int32_t sl[RPT];
    unsigned ok;
    load_rows(values, valid, seg, t * R_TILE + lane * RPT, n_rows, vec, x,
              sl, ok);
#pragma unroll
    for (int k = 0; k < RPT; ++k) sl[k] = sl[k] < 0 ? -1 : sl[k] - base;

    // 1. the thread's own runs: count those that end inside its rows and
    //    reduce the last one (its tail)
    Part<T> tail = row_part(x[0], ok & 1u);
    int n_done = 0;
    bool multi = false;
#pragma unroll
    for (int k = 1; k < RPT; ++k) {
      const Part<T> pk = row_part(x[k], (ok >> k) & 1u);
      if (sl[k] == sl[k - 1]) {
        tail = combine(tail, pk);
      } else {
        n_done += sl[k - 1] >= 0;
        multi = true;
        tail = pk;
      }
    }
    const int32_t head_slot = sl[0];
    const int32_t tail_slot = sl[RPT - 1];

    // 2. segmented inclusive scan of the tails across the warp: a tail
    //    continues the previous thread's when the thread is one run and
    //    its slot is the previous tail's
    const int32_t prev_tail = __shfl_up_sync(0xffffffffu, tail_slot, 1);
    const int32_t next_head = __shfl_down_sync(0xffffffffu, head_slot, 1);
    Part<T> run = tail;
    bool head = multi || lane == 0 || head_slot != prev_tail;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Part<T> o = shfl_up(run, d);
      const bool oh = __shfl_up_sync(0xffffffffu, (int)head, d) != 0;
      if (lane >= d) {
        if (!head) run = combine(o, run);
        head = head || oh;
      }
    }
    const Part<T> run_prev = shfl_up(run, 1);
    const bool tail_ends =
        tail_slot >= 0 && (lane == 31 || next_head != tail_slot);
    // where this thread's partials go: an exclusive scan of their counts
    const int n_emit = n_done + (tail_ends ? 1 : 0);
    int upto = n_emit;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += o;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    int pos = upto - n_emit;

    //    the partials in row order: each run that ends inside the thread's
    //    rows (the first one joined to the previous thread's tail when it
    //    continues it), then the tail where its run ends here
    Part<T> acc = row_part(x[0], ok & 1u);
    bool first = true;
#pragma unroll
    for (int k = 1; k < RPT; ++k) {
      const Part<T> pk = row_part(x[k], (ok >> k) & 1u);
      if (sl[k] == sl[k - 1]) {
        acc = combine(acc, pk);
      } else {
        if (sl[k - 1] >= 0) {
          const Part<T> p = (first && lane > 0 && prev_tail == sl[k - 1])
                                ? combine(run_prev, acc) : acc;
          q_slot[warp][pos] = sl[k - 1]; q_cnt[warp][pos] = p.c;
          q_sum[warp][pos] = p.s; q_lo[warp][pos] = p.lo;
          q_hi[warp][pos] = p.hi;
          ++pos;
        }
        first = false;
        acc = pk;
      }
    }
    if (tail_ends) {
      q_slot[warp][pos] = tail_slot; q_cnt[warp][pos] = run.c;
      q_sum[warp][pos] = run.s; q_lo[warp][pos] = run.lo;
      q_hi[warp][pos] = run.hi;
    }
    __syncwarp();

    // 3 + 4. slot owners: the tile's partial, then the arrival count
    const int64_t off = slot_off[t];
    const int span = (int)(slot_off[t + 1] - off);
    for (int s = lane; s < span; s += 32) {
      Part<T> p = empty_part<T>();
      for (int i = 0; i < total; ++i) {
        if (q_slot[warp][i] == s)
          p = combine(p, Part<T>{q_cnt[warp][i], q_sum[warp][i],
                                 q_lo[warp][i], q_hi[warp][i]});
      }
      // the partial's place keeps each segment's partials contiguous and
      // in tile order, so the fold reads them without an indirection
      const int64_t q = fold_pos[off + s];
      __stcg(p_cnt + q, p.c);
      __stcg(p_sum + q, p.s);
      __stcg(p_min + q, p.lo);
      __stcg(p_max + q, p.hi);
      __threadfence();   // the partial is visible before the arrival is
      const int64_t g = (int64_t)base + s;
      const int64_t lo = seg_start[g];
      const int64_t hi = seg_start[g + 1];
      if (atomicAdd(arrivals + g, 1) == (int)(hi - lo) - 1) {
        __threadfence();
        Part<T> f = empty_part<T>();
#pragma unroll 4
        for (int64_t k = lo; k < hi; ++k)
          f = combine(f, Part<T>{__ldcg(p_cnt + k), __ldcg(p_sum + k),
                                 __ldcg(p_min + k), __ldcg(p_max + k)});
        cnt[g] = f.c;
        sum[g] = f.s;
        mn[g] = f.lo;
        mx[g] = f.hi;
        arrivals[g] = 0;   // the buffers may be launched over again
      }
    }
  }

  // segments that no tile covers: the empty result
  for (int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
       g < num_segments; g += (int64_t)gridDim.x * THREADS) {
    if (seg_start[g + 1] == seg_start[g]) {
      cnt[g] = 0;
      sum[g] = T(0);
      mn[g] = Lim<T>::hi();
      mx[g] = Lim<T>::lo();
    }
  }
}

template <typename T>
int run(const void* values, const void* valid, const void* seg,
        const void* bases, const void* slot_off, const void* order,
        const void* seg_start, void* arrivals, void* p_cnt, void* p_sum,
        void* p_min, void* p_max, void* cnt, void* sum, void* mn, void* mx,
        int64_t n_rows, int64_t n_tiles, int64_t num_segments, int vec,
        void* stream) {
  if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_tiles + WARPS - 1) / WARPS;
  segment_window<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)values, (const int8_t*)valid, (const int32_t*)seg,
      (const int32_t*)bases, (const int64_t*)slot_off, (const int32_t*)order,
      (const int64_t*)seg_start, (int32_t*)arrivals, (int32_t*)p_cnt,
      (T*)p_sum, (T*)p_min, (T*)p_max, (int32_t*)cnt, (T*)sum, (T*)mn,
      (T*)mx, n_rows, n_tiles, num_segments, vec);
  return (int)cudaGetLastError();
}

// The whole host-wrapper call as one C call: one host-to-device copy of
// the staged inputs, the launch, one device-to-host copy of the results
// (none when out_bytes is 0), and an event behind them for the caller to
// wait on. `off` holds the byte offsets of the 16 regions in the device
// buffer, in the order of the kernel's pointer arguments; rows already on
// the card come as `rows` (values, valid, segment ids), else null and
// staged.
template <typename T>
int call(const void* stage, void* dbuf, int64_t in_bytes, void* host_out,
         int64_t out_lo, int64_t out_bytes, const int64_t* off,
         const void* const* rows, int64_t n_rows, int64_t n_tiles,
         int64_t num_segments, void* event, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  char* d = (char*)dbuf;
  cudaError_t e = cudaMemcpyAsync(d, stage, (size_t)in_bytes,
                                  cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const void* x = rows ? rows[0] : d + off[0];
  const void* ok = rows ? rows[1] : d + off[1];
  const void* sg = rows ? rows[2] : d + off[2];
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)ok % 8 == 0 &&
                  (uintptr_t)sg % 16 == 0;
  const int rc = run<T>(x, ok, sg, d + off[3],
                        d + off[4], d + off[5], d + off[6], d + off[7],
                        d + off[8], d + off[9], d + off[10], d + off[11],
                        d + off[12], d + off[13], d + off[14], d + off[15],
                        n_rows, n_tiles, num_segments, vec, stream);
  if (rc != 0) return rc;
  if (out_bytes > 0) {
    e = cudaMemcpyAsync(host_out, d + out_lo, (size_t)out_bytes,
                        cudaMemcpyDeviceToHost, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaEventRecord((cudaEvent_t)event, st);
}

}  // namespace

extern "C" {

// vec != 0 promises 16-byte aligned values and segment ids and 8-byte
// aligned valid flags; arrivals must be zero at the first
// launch (every launch leaves them zero again).
int segment_window_f64(const void* values, const void* valid, const void* seg,
                       const void* bases, const void* slot_off,
                       const void* order, const void* seg_start,
                       void* arrivals, void* p_cnt, void* p_sum, void* p_min,
                       void* p_max, void* cnt, void* sum, void* mn, void* mx,
                       int64_t n_rows, int64_t n_tiles, int64_t num_segments,
                       int vec, void* stream) {
  return run<double>(values, valid, seg, bases, slot_off, order, seg_start,
                     arrivals, p_cnt, p_sum, p_min, p_max, cnt, sum, mn, mx,
                     n_rows, n_tiles, num_segments, vec, stream);
}

int segment_window_i64(const void* values, const void* valid, const void* seg,
                       const void* bases, const void* slot_off,
                       const void* order, const void* seg_start,
                       void* arrivals, void* p_cnt, void* p_sum, void* p_min,
                       void* p_max, void* cnt, void* sum, void* mn, void* mx,
                       int64_t n_rows, int64_t n_tiles, int64_t num_segments,
                       int vec, void* stream) {
  return run<long long>(values, valid, seg, bases, slot_off, order, seg_start,
                        arrivals, p_cnt, p_sum, p_min, p_max, cnt, sum, mn, mx,
                        n_rows, n_tiles, num_segments, vec, stream);
}

int segment_window_call_f64(const void* stage, void* dbuf, int64_t in_bytes,
                            void* host_out, int64_t out_lo,
                            int64_t out_bytes, const int64_t* off,
                            const void* const* rows, int64_t n_rows,
                            int64_t n_tiles, int64_t num_segments,
                            void* event, void* stream) {
  return call<double>(stage, dbuf, in_bytes, host_out, out_lo, out_bytes, off,
                      rows, n_rows, n_tiles, num_segments, event, stream);
}

int segment_window_call_i64(const void* stage, void* dbuf, int64_t in_bytes,
                            void* host_out, int64_t out_lo,
                            int64_t out_bytes, const int64_t* off,
                            const void* const* rows, int64_t n_rows,
                            int64_t n_tiles, int64_t num_segments,
                            void* event, void* stream) {
  return call<long long>(stage, dbuf, in_bytes, host_out, out_lo, out_bytes,
                         off, rows, n_rows, n_tiles, num_segments, event,
                         stream);
}

// Host half of the one-copy call, the same layout as the Python
// window_layout (which the CPU route and the tests use), without numpy's
// per-call overhead. Tile bounds of one call's segment ids: bases[t], the
// lowest id of tile t, and slot_off[t], its first partial slot (tiles + 1
// entries). → the slot count; -1 when a tile spans w_win or more segments
// (the layout declines), -2 when an id lies outside [0, num_segments).
int64_t segment_window_bounds(const int32_t* seg, int64_t n,
                              int64_t num_segments, int64_t w_win,
                              int32_t* bases, int64_t* slot_off) {
  const int64_t tiles = (n + R_TILE - 1) / R_TILE;
  int32_t lo_all = INT32_MAX, hi_all = INT32_MIN;
  bool wide = false;
  slot_off[0] = 0;
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t end = (t + 1) * R_TILE < n ? (t + 1) * R_TILE : n;
    int32_t lo = seg[t * R_TILE], hi = lo;
    for (int64_t r = t * R_TILE + 1; r < end; ++r) {
      lo = seg[r] < lo ? seg[r] : lo;
      hi = seg[r] > hi ? seg[r] : hi;
    }
    wide |= (int64_t)hi - lo >= w_win;
    lo_all = lo < lo_all ? lo : lo_all;
    hi_all = hi > hi_all ? hi : hi_all;
    bases[t] = lo;
    slot_off[t + 1] = slot_off[t] + ((int64_t)hi - lo + 1);
  }
  if (wide) return -1;
  if (lo_all < 0 || hi_all >= num_segments) return -2;
  return slot_off[tiles];
}

// Fill the input regions of a staging buffer: the rows, the tile bounds,
// each slot's fold place and seg_start (a counting sort of the slots by
// segment that keeps tile order), and zeroed arrival counters. off holds
// the byte offsets of values, valid, seg_ids, bases, slot_off, fold_pos,
// seg_start and arrivals (the arrival region serves as the sort's cursor
// first).
void segment_window_pack(void* stage, const int64_t* off, const void* values,
                         const void* valid, const int32_t* seg, int64_t n,
                         const int32_t* bases, const int64_t* slot_off,
                         int64_t tiles, int64_t num_segments) {
  char* b = (char*)stage;
  memcpy(b + off[0], values, (size_t)n * 8);
  memcpy(b + off[1], valid, (size_t)n);
  memcpy(b + off[2], seg, (size_t)n * 4);
  memcpy(b + off[3], bases, (size_t)tiles * 4);
  memcpy(b + off[4], slot_off, (size_t)(tiles + 1) * 8);
  int32_t* fold_pos = (int32_t*)(b + off[5]);
  int64_t* seg_start = (int64_t*)(b + off[6]);
  int32_t* cursor = (int32_t*)(b + off[7]);
  memset(seg_start, 0, (size_t)(num_segments + 1) * 8);
  for (int64_t t = 0; t < tiles; ++t)
    for (int64_t g = bases[t]; g < bases[t] + (slot_off[t + 1] - slot_off[t]);
         ++g)
      ++seg_start[g + 1];
  for (int64_t g = 0; g < num_segments; ++g) seg_start[g + 1] += seg_start[g];
  memset(cursor, 0, (size_t)num_segments * 4);
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t span = slot_off[t + 1] - slot_off[t];
    for (int64_t s = 0; s < span; ++s) {
      const int64_t g = bases[t] + s;
      fold_pos[slot_off[t] + s] = (int32_t)(seg_start[g] + cursor[g]++);
    }
  }
  memset(cursor, 0, (size_t)num_segments * 4);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
