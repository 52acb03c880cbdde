// K1: windowed segment aggregate (masked count/sum/min/max per segment).
//
// Replaces the Pallas kernel cnosdb_tpu/ops/pallas_kernels.py::_kernel
// (launched by _windowed_partials, wrapped by segment_partials_pallas) and
// the XLA window fold after it: the result here is the final
// [num_segments] count/sum/min/max, fold included, from one launch.
//
// The reference reduced every 256-row tile into a dense 2048-slot window
// based at the tile's lowest segment id. Here the reduction has two levels,
// so that it holds both where a segment lies inside one or two tiles
// (storage order: series-contiguous, time-ordered rows) and where every
// tile covers every segment (a group key drawn anew on every row):
//
//   1. Block runs. The host lays the tiles out in runs of at most
//      TILES_PER_RUN consecutive tiles whose union span of segment ids fits
//      the W_WIN-slot window (a tile that would overflow it starts a new
//      run). One block takes one run and keeps one window per warp in
//      shared memory, sized by the largest run span of the launch.
//   2. A warp per tile, tiles of the run dealt round-robin to the warps.
//      Each thread loads eight consecutive rows (16-byte vectors of values
//      and segment ids, one 8-byte load of valid flags) and reduces them in
//      one serial pass, in row order: a run of equal segment id that starts
//      and ends inside its rows is emitted as the pass meets its end. The
//      warp then joins the threads' last runs with a segmented shuffle scan
//      (head flags, a fixed Hillis-Steele tree), and each thread emits its
//      first run (joined to the previous thread's last run where it
//      continues it) and its last run where it ends there. Every run of
//      equal ids is emitted once, by the thread where it ends, and each row
//      is combined once.
//   3. Emissions enter the warp's window step by step. Where only one lane
//      emits it enters alone; else lanes that emit into the same slot are
//      found with __match_any_sync and enter in lane order, one round per
//      rank: no atomics, and a slot's order is fixed by (step, lane),
//      whatever the data.
//   4. The block combines its warps' windows slot by slot, in warp order.
//      A segment that only this run covers (the layout's seg_start run
//      length is 1) is final and written out: at the main path's few
//      thousand rows one block covers every row, and the launch is the
//      whole computation. Any other segment's block partial goes to its
//      place in (segment, run) order; the thread fences and adds one to
//      the segment's arrival counter, and the block that completes the
//      counter folds the segment: a warp reads its partials lane-strided
//      from L2, in run order, and joins the lanes with a fixed shuffle
//      tree, then resets the counter to 0. Segments no run covers get the
//      empty result.
//
// No float atomics: every partial is written once and folded in a fixed
// order, and the shuffle trees are fixed, so two runs give the same bits.
// min/max propagate NaN as jnp.min / np.minimum do (fmin/fmax would drop
// it).
//
// Bound on this card: bytes. The function reads 13 B per row (8 value, 1
// valid, 4 segment id) and writes 28 B per segment; there is no arithmetic
// to speak of. Each row crosses device memory once. The layout is per run,
// not per tile: 28 B of partial per (run, covered segment), which stays in
// L2 between the block that writes it and the one that folds it, and one
// arrival per (run, segment) only where a segment crosses runs. What holds
// it back (bench_k1.py --stages; PERF.md): where segments are long, the
// loads themselves, each lane taking 64 contiguous bytes of values, so a
// warp's load touches 16 lines at once; where every row is its own run,
// the emission rounds, a shared-memory read-modify-write per rank. At the main
// path's few thousand rows the launch itself is the cost, so the host
// wrapper stages everything through one copy each way around this single
// launch, all enqueued by one C call (segment_window_call_*) that holds the
// Python GIL for its few microseconds: the executor calls the wrapper from
// eight threads, and every release of the GIL is a chance to queue behind
// another thread.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <thread>
#include <vector>

namespace {

// K1_STOP cuts each tile's work short after its loads (1), the serial pass
// (2) or the warp scan (3), for bench_k1.py --stages only: the results are
// then wrong. Builds for the package leave it at 0.
#ifndef K1_STOP
#define K1_STOP 0
#endif
constexpr int R_TILE = 256;
constexpr int RPT = R_TILE / 32;          // rows per thread: a warp a tile
// Warps per block, at most: a launch of one run (the main path's few
// thousand rows) gives every tile a warp of its own; a launch of many runs
// takes half as many, so that two blocks share an SM (64 registers a
// thread either way).
constexpr int WARPS_MAX = 32;
constexpr int WARPS_MULTI = 16;
constexpr int64_t SMEM_MAX = 200 * 1024;  // shared memory a block may take
constexpr unsigned FULL = 0xffffffffu;

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
  return Part<T>{__shfl_up_sync(FULL, p.c, d), __shfl_up_sync(FULL, p.s, d),
                 __shfl_up_sync(FULL, p.lo, d), __shfl_up_sync(FULL, p.hi, d)};
}

template <typename T>
__device__ __forceinline__ Part<T> shfl_down(const Part<T>& p, int d) {
  return Part<T>{__shfl_down_sync(FULL, p.c, d),
                 __shfl_down_sync(FULL, p.s, d),
                 __shfl_down_sync(FULL, p.lo, d),
                 __shfl_down_sync(FULL, p.hi, d)};
}

// A window of `span` slots in shared memory, one array per field.
template <typename T> struct Window {
  int32_t* c;
  T *s, *lo, *hi;
  __device__ Part<T> get(int i) const { return Part<T>{c[i], s[i], lo[i], hi[i]}; }
  __device__ void set(int i, const Part<T>& p) const {
    c[i] = p.c; s[i] = p.s; lo[i] = p.lo; hi[i] = p.hi;
  }
};

// One emission step of a warp: each lane with `emit` set combines `p` into
// slot `slot` of the warp's window. Lanes that share a slot go in lane
// order, one round per rank, so the slot's order is fixed. Warp-collective.
template <typename T>
__device__ __forceinline__ void emit_into(const Window<T>& w, bool emit,
                                          int32_t slot, const Part<T>& p,
                                          int lane) {
  const unsigned act = __ballot_sync(FULL, emit);
  if (act == 0) return;
  if ((act & (act - 1u)) == 0) {   // one lane: no order to keep
    if (emit) w.set(slot, combine(w.get(slot), p));
    __syncwarp();
    return;
  }
  const unsigned peers = __match_any_sync(FULL, emit ? slot : -1);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = (int)__reduce_max_sync(FULL, emit ? (unsigned)rank : 0u);
  for (int q = 0; q <= rounds; ++q) {
    if (emit && rank == q) w.set(slot, combine(w.get(slot), p));
    __syncwarp();
  }
}

// A thread's eight consecutive rows of a tile; a segment id of -1 marks
// rows past the end, bit k of `ok` row k's valid flag.
template <typename T> struct Rows {
  T x[RPT];
  int32_t sl[RPT];
  unsigned ok;
};

template <typename T>
__device__ __forceinline__ void load_rows(const T* values,
                                          const int8_t* valid,
                                          const int32_t* seg, int64_t r,
                                          int64_t n_rows, int vec,
                                          Rows<T>& rows) {
  T (&x)[RPT] = rows.x;
  int32_t (&sg)[RPT] = rows.sl;
  unsigned& ok = rows.ok;
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

// Steps 2 and 3 for one tile: reduce its rows into the warp's window,
// whose slot 0 is segment `base`.
template <typename T>
__device__ __forceinline__ void tile_into(const Window<T>& w,
                                          const Rows<T>& rows, int32_t base,
                                          int lane) {
  const T (&x)[RPT] = rows.x;
  const unsigned ok = rows.ok;
  int32_t sl[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    sl[k] = rows.sl[k] < 0 ? -1 : rows.sl[k] - base;
#if K1_STOP == 1
  long long d = ok;
#pragma unroll
  for (int k = 0; k < RPT; ++k) d += (long long)x[k] + sl[k];
  if (d == -12345) w.set(0, empty_part<T>());
  return;
#endif

  // one pass over the rows: a run that starts and ends inside them enters
  // the window at once; the first run (it may continue the previous
  // thread's) and the last (it may go on in the next thread's) wait for
  // the scan
  Part<T> acc = row_part(x[0], ok & 1u);
  Part<T> first = acc;
  bool multi = false;
#pragma unroll
  for (int k = 1; k < RPT; ++k) {
    const bool brk = sl[k] != sl[k - 1];
#if K1_STOP == 0
    emit_into(w, brk && multi && sl[k - 1] >= 0, sl[k - 1], acc, lane);
#endif
    if (brk && !multi) first = acc;
    multi = multi || brk;
    const Part<T> pk = row_part(x[k], (ok >> k) & 1u);
    acc = combine(brk ? empty_part<T>() : acc, pk);
  }
#if K1_STOP == 2
  if (acc.c + first.c == -12345) w.set(0, acc);
  return;
#endif
  const int32_t head_slot = sl[0];
  const int32_t tail_slot = sl[RPT - 1];

  // segmented inclusive scan of the last runs across the warp: one
  // continues the previous thread's when the thread is one run and its
  // slot is the previous one's
  const int32_t prev_tail = __shfl_up_sync(FULL, tail_slot, 1);
  const int32_t next_head = __shfl_down_sync(FULL, head_slot, 1);
  Part<T> run = acc;
  bool head = multi || lane == 0 || head_slot != prev_tail;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Part<T> o = shfl_up(run, d);
    const bool oh = __shfl_up_sync(FULL, (int)head, d) != 0;
    if (lane >= d) {
      if (!head) run = combine(o, run);
      head = head || oh;
    }
  }
  const Part<T> run_prev = shfl_up(run, 1);
#if K1_STOP == 3
  if (run.c + run_prev.c + first.c == -12345) w.set(0, acc);
  return;
#endif

  // the first run where it ends here, joined to the previous thread's
  // last run where it continues it; the last run where it ends here
  const bool join = lane > 0 && prev_tail == head_slot;
  emit_into(w, multi && head_slot >= 0, head_slot,
            join ? combine(run_prev, first) : first, lane);
  emit_into(w, tail_slot >= 0 && (lane == 31 || next_head != tail_slot),
            tail_slot, run, lane);
}

template <typename T>
__global__ void __launch_bounds__(WARPS_MAX * 32)
segment_window(const T* __restrict__ values, const int8_t* __restrict__ valid,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ run_tile,
               const int32_t* __restrict__ run_base,
               const int64_t* __restrict__ slot_off,
               const int32_t* __restrict__ fold_pos,
               const int64_t* __restrict__ seg_start,
               int32_t* __restrict__ arrivals, int32_t* __restrict__ p_cnt,
               T* __restrict__ p_sum, T* __restrict__ p_min,
               T* __restrict__ p_max, int32_t* __restrict__ cnt,
               T* __restrict__ sum, T* __restrict__ mn, T* __restrict__ mx,
               int64_t n_rows, int64_t num_segments, int64_t span_max,
               int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t r = blockIdx.x;                 // this block's run
  const int64_t off = slot_off[r];
  const int span = (int)(slot_off[r + 1] - off);
  const int32_t base = run_base[r];
  const int64_t cap = (int64_t)warps * span_max;
  T* s_sum = reinterpret_cast<T*>(smem);
  T* s_lo = s_sum + cap;
  T* s_hi = s_lo + cap;
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_hi + cap);
  int32_t* done = s_cnt + cap;                  // [span]: this block folds
  const int64_t mine = (int64_t)warp * span;
  const Window<T> w{s_cnt + mine, s_sum + mine, s_lo + mine, s_hi + mine};

  for (int s = lane; s < span; s += 32) w.set(s, empty_part<T>());
  __syncwarp();
  const int64_t t_end = run_tile[r + 1];
  int64_t t = run_tile[r] + warp;
  for (; t < t_end; t += warps) {
    Rows<T> cur;
    load_rows(values, valid, seg, t * R_TILE + lane * RPT, n_rows, vec, cur);
    tile_into(w, cur, base, lane);
  }
  __syncthreads();

  // 4. the block partial of each slot, the warps' windows in warp order
  for (int s = threadIdx.x; s < span; s += blockDim.x) {
    Part<T> p = empty_part<T>();
    for (int k = 0; k < warps; ++k) {
      const int64_t i = (int64_t)k * span + s;
      p = combine(p, Part<T>{s_cnt[i], s_sum[i], s_lo[i], s_hi[i]});
    }
    const int64_t g = (int64_t)base + s;
    const int64_t lo = seg_start[g];
    const int64_t n_parts = seg_start[g + 1] - lo;
    int last = 0;
    if (n_parts == 1) {            // only this run covers g: final
      cnt[g] = p.c; sum[g] = p.s; mn[g] = p.lo; mx[g] = p.hi;
    } else {
      // the place keeps each segment's partials contiguous and in run
      // order, so the fold reads them without an indirection
      const int64_t q = fold_pos[off + s];
      __stcg(p_cnt + q, p.c);
      __stcg(p_sum + q, p.s);
      __stcg(p_min + q, p.lo);
      __stcg(p_max + q, p.hi);
      __threadfence();   // the partial is visible before the arrival is
      last = atomicAdd(arrivals + g, 1) == (int)n_parts - 1;
    }
    done[s] = last;
  }
  __syncthreads();
  __threadfence();

  // the segments this block completed: a warp each, lanes strided over
  // the partials in run order, then a fixed shuffle tree
  for (int s = warp; s < span; s += warps) {
    if (!done[s]) continue;
    const int64_t g = (int64_t)base + s;
    const int64_t lo = seg_start[g];
    const int64_t hi = seg_start[g + 1];
    Part<T> f = empty_part<T>();
#pragma unroll 4
    for (int64_t k = lo + lane; k < hi; k += 32)
      f = combine(f, Part<T>{__ldcg(p_cnt + k), __ldcg(p_sum + k),
                             __ldcg(p_min + k), __ldcg(p_max + k)});
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) f = combine(f, shfl_down(f, d));
    if (lane == 0) {
      cnt[g] = f.c; sum[g] = f.s; mn[g] = f.lo; mx[g] = f.hi;
      arrivals[g] = 0;   // the buffers may be launched over again
    }
  }

  // segments that no run covers: the empty result
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < num_segments; g += (int64_t)gridDim.x * blockDim.x) {
    if (seg_start[g + 1] == seg_start[g]) {
      cnt[g] = 0;
      sum[g] = T(0);
      mn[g] = Lim<T>::hi();
      mx[g] = Lim<T>::lo();
    }
  }
}

// Warps per block: as many as the run's tiles can use, up to WARPS_MAX,
// while a window per warp (28 B a slot) and the fold flags fit SMEM_MAX.
template <typename T>
int64_t block_smem(int64_t span_max, int* warps_out, int64_t n_tiles,
                   int64_t n_runs) {
  const int64_t per_warp = span_max * (3 * (int64_t)sizeof(T) + 4);
  int64_t warps = (SMEM_MAX - 4 * span_max) / per_warp;
  const int64_t cap = n_runs > 1 ? WARPS_MULTI : WARPS_MAX;
  warps = warps < cap ? warps : cap;
  warps = warps < n_tiles ? warps : n_tiles;
  warps = warps > 1 ? warps : 1;
  *warps_out = (int)warps;
  return warps * per_warp + 4 * span_max;
}

template <typename T>
int run(const void* values, const void* valid, const void* seg,
        const void* run_tile, const void* run_base, const void* slot_off,
        const void* fold_pos, const void* seg_start, void* arrivals,
        void* p_cnt, void* p_sum, void* p_min, void* p_max, void* cnt,
        void* sum, void* mn, void* mx, int64_t n_rows, int64_t n_runs,
        int64_t num_segments, int64_t span_max, int vec, void* stream) {
  if (n_runs <= 0 || span_max <= 0) return (int)cudaErrorInvalidValue;
  int warps = 1;
  const int64_t smem =
      block_smem<T>(span_max, &warps, (n_rows + R_TILE - 1) / R_TILE, n_runs);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_window<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  segment_window<T><<<(unsigned)n_runs, 32 * warps, (size_t)smem,
                      (cudaStream_t)stream>>>(
      (const T*)values, (const int8_t*)valid, (const int32_t*)seg,
      (const int32_t*)run_tile, (const int32_t*)run_base,
      (const int64_t*)slot_off, (const int32_t*)fold_pos,
      (const int64_t*)seg_start, (int32_t*)arrivals, (int32_t*)p_cnt,
      (T*)p_sum, (T*)p_min, (T*)p_max, (int32_t*)cnt, (T*)sum, (T*)mn,
      (T*)mx, n_rows, num_segments, span_max, vec);
  return (int)cudaGetLastError();
}

// The whole host-wrapper call as one C call: one host-to-device copy of
// the staged inputs, the launch, one device-to-host copy of the results
// (none when out_bytes is 0), and an event behind them for the caller to
// wait on. `off` holds the byte offsets of the 17 regions in the device
// buffer, in the order of the kernel's pointer arguments; rows already on
// the card come as `rows` (values, valid, segment ids), else null and
// staged.
template <typename T>
int call(const void* stage, void* dbuf, int64_t in_bytes, void* host_out,
         int64_t out_lo, int64_t out_bytes, const int64_t* off,
         const void* const* rows, int64_t n_rows, int64_t n_runs,
         int64_t num_segments, int64_t span_max, void* event, void* stream) {
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
  const int rc = run<T>(x, ok, sg, d + off[3], d + off[4], d + off[5],
                        d + off[6], d + off[7], d + off[8], d + off[9],
                        d + off[10], d + off[11], d + off[12], d + off[13],
                        d + off[14], d + off[15], d + off[16], n_rows, n_runs,
                        num_segments, span_max, vec, stream);
  if (rc != 0) return rc;
  if (out_bytes > 0) {
    e = cudaMemcpyAsync(host_out, d + out_lo, (size_t)out_bytes,
                        cudaMemcpyDeviceToHost, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaEventRecord((cudaEvent_t)event, st);
}

// Host work over n items in slices on up to 8 threads (the calling thread
// takes the first slice), a slice at least `grain` items: a big call's
// memory-bound passes, while the main path's few thousand rows stay on the
// calling thread.
template <typename F>
void host_parallel(int64_t n, int64_t grain, F f) {
  int64_t parts = (n + grain - 1) / grain;
  if (parts <= 1) {
    f(0, n);
    return;
  }
  // the core count reads a file: once per process, and never for the
  // main path's small calls
  static const int64_t hw = (int64_t)std::thread::hardware_concurrency();
  parts = parts < 8 ? parts : 8;
  parts = hw > 0 && parts > hw ? hw : parts;
  std::vector<std::thread> threads;
  for (int64_t i = 1; i < parts; ++i)
    threads.emplace_back(f, n * i / parts, n * (i + 1) / parts);
  f(0, n / parts);
  for (std::thread& t : threads) t.join();
}

constexpr int64_t HOST_GRAIN = 1 << 20;   // rows a host thread takes at least

}  // namespace

extern "C" {

// vec != 0 promises 16-byte aligned values and segment ids and 8-byte
// aligned valid flags; arrivals must be zero at the first launch (every
// launch leaves them zero again).
#define K1_ENTRY(NAME, T)                                                      \
  int NAME(const void* values, const void* valid, const void* seg,             \
           const void* run_tile, const void* run_base, const void* slot_off,   \
           const void* fold_pos, const void* seg_start, void* arrivals,        \
           void* p_cnt, void* p_sum, void* p_min, void* p_max, void* cnt,      \
           void* sum, void* mn, void* mx, int64_t n_rows, int64_t n_runs,      \
           int64_t num_segments, int64_t span_max, int vec, void* stream) {    \
    return run<T>(values, valid, seg, run_tile, run_base, slot_off, fold_pos, \
                  seg_start, arrivals, p_cnt, p_sum, p_min, p_max, cnt, sum,  \
                  mn, mx, n_rows, n_runs, num_segments, span_max, vec,        \
                  stream);                                                     \
  }
K1_ENTRY(segment_window_f64, double)
K1_ENTRY(segment_window_i64, long long)

#define K1_CALL(NAME, T)                                                       \
  int NAME(const void* stage, void* dbuf, int64_t in_bytes, void* host_out,    \
           int64_t out_lo, int64_t out_bytes, const int64_t* off,              \
           const void* const* rows, int64_t n_rows, int64_t n_runs,            \
           int64_t num_segments, int64_t span_max, void* event,                \
           void* stream) {                                                     \
    return call<T>(stage, dbuf, in_bytes, host_out, out_lo, out_bytes, off,   \
                   rows, n_rows, n_runs, num_segments, span_max, event,       \
                   stream);                                                    \
  }
K1_CALL(segment_window_call_f64, double)
K1_CALL(segment_window_call_i64, long long)

// ---- host half --------------------------------------------------------
// The same layout as the Python window_layout (which the CPU route and the
// tests use), without numpy's per-call overhead. Tile bounds and block runs
// of one call's segment ids: bases[t], the lowest id of tile t; run r
// covers tiles [run_tile[r], run_tile[r + 1]) and the segment ids
// [run_base[r], run_base[r] + slot_off[r + 1] - slot_off[r]), its partial
// slots starting at slot_off[r]. A run takes the next tile while it has
// fewer than t_run tiles and its union span stays within w_win. Every
// array holds tiles (+ 1) entries; stats gets the slot count and the widest
// run's span. → the run count; -1 when a tile spans w_win or more segments
// (the layout declines), -2 when an id lies outside [0, num_segments).
int64_t segment_window_bounds(const int32_t* seg, int64_t n,
                              int64_t num_segments, int64_t w_win,
                              int64_t t_run, int32_t* bases,
                              int32_t* run_tile, int32_t* run_base,
                              int64_t* slot_off, int64_t* stats) {
  const int64_t tiles = (n + R_TILE - 1) / R_TILE;
  std::vector<int32_t> tops((size_t)tiles);
  host_parallel(tiles, HOST_GRAIN / R_TILE, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t end = (t + 1) * R_TILE < n ? (t + 1) * R_TILE : n;
      int32_t lo = seg[t * R_TILE], hi = lo;
      for (int64_t r = t * R_TILE + 1; r < end; ++r) {
        lo = seg[r] < lo ? seg[r] : lo;
        hi = seg[r] > hi ? seg[r] : hi;
      }
      bases[t] = lo;
      tops[t] = hi;
    }
  });
  int32_t lo_all = INT32_MAX, hi_all = INT32_MIN;
  bool wide = false;
  int64_t runs = 0, in_run = 0;
  int32_t r_lo = 0, r_hi = 0;
  slot_off[0] = 0;
  for (int64_t t = 0; t < tiles; ++t) {
    const int32_t lo = bases[t], hi = tops[t];
    wide |= (int64_t)hi - lo >= w_win;
    lo_all = lo < lo_all ? lo : lo_all;
    hi_all = hi > hi_all ? hi : hi_all;
    const int32_t u_lo = lo < r_lo ? lo : r_lo;
    const int32_t u_hi = hi > r_hi ? hi : r_hi;
    if (in_run > 0 && in_run < t_run && (int64_t)u_hi - u_lo < w_win) {
      r_lo = u_lo;
      r_hi = u_hi;
      ++in_run;
      continue;
    }
    if (in_run > 0) {   // close the run before t
      run_base[runs] = r_lo;
      slot_off[runs + 1] = slot_off[runs] + ((int64_t)r_hi - r_lo + 1);
      ++runs;
    }
    run_tile[runs] = (int32_t)t;
    r_lo = lo;
    r_hi = hi;
    in_run = 1;
  }
  if (in_run > 0) {
    run_base[runs] = r_lo;
    slot_off[runs + 1] = slot_off[runs] + ((int64_t)r_hi - r_lo + 1);
    ++runs;
  }
  run_tile[runs] = (int32_t)tiles;
  stats[0] = slot_off[runs];
  stats[1] = 0;
  for (int64_t r = 0; r < runs; ++r) {
    const int64_t span = slot_off[r + 1] - slot_off[r];
    stats[1] = span > stats[1] ? span : stats[1];
  }
  if (wide) return -1;
  if (lo_all < 0 || hi_all >= num_segments) return -2;
  return runs;
}

// Fill the input regions of a staging buffer: the rows, the runs, each
// slot's fold place and seg_start (a counting sort of the slots by segment
// that keeps run order), and zeroed arrival counters. off holds the byte
// offsets of values, valid, seg_ids, run_tile, run_base, slot_off,
// fold_pos, seg_start and arrivals (the arrival region serves as the
// sort's cursor first).
void segment_window_pack(void* stage, const int64_t* off, const void* values,
                         const void* valid, const int32_t* seg, int64_t n,
                         const int32_t* run_tile, const int32_t* run_base,
                         const int64_t* slot_off, int64_t runs,
                         int64_t num_segments) {
  char* b = (char*)stage;
  host_parallel(n, HOST_GRAIN, [&](int64_t r0, int64_t r1) {
    memcpy(b + off[0] + r0 * 8, (const char*)values + r0 * 8,
           (size_t)(r1 - r0) * 8);
    memcpy(b + off[1] + r0, (const char*)valid + r0, (size_t)(r1 - r0));
    memcpy(b + off[2] + r0 * 4, (const char*)seg + r0 * 4,
           (size_t)(r1 - r0) * 4);
  });
  memcpy(b + off[3], run_tile, (size_t)(runs + 1) * 4);
  memcpy(b + off[4], run_base, (size_t)runs * 4);
  memcpy(b + off[5], slot_off, (size_t)(runs + 1) * 8);
  int32_t* fold_pos = (int32_t*)(b + off[6]);
  int64_t* seg_start = (int64_t*)(b + off[7]);
  int32_t* cursor = (int32_t*)(b + off[8]);
  memset(seg_start, 0, (size_t)(num_segments + 1) * 8);
  for (int64_t r = 0; r < runs; ++r)
    for (int64_t g = run_base[r];
         g < run_base[r] + (slot_off[r + 1] - slot_off[r]); ++g)
      ++seg_start[g + 1];
  for (int64_t g = 0; g < num_segments; ++g) seg_start[g + 1] += seg_start[g];
  memset(cursor, 0, (size_t)num_segments * 4);
  for (int64_t r = 0; r < runs; ++r) {
    const int64_t span = slot_off[r + 1] - slot_off[r];
    for (int64_t s = 0; s < span; ++s) {
      const int64_t g = run_base[r] + s;
      fold_pos[slot_off[r] + s] = (int32_t)(seg_start[g] + cursor[g]++);
    }
  }
  memset(cursor, 0, (size_t)num_segments * 4);
}
// ---- end of host half -------------------------------------------------

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
