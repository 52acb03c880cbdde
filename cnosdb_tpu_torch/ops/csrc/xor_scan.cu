// K2: inclusive prefix-XOR along each row of a [rows, L] u64 matrix — the
// scan that turns Gorilla XOR-delta words back into f64 bit patterns —
// and the whole Gorilla f64 decode (byte planes -> words -> scan) as one
// kernel.
//
// Replaces the Pallas kernel cnosdb_tpu/ops/device_decode.py::
// _make_xor_scan_body (launched by _pallas_xor_scan), and the XLA plane
// assembly around it (_gorilla_xla_kernel / _assemble_planes). The TPU
// version ran a log-step Hillis-Steele scan over u32 lanes, twice (lo and
// hi halves), because the TPU vector unit has no 64-bit lanes; XOR is
// bitwise, so the split was exact but is not needed here: this kernel
// scans native u64.
//
// Bound on this card: bytes. The decode must read the 8 byte planes once
// (8 B per word) and write the f64 bits once (8 B per word); the scan
// alone reads and writes 8 B per word each way. There is one XOR per word
// on the critical path and a few byte permutes, far below the byte bound.
//
// Design, against that bound:
//   - Fill the card: each row is cut into 4096-word chunks, so
//     [32, 131072] is 1024 chunks instead of 32 rows. The grid is as many
//     blocks as fit on the card at once (occupancy query), and each block
//     takes chunks until none are left, so no tail wave idles SMs.
//   - One pass (chained scan with decoupled look-back): a block scans its
//     chunk in registers, publishes the chunk's XOR aggregate, then its
//     first warp walks back over its predecessors' published aggregates,
//     32 at a time, until it meets an inclusive prefix, and publishes its
//     own inclusive prefix. Every word
//     crosses device memory once in and once out (16 B per word, the
//     bound), where a reduce-then-scan would read the input twice.
//   - No deadlock: blocks take their chunks from an atomic ticket, not
//     from blockIdx, so a block only ever waits on chunks with lower
//     tickets, which blocks already running hold and finish without
//     waiting on it.
//   - Publishing: the u64 aggregate uses its whole word, so it sits
//     behind a separate status word (0 none, 1 aggregate, 2 inclusive),
//     stored with st.release and read with ld.acquire at GPU scope.
//   - Reset: the ticket and the status words live in a scratch buffer the
//     entry point zeroes with cudaMemsetAsync on the launch's own stream,
//     so every launch starts clean and launches on one stream cannot see
//     each other's state.
//   - Loads: the Gorilla loader gives each thread 16 consecutive words; it
//     makes one 16-byte load from each of the 8 planes (neighbouring
//     threads on neighbouring addresses) and assembles the words in
//     registers with byte permutes. The u64 loader and the store go
//     through shared memory so that a warp touches contiguous addresses.
// XOR has no rounding, so the result is bit-exact whatever the order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                 // consecutive words per thread
constexpr int CHUNK = THREADS * ITEMS;    // words per block
constexpr int WARPS = THREADS / 32;
constexpr int PAD = ITEMS + 1;            // shared-memory row stride

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Words [i0, i0 + 16) of one row of [B, 8, L] u8 planes into w.
__device__ __forceinline__ void load_planes(const uint8_t* p, int64_t L,
                                            int64_t i0, int64_t here,
                                            bool vec, u64 (&w)[ITEMS]) {
  if (vec && i0 + ITEMS <= here) {
    unsigned a[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p + k * L + i0));
      a[k][0] = q.x; a[k][1] = q.y; a[k][2] = q.z; a[k][3] = q.w;
    }
    // a[k][g] holds byte k of words 4g..4g+3; transpose each 4x4 block
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      unsigned half[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned x0 = a[4 * h][g], x1 = a[4 * h + 1][g];
        const unsigned x2 = a[4 * h + 2][g], x3 = a[4 * h + 3][g];
        const unsigned t0 = __byte_perm(x0, x1, 0x5140);
        const unsigned t1 = __byte_perm(x2, x3, 0x5140);
        const unsigned t2 = __byte_perm(x0, x1, 0x7362);
        const unsigned t3 = __byte_perm(x2, x3, 0x7362);
        half[h][0] = __byte_perm(t0, t1, 0x5410);
        half[h][1] = __byte_perm(t0, t1, 0x7632);
        half[h][2] = __byte_perm(t2, t3, 0x5410);
        half[h][3] = __byte_perm(t2, t3, 0x7632);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        w[4 * g + m] = (u64)half[0][m] | ((u64)half[1][m] << 32);
    }
    return;
  }
  // ragged or unaligned: byte loads, zero past the row
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    u64 x = 0;
    if (i0 + j < here) {
#pragma unroll
      for (int k = 0; k < 8; ++k) x |= (u64)p[k * L + i0 + j] << (8 * k);
    }
    w[j] = x;
  }
}

// At most 64 registers a thread (no spills), so 4 blocks fit an SM
// instead of 3: more loads in flight while other blocks scan or look back.
template <bool PLANES>
__global__ void __launch_bounds__(THREADS, 4)
xor_scan_chunks(const void* __restrict__ in, u64* __restrict__ out,
                u64* __restrict__ state, int64_t L, int64_t chunks_per_row,
                int64_t n_chunks, int vec) {
  __shared__ u64 tile[THREADS * PAD];
  __shared__ u64 warp_tot[WARPS];
  __shared__ u64 s_prefix;
  __shared__ int64_t s_ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t i0 = (int64_t)tid * ITEMS;
  for (;;) {
    if (tid == 0) s_ticket = (int64_t)atomicAdd(state, 1ULL);
    __syncthreads();
    const int64_t v = s_ticket;
    if (v >= n_chunks) break;
    const int64_t row = v / chunks_per_row;
    const int64_t start = (v - row * chunks_per_row) * CHUNK;
    const int64_t here = min((int64_t)CHUNK, L - start);

    u64 w[ITEMS];
    if (PLANES) {
      load_planes(static_cast<const uint8_t*>(in) + row * 8 * L + start, L,
                  i0, here, vec != 0, w);
    } else {
      const u64* x = static_cast<const u64*>(in) + row * L + start;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int j = it * THREADS + tid;
        tile[(j / ITEMS) * PAD + (j % ITEMS)] =
            (j < here) ? __ldcs(x + j) : 0ULL;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) w[k] = tile[tid * PAD + k];
    }

    // inclusive scan: the thread's words, then thread totals in the warp
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) w[k] ^= w[k - 1];
    const u64 t = w[ITEMS - 1];
    u64 inc = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 n = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc ^= n;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();   // also: every thread has read its words out of tile
    u64 excl = inc ^ t;   // XOR of the chunk's words before this thread
    u64 chunk_tot = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const u64 x = warp_tot[k];
      if (k < warp) excl ^= x;
      chunk_tot ^= x;
    }

    if (warp == 0) {
      u64* flag = state + 1;
      u64* agg = flag + n_chunks;
      u64* incl = agg + n_chunks;
      u64 prefix = 0;
      if (start != 0) {
        if (lane == 0) {
          __stcg(agg + v, chunk_tot);
          st_release(flag + v, 1ULL);
        }
        // look back over 32 predecessors at once, one per lane, until the
        // nearest one with an inclusive prefix; a row's first chunk
        // publishes one at once, so the walk ends inside the row
        const int64_t row_first = v - start / CHUNK;
        for (int64_t top = v - 1;; top -= 32) {
          const int64_t p = top - lane;
          u64 f = 3;   // before the row: never read, past the stop
          if (p >= row_first) {
            do {
              f = ld_acquire(flag + p);
            } while (f == 0);
          }
          const unsigned stop = __ballot_sync(0xffffffffu, f >= 2);
          const int first = stop ? __ffs(stop) - 1 : 32;
          u64 x = 0;
          if (lane < first) x = __ldcg(agg + p);
          else if (lane == first) x = __ldcg(incl + p);
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            x ^= __shfl_xor_sync(0xffffffffu, x, d);
          prefix ^= x;
          if (stop) break;
        }
      }
      if (lane == 0) {
        __stcg(incl + v, prefix ^ chunk_tot);
        st_release(flag + v, 2ULL);
        s_prefix = prefix;
      }
    }
    __syncthreads();
    const u64 add = s_prefix ^ excl;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) tile[tid * PAD + k] = w[k] ^ add;
    __syncthreads();
    u64* y = out + row * L + start;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = it * THREADS + tid;
      if (j < here) __stcs(y + j, tile[(j / ITEMS) * PAD + (j % ITEMS)]);
    }
    __syncthreads();   // tile and s_ticket are rewritten by the next chunk
  }
}

int64_t chunks(int64_t rows, int64_t L) {
  return rows * ((L + CHUNK - 1) / CHUNK);
}

template <bool PLANES>
int launch(const void* in, void* out, void* state, int64_t rows, int64_t L,
           int vec, void* stream) {
  if (rows <= 0 || L <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = chunks(rows, L);
  cudaError_t e = cudaMemsetAsync(state, 0, (size_t)(1 + 3 * n) * sizeof(u64),
                                  st);
  if (e != cudaSuccess) return (int)e;
  // persistent: as many blocks as fit on the card at once, each taking
  // chunks by ticket until none are left (no tail wave of idle SMs)
  static const int resident = [] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, xor_scan_chunks<PLANES>, THREADS, 0);
    return sms * (per > 0 ? per : 1);
  }();
  const int64_t grid = n < resident ? n : resident;
  xor_scan_chunks<PLANES><<<(unsigned)grid, THREADS, 0, st>>>(
      in, (u64*)out, (u64*)state, L, (L + CHUNK - 1) / CHUNK, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u64 words of the scratch buffer a launch over [rows, L] needs
int64_t xor_scan_state_words(int64_t rows, int64_t L) {
  return 1 + 3 * chunks(rows, L);
}

int xor_scan_u64(const void* in, void* out, void* state, int64_t rows,
                 int64_t L, void* stream) {
  return launch<false>(in, out, state, rows, L, 0, stream);
}

// planes: [rows, 8, L] u8 (plane k = byte k of each u64, little endian)
int gorilla_decode_u8(const void* planes, void* out, void* state,
                      int64_t rows, int64_t L, void* stream) {
  const int vec = (L % 16 == 0) && ((uintptr_t)planes % 16 == 0);
  return launch<true>(planes, out, state, rows, L, vec, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
