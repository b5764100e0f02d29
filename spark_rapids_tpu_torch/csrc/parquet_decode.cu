// Device Parquet decode: the four value-expansion kernels of the scan.
//
// Replaces the TPU kernels of spark_rapids_tpu/ops/pallas_kernels.py:
//   B5 _hybrid_expand_kernel (:929), launched by _hybrid_expand_pallas
//      (:956); public entry hybrid_expand (:966);
//   B6 _delta_unpack_kernel (:999), launched by _delta_unpack_pallas
//      (:1028); public entry delta_unpack (:1038);
//   B7 _plain_fixed_kernel (:1075), launched by _plain_fixed_pallas
//      (:1102); public entry plain_fixed (:1111);
//   B8 _slab_pack_kernel (:1140), launched by _slab_pack_pallas (:1164);
//      public entry slab_pack (:1174).
//
// The TPU kernels walk one scalar cursor over the output on a one-step grid
// (fori_loop over every element, a run or miniblock cursor carried in the
// loop state, a running sum for DELTA). None of that carries over: here
// every output element finds its run by a search over the run starts, and
// DELTA's running sum is a tiled segmented scan.
//   * B5 hybrid_expand: one launch expands all the hybrid streams of a row
//     group (definition levels and dictionary codes; up to 32 streams, their
//     descriptors passed by value in the kernel's parameters, each block
//     finding its stream from their first blocks). A block takes a tile of
//     4096 outputs of one stream: the whole block searches the runs of the
//     tile's first and last outputs (searchsorted(out_start, k, right) - 1
//     clipped to the guard row) in two rounds of one load a thread, stages
//     the runs between them in shared memory, and each thread finds its
//     outputs' runs in that window (a binary search for the first of four
//     outputs, a step for the next). A bit-packed run extracts bw bits
//     from the u64 window of two adjacent u32 words at bit_start + (k -
//     out_start) * bw, an RLE run writes its value; each thread stores four
//     consecutive outputs as one 16-byte store, a warp 512 contiguous
//     bytes. A Q1 row group's 13 streams are 13 x 2^20 outputs, ~56 MB of
//     writes (~17 us at 3.35 TB/s): one launch per stream cost its dispatch
//     each, one per row group pays it once.
//   * B6 delta_unpack: one launch decodes all the DELTA_BINARY_PACKED
//     column chunks of a row group (up to 32, descriptors by value as in
//     B5), each chunk's pages as segments: element k is its page's head
//     (the page's first value) or raw + min_delta of its miniblock (u64
//     arithmetic), and each page is a running sum of its elements. A block
//     takes a tile of 2048 elements in ticket order (an atomic counter, so
//     a tile only ever waits on tiles already running), stages the tile's
//     pages and miniblocks in shared memory after two block-wide searches,
//     and scans its elements with the segmented operator
//     (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2). The carry across
//     tiles is a single-pass decoupled look-back: each tile publishes its
//     aggregate, then its inclusive prefix, in one 16-byte {status, value}
//     word of a state array kept per stream, each word tagged with its
//     launch's epoch so that no launch clears it; a tile that starts on a
//     page head, or a chunk's first tile, needs no carry. The outputs go
//     out through shared memory, 16 bytes a thread at consecutive
//     addresses. Sums wrap in 64 bits, as the jnp twin's int64 cumsum.
//   * B7 plain_fixed: one launch decodes all the PLAIN fixed-width streams
//     of a row group (up to 32 segments, their descriptors passed by value
//     in the kernel's parameters). PLAIN i32/f32/i64/f64 is a byte copy of
//     the first m * width bytes of the words, so each thread copies 16-byte
//     chunks of the outputs laid end to end: one 16-byte load and store
//     where source and output are 16-byte aligned (upload_arrays aligns
//     every source; each output is its own allocation), word by word in
//     the ragged tail and for unaligned sources. A bool is bit k & 31 of word min(k >> 5, nwords - 1); a
//     chunk's 16 bools share one word. The stream's bytes are few (16 MB at
//     a row group's 2^20 float64 values: ~5 us at 3.35 TB/s), so one launch
//     per stream cost its dispatch, not its bytes: one launch per row group
//     pays it once.
//   * B8 slab_pack: one thread per output word (row r, word w): the 8 bytes
//     at chars[starts[r] + 8w ...], zero at and past lens[r], packed
//     little-endian (byte j at bit 8j), as columnar.column.np_build_slab.
// Every index is clipped exactly as the jnp twins clip, so padding rows and
// guard rows give the twins' values bit for bit.
// What bounds them on an H100: bytes. Each reads its packed input once and
// writes its output once; the run, miniblock and page tables are small and
// stay in L1/L2 across the binary searches. At 2^20 outputs every kernel
// is a few microseconds, so launch latency is a large share of its time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks an SM
constexpr int kDeltaItems = 8;        // elements per thread in a B6 tile
constexpr int kDeltaTile = kThreads * kDeltaItems;
constexpr int kDeltaWindow = 256;  // B6 pages, miniblocks staged a block
constexpr int kMaxDeltaChunks = 32;  // B6 column chunks per launch
constexpr int kMaxPlainSegments = 32;  // B7 streams per launch
constexpr int kMaxHybridStreams = 32;  // B5 streams per launch
constexpr int kHybridVec = 4;          // B5: outputs per 16-byte store
constexpr int kHybridPasses = 4;       // B5: 16-byte stores a thread
constexpr int kHybridTile = kThreads * kHybridVec * kHybridPasses;
constexpr int kRunWindow = 512;  // B5 runs a block stages in shared memory
constexpr int kCopyChunksPerThread = 4;  // B7: 16-byte chunks a thread
constexpr int kCopyBlockChunks = kThreads * kCopyChunksPerThread;

int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// Index of the first entry of sorted a[0..len) greater than x, as
// searchsorted(a, x, side="right").
__device__ __forceinline__ int upper_bound(const int* __restrict__ a,
                                           int len, long long x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (static_cast<long long>(a[mid]) <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// upper_bound(a, len, x0) and upper_bound(a, len, x1) found by the whole
// block at once: each round every thread tests the last entry of one of
// kThreads chunks and __syncthreads_count counts the chunks at or below x;
// the answer then lies in the first chunk that is not, minus its tested
// entry. Two rounds settle ~65,000 entries. Every thread of the block must
// call it, and gets both answers.
__device__ __forceinline__ void block_upper_bounds(const int* __restrict__ a,
                                                   int len, long long x0,
                                                   long long x1, int* u0,
                                                   int* u1) {
  int lo0 = 0, n0 = len, lo1 = 0, n1 = len;
  while (n0 > 0 || n1 > 0) {
    const int s0 = (n0 + kThreads - 1) / kThreads;
    const int s1 = (n1 + kThreads - 1) / kThreads;
    const int p0 = lo0 + (static_cast<int>(threadIdx.x) + 1) * s0 - 1;
    const int p1 = lo1 + (static_cast<int>(threadIdx.x) + 1) * s1 - 1;
    const int c0 = __syncthreads_count(p0 < lo0 + n0 && a[p0] <= x0);
    const int c1 = __syncthreads_count(p1 < lo1 + n1 && a[p1] <= x1);
    const int e0 = lo0 + n0, e1 = lo1 + n1;
    lo0 += c0 * s0;
    lo1 += c1 * s1;
    n0 = max(0, min(s0 - 1, e0 - lo0));
    n1 = max(0, min(s1 - 1, e1 - lo1));
  }
  *u0 = lo0;
  *u1 = lo1;
}

__device__ __forceinline__ int clip_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// bw bits at absolute bit position `bit` of the u32 word stream (the jnp
// twins' _extract_bits: negative bits clip to 0, word indices to the
// stream, the window is words[w] | words[w + 1] << 32).
__device__ __forceinline__ unsigned long long extract_bits(
    const uint32_t* __restrict__ words, long long nwords, long long bit,
    int bw) {
  if (bit < 0) bit = 0;
  const long long top = nwords - 1;
  long long w = static_cast<long long>(static_cast<int>(bit >> 5));
  w = w < 0 ? 0 : (w > top ? top : w);
  long long w1 = w + 1 > top ? top : w + 1;
  unsigned long long window =
      static_cast<unsigned long long>(words[w]) |
      (static_cast<unsigned long long>(words[w1]) << 32);
  const unsigned off = static_cast<unsigned>(bit & 31);
  const unsigned long long ubw = static_cast<unsigned long long>(
      static_cast<long long>(bw));
  const unsigned long long mask = ubw >= 64 ? ~0ull : (1ull << ubw) - 1ull;
  return (window >> off) & mask;
}

// ---------------------------------------------------------------------------
// B5: RLE/bit-packed hybrid expansion
// ---------------------------------------------------------------------------

// One stream of a hybrid_expand_many launch. Its blocks are
// [block0, block0 + ceil(n / kHybridTile)) of the grid.
struct HybridSeg {
  const uint32_t* words;
  const int* out_start;  // nstarts entries: the runs', the guard row's, max
  const uint8_t* kind;   // nruns rows each, the guard row last
  const int* value;
  const long long* bit_start;
  const int* bw;
  int* out;
  long long nwords;
  int nstarts;
  int nruns;
  int n;
  int block0;
};

struct HybridBatch {
  HybridSeg seg[kMaxHybridStreams];
  int nseg;
};

__global__ void __launch_bounds__(kThreads) hybrid_expand_many_kernel(
    const __grid_constant__ HybridBatch b) {
  __shared__ int w_start[kRunWindow];
  __shared__ long long w_bit[kRunWindow];
  __shared__ int w_value[kRunWindow];
  __shared__ int w_bw[kRunWindow];
  __shared__ uint8_t w_kind[kRunWindow];
  int s = 0;  // the block's stream: the last whose first block is <= it
  for (int i = 1; i < b.nseg; ++i) {
    if (b.seg[i].block0 <= static_cast<int>(blockIdx.x)) s = i;
  }
  const HybridSeg& g = b.seg[s];
  const long long t0 =
      static_cast<long long>(static_cast<int>(blockIdx.x) - g.block0) *
      kHybridTile;
  // past the tile's last output
  const long long t1 = min(t0 + kHybridTile, static_cast<long long>(g.n));
  // the runs of the tile's first and last outputs
  int u0, u1;
  block_upper_bounds(g.out_start, g.nstarts, t0, t1 - 1, &u0, &u1);
  const int r0 = clip_int(u0 - 1, 0, g.nruns - 1);
  const int nwin = clip_int(u1 - 1, 0, g.nruns - 1) - r0 + 1;
  // the window: shared memory where it fits, else the arrays themselves
  const int* starts = g.out_start + r0;
  const uint8_t* kinds = g.kind + r0;
  const int* values = g.value + r0;
  const long long* bits = g.bit_start + r0;
  const int* widths = g.bw + r0;
  if (nwin <= kRunWindow) {
    for (int j = threadIdx.x; j < nwin; j += kThreads) {
      w_start[j] = starts[j];
      w_kind[j] = kinds[j];
      w_value[j] = values[j];
      w_bit[j] = bits[j];
      w_bw[j] = widths[j];
    }
    starts = w_start;
    kinds = w_kind;
    values = w_value;
    bits = w_bit;
    widths = w_bw;
    __syncthreads();
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(g.out) & 15) == 0;
#pragma unroll
  for (int pass = 0; pass < kHybridPasses; ++pass) {
    const long long k0 =
        t0 + (pass * kThreads + static_cast<int>(threadIdx.x)) * kHybridVec;
    if (k0 >= t1) break;
    // the window's last run whose start is <= k0 (starts[1..nwin) sorted)
    int j = upper_bound(starts + 1, nwin - 1, k0);
    int v[kHybridVec];
#pragma unroll
    for (int q = 0; q < kHybridVec; ++q) {
      const long long k = k0 + q;
      while (j + 1 < nwin && starts[j + 1] <= k) ++j;
      if (kinds[j] == 1) {
        // (k - out_start[r]) in int32, as the twin subtracts int32 arrays
        const int rel = static_cast<int>(static_cast<unsigned>(k) -
                                         static_cast<unsigned>(starts[j]));
        const long long bit =
            bits[j] + static_cast<long long>(rel) * widths[j];
        v[q] = static_cast<int>(static_cast<uint32_t>(
            extract_bits(g.words, g.nwords, bit, widths[j])));
      } else {
        v[q] = values[j];
      }
    }
    if (aligned && k0 + kHybridVec <= t1) {
      *reinterpret_cast<int4*>(g.out + k0) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kHybridVec; ++q) {
        if (k0 + q < t1) g.out[k0 + q] = v[q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B6: DELTA_BINARY_PACKED, one launch for a row group's chunks
// ---------------------------------------------------------------------------

struct Seg {
  unsigned long long v;
  int f;  // 1 when a page head lies in the span
};

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {
  Seg out;
  out.v = b.f ? b.v : a.v + b.v;
  out.f = a.f | b.f;
  return out;
}

__device__ __forceinline__ Seg seg_shfl_up(Seg s, int o) {
  Seg out;
  out.v = __shfl_up_sync(0xffffffffu, s.v, o);
  out.f = __shfl_up_sync(0xffffffffu, s.f, o);
  return out;
}

// Exclusive segmented scan of one Seg per thread across the block; the
// block's total goes to *total for every thread.
template <int THREADS>
__device__ Seg block_exclusive_seg_scan(Seg x, Seg* total) {
  constexpr int kWarps = THREADS / 32;
  __shared__ unsigned long long warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  __shared__ Seg block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Seg identity = {0ull, 0};
  Seg incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Seg y = seg_shfl_up(incl, o);
    if (lane >= o) incl = seg_combine(y, incl);
  }
  Seg ex_lane = seg_shfl_up(incl, 1);
  if (lane == 0) ex_lane = identity;
  if (lane == 31) {
    warp_v[warp] = incl.v;
    warp_f[warp] = incl.f;
  }
  __syncthreads();
  if (warp == 0) {
    Seg w = identity;
    if (lane < kWarps) {
      w.v = warp_v[lane];
      w.f = warp_f[lane];
    }
    Seg wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Seg y = seg_shfl_up(wi, o);
      if (lane >= o) wi = seg_combine(y, wi);
    }
    Seg we = seg_shfl_up(wi, 1);
    if (lane == 0) we = identity;
    if (lane < kWarps) {
      warp_v[lane] = we.v;
      warp_f[lane] = we.f;
    }
    if (lane == 31) block_total = wi;
  }
  __syncthreads();
  Seg warp_prefix;
  warp_prefix.v = warp_v[warp];
  warp_prefix.f = warp_f[warp];
  Seg ex = seg_combine(warp_prefix, ex_lane);
  *total = block_total;
  __syncthreads();  // the shared arrays may be reused by the next call
  return ex;
}

// One DELTA column chunk of a delta_unpack_many launch. Its tiles are
// [tile0, tile0 + ceil(n / kDeltaTile)) of the launch's ticket order.
struct DeltaSeg {
  const uint32_t* words;
  const int* mstart;            // nmini rows, the guard row last
  const int* mbw;
  const long long* min_delta;
  const long long* bit_start;
  const int* page_start;        // npages + 1 entries, the last n
  const long long* first;       // npages
  long long* out;
  long long nwords;
  int nmini;
  int npages;
  int n;
  int tile0;
};

struct DeltaBatch {
  DeltaSeg seg[kMaxDeltaChunks];
  int nseg;
  int ntiles;
};

// A tile's published state, one 16-byte word {epoch << 2 | status, value}
// stored and loaded whole (16-byte accesses to one aligned word are single
// transactions, the property CUB's look-back scan rests on). The states
// persist from launch to launch; a word of an earlier launch's epoch reads
// as not yet published. kAggregate: value is the tile's own sum since its
// start, no page head in the tile; kPrefix: value is the running sum
// through the tile's last element (an inclusive prefix, or the aggregate
// of a tile that holds a page head, the same thing for the segmented
// operator).
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kPrefix = 2;

__device__ __forceinline__ void store_state(unsigned long long* p,
                                            unsigned long long status,
                                            unsigned long long value) {
  asm volatile("st.global.cg.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(status),
               "l"(value)
               : "memory");
}

__device__ __forceinline__ void load_state(const unsigned long long* p,
                                           unsigned long long* status,
                                           unsigned long long* value) {
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
               : "=l"(*status), "=l"(*value)
               : "l"(p)
               : "memory");
}

// The exclusive prefix of tile `tile` (segment tiles [tile0, tile)): one
// warp reads the states of the 32 tiles before it, waits until all have
// published, and combines them back to the nearest kPrefix; where none of
// the 32 has one it carries their sum and reads the next 32.
__device__ __forceinline__ unsigned long long state_status(
    unsigned long long word, unsigned long long epoch) {
  return (word >> 2) == epoch ? (word & 3) : 0;
}

__device__ Seg look_back(const unsigned long long* states, int tile,
                         int tile0, unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  unsigned long long acc = 0;  // the sum of the windows already read
  int hi = tile - 1;           // the window's latest tile
  while (true) {
    const int p = hi - lane;
    // lanes before the chunk's first tile read as a kPrefix of 0
    unsigned long long status = kPrefix, value = 0, word;
    if (p >= tile0) {
      load_state(states + 2 * static_cast<long long>(p), &word, &value);
      status = state_status(word, epoch);
    }
    while (__any_sync(0xffffffffu, status == 0)) {
      if (status == 0) {
        load_state(states + 2 * static_cast<long long>(p), &word, &value);
        status = state_status(word, epoch);
      }
    }
    const unsigned done = __ballot_sync(0xffffffffu, status == kPrefix);
    const int stop = done ? __ffs(done) - 1 : 32;
    // sum the window's lanes 0..stop (lane `stop` the earliest tile)
    Seg x;
    x.v = lane <= stop ? value : 0ull;
    x.f = lane == stop ? 1 : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Seg y;
      y.v = __shfl_down_sync(0xffffffffu, x.v, o);
      y.f = __shfl_down_sync(0xffffffffu, x.f, o);
      if (lane + o < 32) x = seg_combine(y, x);
    }
    const unsigned long long total = __shfl_sync(0xffffffffu, x.v, 0);
    acc += total;
    if (stop < 32) break;
    hi -= 32;
  }
  Seg out;
  out.v = acc;
  out.f = 1;
  return out;
}

// One tile of kDeltaTile elements of one chunk a block, tiles taken in
// ticket order. The block finds the pages and miniblocks its elements fall
// in with two block-wide searches, stages them in shared memory, and each
// thread decodes its kDeltaItems consecutive elements stepping through
// that window: element k is its page's first value at a page head, else
// raw + min_delta of its miniblock (u64 arithmetic). A segmented scan of
// the tile, then the tile's exclusive prefix from look_back, gives every
// element's running sum since its page head. The block stages its 16 KB
// of outputs in shared memory and writes them with 16-byte stores of
// consecutive addresses across each warp (a thread's own eight outputs lie
// 64 bytes from its neighbours'). scratch: the ticket (reset by the block
// that draws the launch's last one), a pad word, then a state a tile;
// epoch: this launch's, greater than any earlier launch's on the scratch.
__global__ void __launch_bounds__(kThreads) delta_unpack_many_kernel(
    const __grid_constant__ DeltaBatch b, unsigned long long* scratch,
    unsigned long long epoch) {
  __shared__ int s_tile;
  __shared__ Seg s_prefix;
  __shared__ longlong2 s_pairs[kDeltaTile / 2];
  __shared__ int w_mstart[kDeltaWindow];
  __shared__ int w_mbw[kDeltaWindow];
  __shared__ long long w_mind[kDeltaWindow];
  __shared__ long long w_mbit[kDeltaWindow];
  __shared__ int w_pstart[kDeltaWindow];
  __shared__ long long w_first[kDeltaWindow];
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
    // every other block has drawn its ticket: clear it for the next launch
    if (t == b.ntiles - 1) {
      atomicExch(reinterpret_cast<unsigned*>(scratch), 0u);
    }
    s_tile = t;
  }
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* states = scratch + 2;
  int s = 0;  // the tile's chunk: the last whose first tile is <= it
  for (int i = 1; i < b.nseg; ++i) {
    if (b.seg[i].tile0 <= tile) s = i;
  }
  const DeltaSeg& g = b.seg[s];
  const long long t0 = static_cast<long long>(tile - g.tile0) * kDeltaTile;
  const long long t1 = min(t0 + kDeltaTile, static_cast<long long>(g.n));

  // the pages and miniblocks of the tile's first and last elements
  int u0, u1, v0, v1;
  block_upper_bounds(g.page_start, g.npages + 1, t0, t1 - 1, &u0, &u1);
  block_upper_bounds(g.mstart, g.nmini, t0, t1 - 1, &v0, &v1);
  const int j0 = clip_int(u0 - 1, 0, g.npages - 1);
  const int npw = clip_int(u1 - 1, 0, g.npages - 1) - j0 + 1;
  const int m0 = clip_int(v0 - 1, 0, g.nmini - 1);
  const int nmw = clip_int(v1 - 1, 0, g.nmini - 1) - m0 + 1;
  const int* pstart = g.page_start + j0;
  const long long* pfirst = g.first + j0;
  const int* mstart = g.mstart + m0;
  const int* mbw = g.mbw + m0;
  const long long* mind = g.min_delta + m0;
  const long long* mbit = g.bit_start + m0;
  // the windows: shared memory where they fit, else the tables themselves
  if (npw <= kDeltaWindow) {
    for (int i = threadIdx.x; i < npw; i += kThreads) {
      w_pstart[i] = pstart[i];
      w_first[i] = pfirst[i];
    }
    pstart = w_pstart;
    pfirst = w_first;
  }
  if (nmw <= kDeltaWindow) {
    for (int i = threadIdx.x; i < nmw; i += kThreads) {
      w_mstart[i] = mstart[i];
      w_mbw[i] = mbw[i];
      w_mind[i] = mind[i];
      w_mbit[i] = mbit[i];
    }
    mstart = w_mstart;
    mbw = w_mbw;
    mind = w_mind;
    mbit = w_mbit;
  }
  __syncthreads();

  const long long k0 =
      t0 + static_cast<long long>(threadIdx.x) * kDeltaItems;
  Seg local[kDeltaItems];
  Seg acc = {0ull, 0};
  if (k0 < t1) {
    // the window's last page and miniblock starting at or before k0
    int jp = upper_bound(pstart + 1, npw - 1, k0);
    int jm = upper_bound(mstart + 1, nmw - 1, k0);
#pragma unroll
    for (int q = 0; q < kDeltaItems; ++q) {
      const long long k = k0 + q;
      Seg e = {0ull, 0};
      if (k < t1) {
        while (jp + 1 < npw && pstart[jp + 1] <= k) ++jp;
        while (jm + 1 < nmw && mstart[jm + 1] <= k) ++jm;
        if (k == pstart[jp]) {
          e.v = static_cast<unsigned long long>(pfirst[jp]);
          e.f = 1;
        } else {
          // (k - mstart[m]) in int32, as the twin subtracts int32 arrays
          const int rel = static_cast<int>(static_cast<unsigned>(k) -
                                           static_cast<unsigned>(mstart[jm]));
          const long long bit =
              mbit[jm] + static_cast<long long>(rel) * mbw[jm];
          e.v = extract_bits(g.words, g.nwords, bit, mbw[jm]) +
                static_cast<unsigned long long>(mind[jm]);
        }
      }
      acc = seg_combine(acc, e);
      local[q] = acc;
    }
  }
  Seg total;
  const Seg ex = block_exclusive_seg_scan<kThreads>(acc, &total);

  // the tile's exclusive prefix: none for a chunk's first tile or a tile
  // that starts on a page head; else publish the aggregate and look back
  const bool head0 = pstart[0] == t0;
  if (threadIdx.x < 32) {
    Seg pre = {0ull, 0};
    unsigned long long* mine = states + 2 * static_cast<long long>(tile);
    const unsigned long long tag = epoch << 2;
    if (tile == g.tile0 || head0) {
      if (threadIdx.x == 0) store_state(mine, tag | kPrefix, total.v);
    } else {
      if (threadIdx.x == 0) {
        store_state(mine, tag | (total.f ? kPrefix : kAggregate), total.v);
      }
      pre = look_back(states, tile, g.tile0, epoch);
      if (threadIdx.x == 0 && !total.f) {
        store_state(mine, tag | kPrefix, seg_combine(pre, total).v);
      }
    }
    if (threadIdx.x == 0) s_prefix = pre;
  }
  __syncthreads();
  const Seg base = seg_combine(s_prefix, ex);
  const int t = threadIdx.x;
  // thread t's pair q in slot 4t + (q ^ ((t >> 1) & 3)): the eight threads
  // of a quarter warp then write eight distinct 16-byte bank groups
#pragma unroll
  for (int q = 0; q < kDeltaItems / 2; ++q) {
    s_pairs[4 * t + (q ^ ((t >> 1) & 3))] = make_longlong2(
        static_cast<long long>(seg_combine(base, local[2 * q]).v),
        static_cast<long long>(seg_combine(base, local[2 * q + 1]).v));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kDeltaItems / 2; ++i) {
    const int slot = i * kThreads + t;
    const int owner = slot >> 2;
    const long long pos =
        t0 + owner * kDeltaItems + 2 * ((slot & 3) ^ ((owner >> 1) & 3));
    if (pos + 2 <= t1) {
      *reinterpret_cast<longlong2*>(g.out + pos) = s_pairs[slot];
    } else if (pos < t1) {
      g.out[pos] = s_pairs[slot].x;
    }
  }
}

// ---------------------------------------------------------------------------
// B7: PLAIN fixed-width re-blocking
// ---------------------------------------------------------------------------

// One output stream of a plain_fixed_many launch. Its blocks are
// [block0, block0 + ceil(chunks / kCopyBlockChunks)) of the grid.
struct PlainSeg {
  const uint32_t* src;
  void* dst;
  long long nwords;  // source words
  long long n;       // output values
  int width;         // 4 (i32, f32), 8 (i64, f64) or 1 (bool)
  int block0;
};

struct PlainBatch {
  PlainSeg seg[kMaxPlainSegments];
  int nseg;
};

__global__ void plain_fixed_many_kernel(
    const __grid_constant__ PlainBatch b) {
  int s = 0;  // the block's segment: the last whose first block is <= it
  for (int i = 1; i < b.nseg; ++i) {
    if (b.seg[i].block0 <= static_cast<int>(blockIdx.x)) s = i;
  }
  const PlainSeg& g = b.seg[s];
  const long long out_bytes = g.n * g.width;
  const long long chunks = (out_bytes + 15) >> 4;
  const long long c0 =
      static_cast<long long>(static_cast<int>(blockIdx.x) - g.block0) *
          kCopyBlockChunks + threadIdx.x;
  const bool aligned = ((reinterpret_cast<uintptr_t>(g.src) |
                         reinterpret_cast<uintptr_t>(g.dst)) & 15) == 0;
#pragma unroll
  for (int it = 0; it < kCopyChunksPerThread; ++it) {
    const long long c = c0 + static_cast<long long>(it) * kThreads;
    if (c >= chunks) break;
    if (g.width == 1) {
      // output bytes 16c .. 16c + 15 are bits of one (clamped) word
      long long w = c >> 1;
      if (w > g.nwords - 1) w = g.nwords - 1;
      const uint32_t bits = g.src[w] >> ((c & 1) * 16);
      uint8_t* out = static_cast<uint8_t*>(g.dst) + 16 * c;
      if (aligned && 16 * c + 16 <= g.n) {
        uint32_t q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          q[j] = 0;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            q[j] |= ((bits >> (4 * j + t)) & 1u) << (8 * t);
          }
        }
        *reinterpret_cast<uint4*>(out) = make_uint4(q[0], q[1], q[2], q[3]);
      } else {
        for (int j = 0; j < 16 && 16 * c + j < g.n; ++j) {
          out[j] = static_cast<uint8_t>((bits >> j) & 1u);
        }
      }
    } else {
      // a byte copy of the first n * width bytes, as u32 words
      const long long out_words = out_bytes >> 2;
      const long long w = 4 * c;
      if (aligned && w + 4 <= out_words) {
        reinterpret_cast<uint4*>(g.dst)[c] =
            __ldg(reinterpret_cast<const uint4*>(g.src) + c);
      } else {
        uint32_t* out = static_cast<uint32_t*>(g.dst);
        for (long long j = w; j < w + 4 && j < out_words; ++j) {
          out[j] = g.src[j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B8: PLAIN byte arrays -> char slab
// ---------------------------------------------------------------------------

__global__ void slab_pack_kernel(const uint8_t* __restrict__ chars,
                                 long long nchars,
                                 const long long* __restrict__ starts,
                                 const int* __restrict__ lens, long long cap,
                                 int nwords,
                                 unsigned long long* __restrict__ out) {
  const long long total = cap * nwords;
  const long long top = nchars > 0 ? nchars - 1 : 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / nwords;
    const int w = static_cast<int>(i - r * nwords);
    const long long s = starts[r];
    const int ln = lens[r];
    unsigned long long word = 0ull;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pos = 8 * w + j;
      if (pos < ln && nchars > 0) {
        long long src = s + pos;
        src = src < 0 ? 0 : (src > top ? top : src);
        word |= static_cast<unsigned long long>(chars[src]) << (8 * j);
      }
    }
    out[i] = word;
  }
}

}  // namespace

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_hybrid_expand_max_streams() { return kMaxHybridStreams; }

// desc: nseg rows of eleven int64 {words, nwords, out_start, nstarts, kind,
// value, bit_start, bw, nruns, out, n}: a stream's u32 words and their
// count; its run table, out_start int32 (nstarts entries: the runs' starts,
// the guard row's and INT32_MAX) and kind uint8, value int32, bit_start
// int64 and bw int32 (nruns rows, the guard row last); n int32 outputs.
// nseg <= srt_hybrid_expand_max_streams(), 0 <= n < 2^31. One launch.
extern "C" int srt_hybrid_expand_many(const long long* desc, int nseg,
                                      cudaStream_t stream) {
  if (nseg < 0 || nseg > kMaxHybridStreams) return cudaErrorInvalidValue;
  HybridBatch b;
  b.nseg = 0;
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const long long* d = desc + 11 * i;
    if (d[1] <= 0 || d[3] <= 0 || d[8] <= 0 || d[10] < 0 ||
        d[10] >= (1ll << 31)) {
      return cudaErrorInvalidValue;
    }
    if (d[10] == 0) continue;
    HybridSeg& g = b.seg[b.nseg++];
    g.words = reinterpret_cast<const uint32_t*>(d[0]);
    g.nwords = d[1];
    g.out_start = reinterpret_cast<const int*>(d[2]);
    g.nstarts = static_cast<int>(d[3]);
    g.kind = reinterpret_cast<const uint8_t*>(d[4]);
    g.value = reinterpret_cast<const int*>(d[5]);
    g.bit_start = reinterpret_cast<const long long*>(d[6]);
    g.bw = reinterpret_cast<const int*>(d[7]);
    g.nruns = static_cast<int>(d[8]);
    g.out = reinterpret_cast<int*>(d[9]);
    g.n = static_cast<int>(d[10]);
    g.block0 = static_cast<int>(blocks);
    blocks += (d[10] + kHybridTile - 1) / kHybridTile;
    if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  hybrid_expand_many_kernel<<<static_cast<int>(blocks), kThreads, 0,
                              stream>>>(b);
  return cudaGetLastError();
}

extern "C" int srt_delta_unpack_max_chunks() { return kMaxDeltaChunks; }
extern "C" int srt_delta_unpack_tile_rows() { return kDeltaTile; }

// desc: nseg rows of twelve int64 {words, nwords, mstart, bw, min_delta,
// bit_start, nmini, page_start, first, npages, out, n}: a chunk's u32
// words; its miniblock table (nmini rows, the guard row last: mstart int32
// in element space, bw int32 <= 32, min_delta int64, bit_start int64); its
// pages (page_start int32 (npages + 1,), the last entry n; first int64
// (npages,)); out: n int64, 16-byte aligned. scratch: at least 2 + 2 *
// (the sum of ceil(n / srt_delta_unpack_tile_rows()), the chunks' tiles)
// u64 words, 16-byte aligned, zero before its first launch and passed to
// this function on one stream only; epoch: greater than that of every earlier launch on this
// scratch, below 2^62. nseg <= srt_delta_unpack_max_chunks(),
// 0 <= n < 2^31. One launch.
extern "C" int srt_delta_unpack_many(const long long* desc, int nseg,
                                     unsigned long long* scratch,
                                     long long scratch_words,
                                     unsigned long long epoch,
                                     cudaStream_t stream) {
  if (nseg < 0 || nseg > kMaxDeltaChunks) return cudaErrorInvalidValue;
  DeltaBatch b;
  b.nseg = 0;
  long long tiles = 0;
  for (int i = 0; i < nseg; ++i) {
    const long long* d = desc + 12 * i;
    if (d[1] <= 0 || d[6] <= 0 || d[9] <= 0 || d[11] < 0 ||
        d[11] >= (1ll << 31) || (d[10] & 15) != 0) {
      return cudaErrorInvalidValue;
    }
    if (d[11] == 0) continue;
    DeltaSeg& g = b.seg[b.nseg++];
    g.words = reinterpret_cast<const uint32_t*>(d[0]);
    g.nwords = d[1];
    g.mstart = reinterpret_cast<const int*>(d[2]);
    g.mbw = reinterpret_cast<const int*>(d[3]);
    g.min_delta = reinterpret_cast<const long long*>(d[4]);
    g.bit_start = reinterpret_cast<const long long*>(d[5]);
    g.nmini = static_cast<int>(d[6]);
    g.page_start = reinterpret_cast<const int*>(d[7]);
    g.first = reinterpret_cast<const long long*>(d[8]);
    g.npages = static_cast<int>(d[9]);
    g.out = reinterpret_cast<long long*>(d[10]);
    g.n = static_cast<int>(d[11]);
    g.tile0 = static_cast<int>(tiles);
    tiles += (d[11] + kDeltaTile - 1) / kDeltaTile;
    if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  }
  if (tiles == 0) return cudaSuccess;
  if (scratch_words < 2 + 2 * tiles || epoch == 0 || (epoch >> 62) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  b.ntiles = static_cast<int>(tiles);
  delta_unpack_many_kernel<<<static_cast<int>(tiles), kThreads, 0, stream>>>(
      b, scratch, epoch);
  return cudaGetLastError();
}

extern "C" int srt_plain_fixed_max_segments() { return kMaxPlainSegments; }

// desc: nseg rows of five int64 {words, nwords, width, out, n}: the u32
// source words, their count, the output width (4 for i32/f32, 8 for
// i64/f64, 1 for bool, one byte per value) and n output values of that
// width; nseg <= srt_plain_fixed_max_segments(). One launch for all rows.
extern "C" int srt_plain_fixed_many(const long long* desc, int nseg,
                                    cudaStream_t stream) {
  if (nseg < 0 || nseg > kMaxPlainSegments) return cudaErrorInvalidValue;
  PlainBatch b;
  b.nseg = 0;
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const long long* d = desc + 5 * i;
    const int width = static_cast<int>(d[2]);
    if (width != 1 && width != 4 && width != 8) return cudaErrorInvalidValue;
    const long long chunks = (d[4] * width + 15) >> 4;
    const long long nb = (chunks + kCopyBlockChunks - 1) / kCopyBlockChunks;
    if (nb <= 0) continue;
    PlainSeg& g = b.seg[b.nseg++];
    g.src = reinterpret_cast<const uint32_t*>(d[0]);
    g.nwords = d[1];
    g.width = width;
    g.dst = reinterpret_cast<void*>(d[3]);
    g.n = d[4];
    g.block0 = static_cast<int>(blocks);
    blocks += nb;
    if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  plain_fixed_many_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      b);
  return cudaGetLastError();
}

// chars: nchars bytes; starts int64 and lens int32: cap rows; out: cap x
// nwords u64.
extern "C" int srt_slab_pack(const uint8_t* chars, long long nchars,
                             const long long* starts, const int* lens,
                             long long cap, int nwords,
                             unsigned long long* out, cudaStream_t stream) {
  const long long total = cap * nwords;
  if (total <= 0) return cudaSuccess;
  slab_pack_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      chars, nchars, starts, lens, cap, nwords, out);
  return cudaGetLastError();
}
