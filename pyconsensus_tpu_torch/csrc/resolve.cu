// Fused outcome resolution and certainty: the column half, for sm_90a.
//
// Replaces the column half of the Pallas TPU kernel resolve_certainty_fused
// (pyconsensus_tpu/ops/pallas_kernels.py:1275; _resolve_certainty_kernel
// :1117): per column the present-weighted mean (falling back to the
// full-reputation filled mean where no reputation is present), the
// catch-snapped outcome, the certainty (reputation mass agreeing with the
// outcome) and pcol = rep^T [absent] clamped to [0, sum(rep)]. The row
// half, prow = [absent] . certainty and the absent count, is the row-tile
// pass of storage_sweeps.cu at k = 2 with the absent-indicator element op
// (pyc_row_tile_absent), over V^T = [certainty; 1].
//
// Design. Outcomes are column reductions over all R rows and certainty
// needs the outcome, so a panel of C columns is walked twice: walk 1 sums
// numer and tw, the block turns them into outcomes, walk 2 sums the
// certainty. The panel (R x C, 16 bytes a row at R = 10000: C = 16 int8,
// 8 bfloat16, 4 float32) stays in shared memory between the walks, so X is read from
// device memory once for the column half.
//   - Persistent grid: one 512-thread block an SM; block b takes panels
//     b, b + G, b + 2G, ... (G blocks) in that static order.
//   - Thread-owned rows: thread t owns column group t % NG (CW = 16 /
//     itemsize columns: 16 int8, 8 bfloat16 or 4 float32, one 16-byte
//     granule of a row, or the whole row
//     when it is narrower) and rows t / NG + k * (512 / NG). It copies
//     exactly the granules it later reads, so a slot is never handed from
//     one thread to another: the ring needs no block barrier, and a block
//     synchronises only for its three block sums a panel.
//   - Chunk ring across panels: a thread's granules go, U rows at a time
//     (a chunk: U >= 4, so that a step's wait and bookkeeping serve four
//     rows), into a ring of chunk slots (at most 32; at R = 10000 and
//     16-byte rows, U = 4 and the panel's 5 chunks of 32 KB). The copies
//     are 16-byte cp.async (4 or 8 bytes for narrower rows); each slot has
//     an mbarrier that completes when every thread's copies of the chunk
//     have landed (cp.async.mbarrier.arrive.noinc). Walk 1 consumes each
//     chunk as it lands, with 64 KB of copies in flight ahead of it; walk
//     2 runs from shared memory, and each chunk it finishes frees its slot
//     for the next panel's chunk, so the next panel's first chunks land
//     while walk 2 runs. The ring holds the panel and no spare slot
//     (kSpareSlots): a spare slot bought no time at int8
//     (tools/resolve_lab.py), and without it the ring's 160 KB leave the
//     SM 60 KB of L1, which holds the reputation (read for every row of
//     both walks, one chunk ahead).
//   - Cheap walks: int8 is decoded with no int-to-float conversion: each
//     byte, offset by 128, into the mantissa of 2^23 (F = 2^23 + s + 128).
//     Walk 1 runs on the FMA pipe: presence sat(F - 2^23 - 127) in {0, 1},
//     value 0.5 F - 2^22 - 64, tw += presence * rs, numer += value *
//     presence * rs. Walk 2 compares bytes, four a word: an entry agrees
//     with the outcome when its byte is the outcome's code 2 * outcome, or
//     when it is absent and the column's fill equals the outcome; the
//     match bit becomes 1.0 and an FMA adds rs. bfloat16 and float32
//     decode to their float32 values (bfloat16 by shifting its bits into
//     the high half of a float32, exact) and walk as floats, walk 2 from
//     shared memory like the int8 one.
//   - Block sums: each warp halves its CW columns across its lanes at each
//     shuffle (CW - 1 + log2(32 / CW) shuffles, not 5 CW), then the warp
//     partials are summed in warp order by one thread a column (a shuffle
//     tree per column group where column groups share a warp). Each
//     column's sums take its rows in an order fixed by the thread mapping
//     alone, never by the grid size, the SM count or scheduling, so the
//     results are the same bits from run to run. No float atomics.
// Rows whose 16-byte granule is not aligned or not whole (E * itemsize
// not a multiple of the granule, a misaligned matrix, the ragged last
// panel, 1- and 2-byte rows) are copied element by element by their own
// thread, zero past E; columns past E are never written.
//
// Bound. Bytes: one read of X is R*E*itemsize (1.0 GB at 10000 x 100000
// int8, ~0.30 ms at 3.35 TB/s; 2.0 GB, ~0.60 ms, at bfloat16). The column half reads X once, the row half
// (the row-tile pass) once more, so resolution cannot beat twice the byte
// bound (0.60 ms at int8, 1.19 at bfloat16, 2.39 at float32); the one-read fusion of the row
// half into this kernel is later work.

#include <atomic>

#include "sweep_common.cuh"

namespace {

using pyc::Vec;

constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
// dynamic shared memory one block may use on sm_90 (227 KB)
constexpr int kSmemPerBlock = 232448;
// most chunk slots (and mbarriers) of the ring
constexpr int kMaxSlots = 32;
// bytes of copies a block keeps in flight ahead of walk 1
constexpr int kAheadBytes = 65536;
// fewest rows a thread takes in one chunk
constexpr int kMinChunkRows = 4;
// ring slots beyond the panel's chunks, for the next panel's
constexpr int kSpareSlots = 0;
// shared memory of one SM that blocks may take (228 KB)
constexpr int kSmemPerSm = 233472;
// devices whose launch attributes are remembered
constexpr int kMaxDevices = 64;

// bytes of a thread's granule of one panel row: the whole row up to 16
template <typename T, int C>
__host__ __device__ constexpr int granule_bytes() {
  return C * static_cast<int>(sizeof(T)) < 16 ? C * static_cast<int>(sizeof(T))
                                              : 16;
}

// Shared memory before the ring: the slots' mbarriers, three rows of
// per-warp partials per column (numer, tw, certainty) and the block's
// outcome and fill columns, rounded up to 16 bytes.
template <int C>
__host__ __device__ constexpr int aux_bytes() {
  return (kMaxSlots * 8 + 4 * (3 * kResWarps * C + 2 * C) + 15) / 16 * 16;
}

// granules a thread's ring can hold beside the aux
template <typename T, int C>
__host__ __device__ constexpr int ring_granules() {
  return (kSmemPerBlock - aux_bytes<C>()) /
         (kResThreads * granule_bytes<T, C>());
}

// rows a thread copies into one chunk slot and walks in one step: at
// least kMinChunkRows, so that a step's waits and bookkeeping are shared
// by several rows, and enough for at most kMaxSlots slots
template <typename T, int C>
__host__ __device__ constexpr int chunk_rows() {
  return (ring_granules<T, C>() + kMaxSlots - 1) / kMaxSlots > kMinChunkRows
             ? (ring_granules<T, C>() + kMaxSlots - 1) / kMaxSlots
             : kMinChunkRows;
}

template <typename T, int C>
__host__ __device__ constexpr int ring_slots() {
  return ring_granules<T, C>() / chunk_rows<T, C>();
}

// rows of the block that one pass over its threads covers: 512 / NG,
// where NG = C * itemsize / granule threads share a row
template <typename T, int C>
__host__ __device__ constexpr int group_rows() {
  return kResThreads /
         (C * static_cast<int>(sizeof(T)) / granule_bytes<T, C>());
}

// chunks a thread keeps in flight ahead of walk 1: about kAheadBytes a
// block (64 KB, as many bytes as the first resolve kernel's staging kept
// in flight), within the ring
template <typename T, int C>
__host__ __device__ constexpr int copies_ahead() {
  constexpr int n =
      kAheadBytes / (chunk_rows<T, C>() * kResThreads * granule_bytes<T, C>());
  return n < 1 ? 1 : (n > ring_slots<T, C>() ? ring_slots<T, C>() : n);
}

template <typename T, int C>
__host__ __device__ constexpr int res_smem_bytes() {
  return aux_bytes<C>() + ring_slots<T, C>() * chunk_rows<T, C>() *
                              kResThreads * granule_bytes<T, C>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barrier's pending count drops by one when every cp.async this
// thread issued so far has landed
__device__ __forceinline__ void bar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Sum v[j] over the lanes of the warp that share this lane's column group
// (lanes l, l + NG, l + 2 NG, ...). The result is valid in lanes < NG.
template <int CW, int NG>
__device__ __forceinline__ void group_sum(float (&v)[CW]) {
#pragma unroll
  for (int o = 16; o >= NG; o >>= 1)
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
}

// CW entries of one granule, decoded: int8 as 0.5 * s with no
// int-to-float conversion (0.5 * (2^23 + s + 128) - (2^22 + 64), exact;
// the sentinel -1 becomes -0.5), float as it is. absent: val < 0 at int8,
// NaN at float.
template <int CW>
__device__ __forceinline__ void decode(const Vec<int8_t, CW>& p,
                                       float (&val)[CW], bool (&absent)[CW]) {
  if constexpr (CW >= 4) {
#pragma unroll
    for (int w = 0; w < CW / 4; ++w) {
      const unsigned b =
          reinterpret_cast<const unsigned*>(p.v)[w] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        val[4 * w + j] =
            fmaf(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u + j)),
                 0.5f, -4194368.f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      val[j] = fmaf(
          __uint_as_float(0x4B000000u |
                          (static_cast<unsigned char>(p.v[j]) ^ 0x80u)),
          0.5f, -4194368.f);
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) absent[j] = val[j] < 0.f;
}

// bfloat16: two entries a 32-bit word, each 16-bit half the high half of
// its float32 value (pyc::decode for a one-column granule)
template <int CW>
__device__ __forceinline__ void decode(const Vec<__nv_bfloat16, CW>& p,
                                       float (&val)[CW], bool (&absent)[CW]) {
  if constexpr (CW >= 2) {
#pragma unroll
    for (int w = 0; w < CW / 2; ++w) {
      const unsigned b = reinterpret_cast<const unsigned*>(p.v)[w];
      val[2 * w] = pyc::bf16_bits_to_float(b);
      val[2 * w + 1] = __uint_as_float(b & 0xFFFF0000u);
      absent[2 * w] = isnan(val[2 * w]);
      absent[2 * w + 1] = isnan(val[2 * w + 1]);
    }
  } else {
    pyc::decode(p.v[0], val[0], absent[0]);
  }
}

template <int CW>
__device__ __forceinline__ void decode(const Vec<float, CW>& p,
                                       float (&val)[CW], bool (&absent)[CW]) {
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    val[j] = p.v[j];
    absent[j] = isnan(val[j]);
  }
}

// F = 2^23 + s + 128 for each byte s of an int8 granule (the byte,
// offset by 128, in the mantissa of 2^23): one byte permute an entry
template <int CW>
__device__ __forceinline__ void byte_floats(const Vec<int8_t, CW>& p,
                                            float (&f)[CW]) {
  if constexpr (CW >= 4) {
#pragma unroll
    for (int w = 0; w < CW / 4; ++w) {
      const unsigned b =
          reinterpret_cast<const unsigned*>(p.v)[w] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * w + j] =
            __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u + j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      f[j] = __uint_as_float(0x4B000000u |
                             (static_cast<unsigned char>(p.v[j]) ^ 0x80u));
  }
}

// walk 1 of one granule: numer += rs * value, tw += rs where present
template <typename T, int CW>
__device__ __forceinline__ void walk1(const Vec<T, CW>& p, float rs,
                                      float (&numer)[CW], float (&tw)[CW]) {
  if constexpr (sizeof(T) == 1) {
    // from F = 2^23 + s + 128, all on the FMA pipe: the presence
    // sat(F - (2^23 + 127)) is 1 for s >= 0 and 0 for the sentinel, the
    // value 0.5 F - (2^22 + 64) = 0.5 s; pr = presence * rs is rs or 0,
    // so tw and numer take exactly the terms of a select
    float f[CW];
    byte_floats(p, f);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float pr = __saturatef(f[j] - 8388735.f) * rs;
      tw[j] += pr;
      numer[j] = fmaf(fmaf(f[j], 0.5f, -4194368.f), pr, numer[j]);
    }
  } else {
    float val[CW];
    bool absent[CW];
    decode(p, val, absent);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      tw[j] = fmaf(absent[j] ? 0.f : 1.f, rs, tw[j]);
      numer[j] = fmaf(absent[j] ? 0.f : val[j], rs, numer[j]);
    }
  }
}

// walk 2 of one granule: ce += rs where (absent ? fill : value) == outcome
template <typename T, int CW>
__device__ __forceinline__ void walk2(const Vec<T, CW>& p, float rs,
                                      const float (&oc)[CW],
                                      const float (&fc)[CW], float (&ce)[CW]) {
  float val[CW];
  bool absent[CW];
  decode(p, val, absent);
#pragma unroll
  for (int j = 0; j < CW; ++j)
    ce[j] += ((absent[j] ? fc[j] : val[j]) == oc[j]) ? rs : 0.f;
}

// One granule, columns col .. col + CW - 1 of row r, into dst: a cp.async
// when whole and aligned (vec), else element by element, zero past E.
template <typename T, int CW>
__device__ __forceinline__ void copy_granule(T* dst, const T* __restrict__ x,
                                             long long r, long long E,
                                             long long col, bool vec) {
  constexpr int GB = CW * static_cast<int>(sizeof(T));
  const T* src = x + r * E + col;
  if constexpr (GB >= 4) {
    if (vec && col + CW <= E) {
      cp_async<GB>(dst, src);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < CW; ++j)
    dst[j] = col + j < E ? src[j] : pyc::zero<T>();
}

// Walk 2 of one int8 granule by bytes, four columns a word: an entry
// agrees with its column's outcome when its byte equals the outcome's
// code 2 * outcome (present), or when it is absent (sign bit) and the
// column's fill equals the outcome (bit 7 of `fill_ok`'s byte). The match
// bit, moved by a byte permute to bit 23, is the float 2^-126, and times
// 2^126 exactly 1.0, so a match adds exactly rs.
template <int CW>
__device__ __forceinline__ void walk2_bytes(const Vec<int8_t, CW>& p, float rs,
                                            const unsigned (&code)[CW / 4],
                                            const unsigned (&fill_ok)[CW / 4],
                                            float (&ce)[CW]) {
#pragma unroll
  for (int w = 0; w < CW / 4; ++w) {
    const unsigned b = reinterpret_cast<const unsigned*>(p.v)[w];
    const unsigned d = b ^ code[w];
    // 0x80 in each byte of d that is zero
    const unsigned z = ~(((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d | 0x7F7F7F7Fu);
    const unsigned m = z | (b & fill_ok[w]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ce[4 * w + j] = fmaf(
          __uint_as_float(__byte_perm(m, 0u, 0x4044u + (j << 8))) * 0x1p126f,
          rs, ce[4 * w + j]);
  }
}

// Sum v[j] over the 32 lanes of a warp whose lanes all hold the same CW
// columns, halving the columns at each of the first log2(CW) exchanges
// (each lane keeps half and sends half), then adding pairs: the sum of
// column (lane >> log2(32 / CW)) % CW ends in v[0] of every lane, in a
// fixed order. CW - 1 + log2(32 / CW) shuffles instead of 5 CW.
template <int CW, int H = CW / 2>
__device__ __forceinline__ void warp_sum_scatter(float (&v)[CW], int lane) {
  if constexpr (H >= 1) {
    constexpr int off = 32 * H / CW;      // 16, 8, ... while halving
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[H + i];
      const float keep = up ? v[H + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    warp_sum_scatter<CW, H / 2>(v, lane);
  } else {
#pragma unroll
    for (int o = 16 / CW; o >= 1; o /= 2)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
}

// The warp's partial of each of its columns into row[col]: one shuffle
// tree per column group for NG > 1, the halving sum for NG = 1.
template <int CW, int NG>
__device__ __forceinline__ void warp_partials(float (&v)[CW], float* row,
                                              int lane, int cg) {
  if constexpr (NG == 1) {
    constexpr int spread = 32 / CW;       // lanes that end with one column
    warp_sum_scatter<CW>(v, lane);
    if (lane % spread == 0) row[(lane / spread) % CW] = v[0];
  } else {
    group_sum<CW, NG>(v);
    if (lane < NG) {
#pragma unroll
      for (int j = 0; j < CW; ++j) row[cg * CW + j] = v[j];
    }
  }
}

// raw/out/pcol/cert[e] for the columns of the block's panels. ns: the ring
// slots in use (the panel's chunks and at most kSpareSlots more). vec:
// every granule of a row starts on a boundary of its size in device
// memory.
template <typename T, int C>
__global__ void __launch_bounds__(kResThreads, 1)
resolve_cols_kernel(const T* __restrict__ x, long long R, long long E,
                    int ns, int vec,
                    const float* __restrict__ rep,
                    const float* __restrict__ fill,
                    const float* __restrict__ rep_sum,
                    const float* __restrict__ full_total, float lo, float hi,
                    float* __restrict__ raw, float* __restrict__ out,
                    float* __restrict__ cert, float* __restrict__ pcol) {
  constexpr int VW = 16 / static_cast<int>(sizeof(T));
  constexpr int CW = C < VW ? C : VW;
  constexpr int NG = C / CW;
  constexpr int G = group_rows<T, C>();
  constexpr int GB = granule_bytes<T, C>();
  constexpr int U = chunk_rows<T, C>();
  constexpr int NS_MAX = ring_slots<T, C>();
  constexpr int D = copies_ahead<T, C>();
  constexpr bool BYTES = sizeof(T) == 1 && CW % 4 == 0;
  static_assert(NG <= 32 && 32 % NG == 0, "column groups per warp");
  static_assert(GB == CW * static_cast<int>(sizeof(T)) && G * NG == kResThreads,
                "granule");
  static_assert(NS_MAX >= 1 && NS_MAX <= kMaxSlots, "ring slots");
  const int d = D < ns ? D : ns;                // copies ahead, in slots
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  float* red = reinterpret_cast<float*>(smem + kMaxSlots * 8);
  float* outc = red + 3 * kResWarps * C;
  float* fillc = outc + C;
  const int tid = threadIdx.x;
  // this thread's granule u of slot s is at ring + ((s U + u) 512 + tid) GB
  unsigned char* ring = smem + aux_bytes<C>() + tid * GB;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid % NG;
  const int g = tid / NG;
  const long long n_panels = (E + C - 1) / C;
  const int npc = static_cast<int>(((R + G - 1) / G + U - 1) / U);
  const long long my_panels =
      blockIdx.x < n_panels ? (n_panels - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = my_panels * npc;      // chunks of the block
  const long long col_step = static_cast<long long>(gridDim.x) * C;
  const float rep_total = *rep_sum;
  const float ft = *full_total;

  // The copy front: the next chunk to issue, its slot, its place in its
  // panel and its panel's first column of this thread's group.
  long long ic = 0;
  int is = 0, iq = 0;
  long long icol = static_cast<long long>(blockIdx.x) * C + cg * CW;
  auto issue = [&]() {
    unsigned char* dst =
        ring + static_cast<long long>(is) * U * kResThreads * GB;
    long long r = g + static_cast<long long>(iq) * U * G;
#pragma unroll
    for (int u = 0; u < U; ++u, r += G) {
      if (r >= R) break;
      copy_granule<T, CW>(reinterpret_cast<T*>(dst + u * kResThreads * GB), x,
                          r, E, icol, vec);
    }
    bar_arrive_copies(bars + is);
    ++ic;
    if (++is == ns) is = 0;
    if (++iq == npc) {
      iq = 0;
      icol += col_step;
    }
  };
  // issue chunks up to (not including) `limit`, never past the block's
  // last, never into a slot walk 2 has not freed (`freed` + ns), and at
  // most d ahead of walk 1 (`waited` + d)
  auto pump = [&](long long freed, long long waited, long long cap) {
    long long limit = freed + ns;
    if (waited + d < limit) limit = waited + d;
    if (cap < limit) limit = cap;
    while (ic < limit) issue();
  };
  // the reputation of the thread's rows of chunk q (0 past R)
  auto load_rep = [&](int q, float (&rs)[U]) {
    long long r = g + static_cast<long long>(q) * U * G;
#pragma unroll
    for (int u = 0; u < U; ++u, r += G) rs[u] = r < R ? __ldg(rep + r) : 0.f;
  };

  if (tid < ns) bar_init(bars + tid, kResThreads);
  // the granules of rows past R are never copied: zero them once, so
  // that a step walks all its U rows with no test (their rs is 0)
  Vec<T, CW> zeros;
#pragma unroll
  for (int j = 0; j < CW; ++j) zeros.v[j] = pyc::zero<T>();
  for (int i = 0; i < ns * U; ++i)
    *reinterpret_cast<Vec<T, CW>*>(ring + static_cast<long long>(i) *
                                              kResThreads * GB) = zeros;
  __syncthreads();

  int slot0 = 0;               // the slot of the panel's first chunk
  unsigned par0 = 0;           // its mbarrier phase parity
  long long c0 = 0;            // the panel's first chunk
#pragma unroll 1
  for (long long pl = 0; pl < my_panels; ++pl, c0 += npc) {
    const long long col0 =
        static_cast<long long>(blockIdx.x) * C + pl * col_step;
    // the next panel's chunks go out while walk 2 frees their slots
    const long long cap = total;
    pump(c0, c0, cap);

    // walk 1: present-weighted sums, each chunk as it lands
    float numer[CW], tw[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) numer[j] = tw[j] = 0.f;
    float rs[U], rn[U];
    load_rep(0, rs);
    int s = slot0;
    unsigned par = par0;
#pragma unroll 1
    for (int q = 0; q < npc; ++q) {
      if (q + 1 < npc) load_rep(q + 1, rn);
      bar_wait(bars + s, par);
      pump(c0, c0 + q + 1, cap);
      const unsigned char* src =
          ring + static_cast<long long>(s) * U * kResThreads * GB;
#pragma unroll
      for (int u = 0; u < U; ++u)
        walk1<T, CW>(*reinterpret_cast<const Vec<T, CW>*>(
                         src + u * kResThreads * GB),
                     rs[u], numer, tw);
#pragma unroll
      for (int u = 0; u < U; ++u) rs[u] = rn[u];
      if (++s == ns) {
        s = 0;
        par ^= 1u;
      }
    }
    const int slot_next = s;           // the next panel's first chunk
    const unsigned par_next = par;
    warp_partials<CW, NG>(numer, red + warp * C, lane, cg);
    warp_partials<CW, NG>(tw, red + (kResWarps + warp) * C, lane, cg);
    __syncthreads();
    if (tid < C) {
      float n = 0.f, w = 0.f;
      for (int ww = 0; ww < kResWarps; ++ww) {
        n += red[ww * C + tid];
        w += red[(kResWarps + ww) * C + tid];
      }
      const long long col = col0 + tid;
      const float f = col < E ? fill[col] : 0.f;
      const float pc = fminf(fmaxf(rep_total - w, 0.f), rep_total);
      const float fmn = __fadd_rn(n, __fmul_rn(f, pc));
      const float full_mean = fmn / (ft == 0.f ? 1.f : ft);
      const float mean = w > 0.f ? n / w : full_mean;
      const float o = mean < lo ? 0.f : (mean > hi ? 1.f : 0.5f);
      outc[tid] = o;
      fillc[tid] = f;
      if (col < E) {
        raw[col] = mean;
        out[col] = o;
        pcol[col] = pc;
      }
    }
    __syncthreads();

    // walk 2: reputation mass agreeing with the outcome, from shared
    // memory; each finished chunk frees its slot for a later one
    float oc[CW], fc[CW], ce[CW];
    unsigned code[BYTES ? CW / 4 : 1], fill_ok[BYTES ? CW / 4 : 1];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      oc[j] = outc[cg * CW + j];
      fc[j] = fillc[cg * CW + j];
      ce[j] = 0.f;
    }
    if constexpr (BYTES) {
#pragma unroll
      for (int w = 0; w < CW / 4; ++w) {
        code[w] = fill_ok[w] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          code[w] |= static_cast<unsigned>(2.f * oc[4 * w + j]) << (8 * j);
          fill_ok[w] |= (fc[4 * w + j] == oc[4 * w + j] ? 0x80u : 0u)
                        << (8 * j);
        }
      }
    }
    load_rep(0, rs);
    s = slot0;
#pragma unroll 1
    for (int q = 0; q < npc; ++q) {
      if (q + 1 < npc) load_rep(q + 1, rn);
      const unsigned char* src =
          ring + static_cast<long long>(s) * U * kResThreads * GB;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const Vec<T, CW>& pv = *reinterpret_cast<const Vec<T, CW>*>(
            src + u * kResThreads * GB);
        if constexpr (BYTES)
          walk2_bytes<CW>(pv, rs[u], code, fill_ok, ce);
        else
          walk2<T, CW>(pv, rs[u], oc, fc, ce);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) rs[u] = rn[u];
      if (++s == ns) s = 0;
      pump(c0 + q + 1, c0 + npc, cap);
    }
    slot0 = slot_next;
    par0 = par_next;
    warp_partials<CW, NG>(ce, red + (2 * kResWarps + warp) * C, lane, cg);
    __syncthreads();
    if (tid < C) {
      float sum = 0.f;
      for (int ww = 0; ww < kResWarps; ++ww)
        sum += red[(2 * kResWarps + ww) * C + tid];
      const long long col = col0 + tid;
      if (col < E) cert[col] = sum;
    }
  }
}

template <typename T, int C>
int launch_cols(const T* x, long long R, long long E, int n_sm,
                const float* rep, const float* fill, const float* rep_sum,
                const float* full_total, float lo, float hi, float* raw,
                float* out, float* cert, float* pcol, cudaStream_t s) {
  constexpr int G = group_rows<T, C>();
  constexpr int GB = granule_bytes<T, C>();
  static_assert(res_smem_bytes<T, C>() <= kSmemPerBlock,
                "the ring exceeds a block's shared memory");
  // the panel's chunks must fit the ring; the ring takes them and at most
  // kSpareSlots more, and no more shared memory than that, so that the
  // rest of the SM's 256 KB serves as L1 (the reputation's rows)
  const long long nr = (R + G - 1) / G;
  const long long npc = (nr + chunk_rows<T, C>() - 1) / chunk_rows<T, C>();
  if (npc > ring_slots<T, C>()) return static_cast<int>(cudaErrorInvalidValue);
  const int ns = static_cast<int>(npc + kSpareSlots < ring_slots<T, C>()
                                      ? npc + kSpareSlots
                                      : ring_slots<T, C>());
  const int smem = aux_bytes<C>() + ns * chunk_rows<T, C>() * kResThreads * GB;
  // the attributes follow smem (R's chunks): set them only when this
  // device's last launch of the instantiation took another size
  static std::atomic<int> last_smem[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || last_smem[dev].load() != smem) {
    err = cudaFuncSetAttribute(resolve_cols_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        resolve_cols_kernel<T, C>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        ((smem + 1024) * 100 + kSmemPerSm - 1) / kSmemPerSm);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) last_smem[dev].store(smem);
  }
  const bool vec = (E * static_cast<long long>(sizeof(T))) % GB == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % GB) == 0;
  const long long n_panels = (E + C - 1) / C;
  const unsigned grid = static_cast<unsigned>(
      n_panels < n_sm ? n_panels : static_cast<long long>(n_sm));
  resolve_cols_kernel<T, C><<<grid, kResThreads, smem, s>>>(
      x, R, E, ns, vec ? 1 : 0, rep, fill, rep_sum, full_total, lo, hi, raw,
      out, cert, pcol);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resolve_cols(const T* x, long long R, long long E, int C, int n_sm,
                 const float* rep, const float* fill,
                 const float* rep_sum, const float* full_total, float lo,
                 float hi, float* raw, float* out, float* cert, float* pcol,
                 cudaStream_t s) {
  if (E <= 0) return 0;
  switch (C) {
#define PYC_COLS(CC)                                                        \
  case CC:                                                                  \
    return launch_cols<T, CC>(x, R, E, n_sm, rep, fill, rep_sum, full_total, \
                              lo, hi, raw, out, cert, pcol, s);
    PYC_COLS(1)
    PYC_COLS(2)
    PYC_COLS(4)
    PYC_COLS(8)
    PYC_COLS(16)
    PYC_COLS(32)
#undef PYC_COLS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// storage: 0 float32 (NaN absent), 1 int8 sentinel, 2 bfloat16 (NaN
// absent); C: panel width in {1, 2, 4, 8, 16, 32}, whose panel's chunks
// must fit the ring at this R; n_sm: blocks of the persistent grid (one an
// SM); rep_sum = sum(rep) and full_total, each one float on the device; lo
// / hi: the catch band's f32 bounds 0.5 -/+ (tolerance + atol).
int pyc_resolve_cols(const void* x, int storage, long long R, long long E,
                     int C, int n_sm, const float* rep,
                     const float* fill, const float* rep_sum,
                     const float* full_total, float lo, float hi, float* raw,
                     float* out, float* cert, float* pcol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (storage) {
    case 0:
      return resolve_cols(static_cast<const float*>(x), R, E, C, n_sm, rep,
                          fill, rep_sum, full_total, lo, hi, raw, out, cert,
                          pcol, s);
    case 1:
      return resolve_cols(static_cast<const int8_t*>(x), R, E, C, n_sm, rep,
                          fill, rep_sum, full_total, lo, hi, raw, out, cert,
                          pcol, s);
    case 2:
      return resolve_cols(static_cast<const __nv_bfloat16*>(x), R, E, C,
                          n_sm, rep, fill, rep_sum, full_total, lo, hi, raw,
                          out, cert, pcol, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
