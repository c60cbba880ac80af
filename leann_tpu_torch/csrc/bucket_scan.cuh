// Bucket-major IVF scan for Hopper (sm_90a), shared by kernels B2
// (`ivf8_scan.cu`, int8 residual rows) and B4 (`ivf_bucket_dots.cu`, bf16
// rows). Each source includes this header once and exports its own C
// interface.
//
// Work list. The wrapper sorts the flattened probes [B * P] by bucket,
// stably, on the device (probes outside [0, K) as key K, one more group);
// `pairs` holds the pair ids b * P + j in that order. `items_kernel` (one
// CTA) turns the sorted keys into the items: each bucket's pairs cut
// into runs of at most `qmax`, as [n_items, 3] (bucket, first position in
// `pairs`, count), then (K, n, 0) for the unused tail of the grid. It
// gives the list of `ops/bucket_kernels.py:bucket_worklist` exactly, in
// one launch where the torch ops take some 20.
//
// One CTA per item: 8 consumer warps and one producer warp.
//   1. The producer warp streams the bucket's rows into a ring of
//      kStages shared-memory slots with bulk copies (cp.async.bulk, the
//      copy engine's own requests): a whole tile in one copy where D is a
//      multiple of 32 and one column step holds whole rows, else one copy
//      per row; B2's scale, nsq and ids in three more. Each slot has a
//      full barrier (the copies complete on it) and an empty barrier
//      (each consumer warp arrives when done with the slot), so no step
//      waits for the whole CTA. Where the rows or the table do not meet
//      the bulk copy's 16-byte rule, the producer copies single elements.
//      Meanwhile the consumers stage the item's queries once, [qmax, Dp]
//      with Dp = D rounded up to 32 and zeros beyond D: B4 bf16(q); B2
//      bf16(q) times a power of two 2^e that puts its largest element in
//      [2^14, 2^15), as fp16 (exact), with 2^-e kept to undo it, and the
//      centroid term <cent[c], q> in float32, summed in the order of the
//      earlier design.
//   2. The rows stream through a ring of kStages tiles of R rows (128 for
//      B2, 64 for B4) by kc columns (kc from D, so that a stage stays
//      under kStageBytes; D = 768 takes several column steps per row
//      tile). The next tiles are in flight while this one is scored.
//   3. Products on the tensor cores: mma.sync m16n8k16 with float32
//      accumulators, bf16 for B4 and fp16 for B2. Warp w takes the 16 rows
//      w % (R / 16) of the tile as A and every (8 / (R / 16))-th of the
//      item's n-tiles of 8 queries, from the (w / (R / 16))-th on, as B.
//      B2's int8 values become fp16 exactly (a byte permute under the
//      exponent of 1024, then one subtraction per pair), once per tile,
//      and serve every n-tile. Inside each 32-column chunk lane t of a quad
//      loads columns 8t..8t+7 of its rows and of its query; the k slots of
//      the instruction are assigned to columns in that order, for A and B
//      alike, which leaves the sum over k unchanged. Products of bf16
//      pairs, and of int8 with fp16, are exact in float32.
//   4. Epilogue from the accumulator fragments: B4 writes the dots, B2
//      cdot + (acc * 2^-e) * scale, for l2 2 * that - nsq, -inf where
//      ids == -1. Each store instruction writes 8 consecutive rows of 4
//      queries (four whole 32-byte sectors). An item of out-of-range
//      probes writes NaN rows. No atomics: a repeat gives the same bits.
// Rows copied one by one, and the queries, are padded in shared memory so
// that the fragment loads are free of bank conflicts: bf16 (16-byte loads,
// 8 lanes over 2 rows) to a stride of 64 mod 128 bytes, int8 (8-byte
// loads, 16 lanes over 4 rows) to 32 mod 64. A tile copied whole keeps the
// rows' own stride (D = 96 int8 is conflict-free so; D = 128 bf16 reads
// with 2-way conflicts, cheaper than one copy-engine request per row).
//
// Offsets are 64-bit: at 10M x 96 the payload passes 1.3e9 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The tiling may be set at build time (-D), as the variant script
// `evals/bucket_scan_cycles.py` does.
#ifndef LEANN_BUCKET_ROWS_I8
#define LEANN_BUCKET_ROWS_I8 128
#endif
#ifndef LEANN_BUCKET_ROWS_BF16
#define LEANN_BUCKET_ROWS_BF16 64
#endif
#ifndef LEANN_BUCKET_STAGES
#define LEANN_BUCKET_STAGES 4
#endif
#ifndef LEANN_BUCKET_MIN_CTAS
#define LEANN_BUCKET_MIN_CTAS 1
#endif

namespace bucket_scan {

constexpr int kConsumers = 256;   // 8 warps on the products
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = LEANN_BUCKET_STAGES;  // tiles in the ring
constexpr int kStageBytes = 24576;    // row bytes of one stage, at most
constexpr int kQueryBytes = 32768;    // staged query bytes, at most
static_assert(kStages >= 2, "kStages");

template <bool kI8>
struct Tiling {
  static constexpr int rows = kI8 ? LEANN_BUCKET_ROWS_I8
                                  : LEANN_BUCKET_ROWS_BF16;
  static constexpr int mtiles = rows / 16;   // warps on one n-tile's rows
  static constexpr int ngroups = 8 / mtiles; // warps on one m-tile
  static_assert(rows == 32 || rows == 64 || rows == 128, "rows");
};

inline __host__ __device__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Padded stride in shared memory of a row of `bytes` bytes of elements
// of `elem` bytes (see the note above).
inline __host__ __device__ int smem_stride(int bytes, int elem) {
  int s = round_up(bytes, 16);
  while (elem == 2 ? s % 128 != 64 : s % 64 != 32) s += 16;
  return s;
}

// Pairs per item: 32, halved while the staged queries pass kQueryBytes
// (16 at D = 768), never below 8. `ops/bucket_kernels.py:_qmax` mirrors
// this.
inline int qmax_for(int D) {
  const int qs = smem_stride(round_up(D, 32) * 2, 2);
  int qmax = 32;
  while (qmax > 8 && qmax * qs > kQueryBytes) qmax /= 2;
  return qmax;
}

struct Layout {
  int dp;        // D rounded up to 32
  int kc;        // columns per stage, a multiple of 32
  int nkc;       // stages per row tile
  int a_stride;  // bytes per staged row
  int q_stride;  // bytes per staged query
  int meta;      // offset of scale, nsq, ids in a stage (B2)
  int stage;     // bytes per stage
  int q_off, o_off, c_off, e_off, bar_off, smem;
  int bulk;      // rows by cp.async.bulk (else single elements)
  int tile;      // bulk: one copy per tile (rows need no padding)
  int meta_bulk; // B2: scale, nsq, ids by cp.async.bulk
};

inline Layout make_layout(int D, int elem, int rows, int qmax, int cap,
                          bool meta, bool vec) {
  Layout L;
  L.dp = round_up(D, 32);
  const int kc = kStageBytes / (rows * elem) / 32 * 32;
  L.kc = L.dp < kc ? L.dp : kc;
  L.nkc = (L.dp + L.kc - 1) / L.kc;
  // a column step with D's zero padding must be the only one, since the
  // padding is written once
  L.bulk = vec && (D % 32 == 0 || L.nkc == 1);
  // a whole tile in one copy where a step is a whole row and D % 32 == 0
  L.tile = L.bulk && L.nkc == 1 && D % 32 == 0;
  L.meta_bulk = meta && L.bulk && (cap * 4) % 16 == 0;
  L.a_stride = L.tile ? D * elem : smem_stride(L.kc * elem, elem);
  L.q_stride = smem_stride(L.dp * 2, 2);
  L.meta = rows * L.a_stride;
  L.stage = L.meta + (meta ? 3 * rows * 4 : 0);
  L.q_off = kStages * L.stage;
  L.o_off = L.q_off + qmax * L.q_stride;  // long long [qmax] output rows
  L.c_off = L.o_off + qmax * 8;           // float [qmax] centroid terms
  L.e_off = L.c_off + qmax * 4;           // float [qmax] 2^-e (B2)
  L.bar_off = L.e_off + qmax * 4;         // uint64 [2, kStages] full, empty
  L.smem = L.bar_off + 2 * kStages * 8;
  return L;
}

struct Args {
  const float* q;          // [B, D]
  const long long* pairs;  // [B * P] pair ids, grouped by bucket
  const int32_t* items;    // [n_items, 3] (bucket, start, count)
  const void* rows;        // [K, cap, D] int8 (B2) or bf16 (B4)
  const float* scale;      // B2: [K, cap]
  const float* nsq;        // B2: [K, cap]
  const int32_t* ids;      // B2: [K, cap]
  const float* cent;       // B2: [K, D]
  float* out;              // B2: [B, P, cap]; B4: [P, B, cap]
  int B, P, K, cap, D, l2;
  Layout L;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <bool kF16>
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  if (kF16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four int8 values (little-endian in w) as two fp16 pairs, exactly: each
// byte + 128 becomes the low mantissa byte of 1024 + u (0x64XX), then
// 1152 = 1024 + 128 is subtracted.
__device__ __forceinline__ void i8x4_to_f16(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t l = __byte_perm(u, 0x64646464u, 0x4140);
  const uint32_t h = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480),
                                      __ushort_as_half(0x6480));
  const __half2 lh = __hsub2(*reinterpret_cast<const __half2*>(&l), bias);
  const __half2 hh = __hsub2(*reinterpret_cast<const __half2*>(&h), bias);
  lo = *reinterpret_cast<const uint32_t*>(&lh);
  hi = *reinterpret_cast<const uint32_t*>(&hh);
}

__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// The producer warp's copy of stage s (row tile s / nkc, column step
// s % nkc) of bucket c into ring slot s % kStages, completing on the
// slot's full barrier; B2 also copies the tile's scale, nsq and ids on the
// tile's last column step.
template <bool kI8>
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem,
                                        size_t slot0, int s) {
  constexpr int elem = kI8 ? 1 : 2;
  constexpr int R = Tiling<kI8>::rows;
  const Layout& L = a.L;
  const int lane = threadIdx.x & 31;
  const int slot = s % kStages;
  unsigned char* st = smem + slot * L.stage;
  const uint32_t full = smem_u32(smem + L.bar_off + 8 * slot);
  const int rt = s / L.nkc, kc = s - rt * L.nkc;
  const int r0 = rt * R, c0 = kc * L.kc;
  const int nr = min(R, a.cap - r0);
  const bool meta = kI8 && kc == L.nkc - 1;
  const unsigned char* rows =
      static_cast<const unsigned char*>(a.rows) + slot0 * a.D * elem;
  unsigned char* ms = st + L.meta;
  if (meta && !L.meta_bulk) {  // plain loads and stores
    float* m = reinterpret_cast<float*>(ms);
    for (int i = lane; i < nr; i += 32) {
      const size_t at = slot0 + r0 + i;
      m[i] = a.scale[at];
      m[R + i] = a.nsq[at];
      reinterpret_cast<int*>(m)[2 * R + i] = a.ids[at];
    }
  }
  if (L.bulk) {
    const int rb = min(L.kc, a.D - c0) * elem;  // bytes of a row's step
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(full, nr * rb + (meta && L.meta_bulk ? 12 * nr : 0));
    }
    __syncwarp();
    if (L.tile) {
      if (lane == 0)
        bulk_copy(smem_u32(st), rows + (size_t)r0 * a.D * elem, nr * rb,
                  full);
    } else {
      for (int r = lane; r < nr; r += 32)
        bulk_copy(smem_u32(st + r * L.a_stride),
                  rows + ((size_t)(r0 + r) * a.D + c0) * elem, rb, full);
    }
    if (meta && L.meta_bulk && lane < 3) {
      const float* src = lane == 0   ? a.scale
                         : lane == 1 ? a.nsq
                                     : reinterpret_cast<const float*>(a.ids);
      bulk_copy(smem_u32(ms + lane * R * 4), src + slot0 + r0, 4 * nr, full);
    }
  } else {
    const int cols = min(L.kc, L.dp - c0);
    for (int i = lane; i < nr * cols; i += 32) {
      const int r = i / cols, col = i - r * cols;
      const size_t g = (size_t)(r0 + r) * a.D + c0 + col;
      const bool in = c0 + col < a.D;
      if (kI8)
        st[r * L.a_stride + col] = in ? rows[g] : 0;
      else
        reinterpret_cast<uint16_t*>(st + r * L.a_stride)[col] =
            in ? reinterpret_cast<const uint16_t*>(rows)[g] : 0;
    }
    __syncwarp();  // plain stores: arrive once the warp's are all done
    if (lane == 0) {
      __threadfence_block();
      mbar_arrive(full);
    }
  }
}

// The epilogue of row tile rt for one consumer warp: rows r (this lane's
// g) and r + 8 of its m-tile, from the accumulators and, for B2, the
// tile's scale, nsq and ids in the ring slot `st`.
template <bool kI8, int NTW>
__device__ __forceinline__ void epilogue(const Args& a, unsigned char* smem,
                                         const unsigned char* st,
                                         const float (&acc)[NTW][4], int rt,
                                         int qn, int m, int ng) {
  constexpr int R = Tiling<kI8>::rows, NG = Tiling<kI8>::ngroups;
  const Layout& L = a.L;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long* obase = reinterpret_cast<const long long*>(smem + L.o_off);
  const float* cdot = reinterpret_cast<const float*>(smem + L.c_off);
  const float* qdown = reinterpret_cast<const float*>(smem + L.e_off);
  const int lr = m * 16 + g, r = rt * R + lr;
  float sc[2] = {0.f, 0.f}, ns[2] = {0.f, 0.f};
  int id[2] = {0, 0};
  if (kI8) {
    const float* ms = reinterpret_cast<const float*>(st + L.meta);
    for (int h = 0; h < 2; ++h) {
      sc[h] = ms[lr + 8 * h];
      ns[h] = ms[R + lr + 8 * h];
      id[h] = reinterpret_cast<const int*>(ms)[2 * R + lr + 8 * h];
    }
  }
#pragma unroll
  for (int jj = 0; jj < NTW; ++jj) {
    const int n0 = (jj * NG + ng) * 8;
    if (n0 >= qn) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = n0 + 2 * t + (e & 1), h = e >> 1, row = r + 8 * h;
      if (i >= qn || row >= a.cap) continue;
      float v = acc[jj][e];
      if (kI8) {
        const float dots =
            __fadd_rn(cdot[i], __fmul_rn(__fmul_rn(v, qdown[i]), sc[h]));
        v = a.l2 ? __fsub_rn(__fmul_rn(2.f, dots), ns[h]) : dots;
        if (id[h] == -1) v = __int_as_float(0xff800000);
      }
      a.out[obase[i] + row] = v;
    }
  }
}

// NTW: the most n-tiles of 8 queries one consumer warp takes (qmax /
// (8 * ngroups), at least 1).
template <bool kI8, int NTW>
__global__ void __launch_bounds__(kThreads, LEANN_BUCKET_MIN_CTAS)
scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = Tiling<kI8>::rows;
  constexpr int MT = Tiling<kI8>::mtiles, NG = Tiling<kI8>::ngroups;
  const Layout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* item = a.items + 3 * (size_t)blockIdx.x;
  const int c = item[0], start = item[1], qn = item[2];
  if (qn <= 0) return;
  long long* obase = reinterpret_cast<long long*>(smem + L.o_off);
  float* cdot = reinterpret_cast<float*>(smem + L.c_off);
  float* qdown = reinterpret_cast<float*>(smem + L.e_off);
  for (int i = tid; i < qn; i += kThreads) {
    const int pr = (int)a.pairs[start + i];
    const int b = pr / a.P, j = pr - b * a.P;
    obase[i] = (kI8 ? (long long)b * a.P + j : (long long)j * a.B + b) *
               (long long)a.cap;
  }
  if (c < 0 || c >= a.K) {  // probes outside the table: NaN, never silence
    __syncthreads();
    for (int i = 0; i < qn; ++i)
      for (int r = tid; r < a.cap; r += kThreads)
        a.out[obase[i] + r] = __int_as_float(0x7fc00000);
    return;
  }
  const size_t slot0 = (size_t)c * a.cap;
  const int steps = (a.cap + R - 1) / R * L.nkc;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(smem_u32(smem + L.bar_off + 8 * k), 1);       // full
      mbar_init(smem_u32(smem + L.bar_off + 8 * (kStages + k)),
                kConsumers / 32);                             // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (L.bulk && L.dp > a.D)  // D's zero padding, written once (nkc == 1)
    for (int i = tid; i < kStages * R * (L.dp - a.D); i += kThreads) {
      const int r = i / (L.dp - a.D), col = a.D + i % (L.dp - a.D);
      unsigned char* p = smem + (r / R) * L.stage + (r % R) * L.a_stride;
      if (kI8)
        p[col] = 0;
      else
        reinterpret_cast<uint16_t*>(p)[col] = 0;
    }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: the ring's copies
    for (int s = 0; s < steps; ++s) {
      if (s >= kStages)  // the slot's last use released by every consumer
        mbar_wait(smem_u32(smem + L.bar_off + 8 * (kStages + s % kStages)),
                  (s / kStages - 1) & 1);
      produce<kI8>(a, smem, slot0, s);
    }
    return;
  }

  // the consumers: the item's queries, once (see the note above)
  for (int i = warp; i < qn; i += kConsumers / 32) {
    const int b = (int)a.pairs[start + i] / a.P;
    const float* qr = a.q + (size_t)b * a.D;
    unsigned char* qs = smem + L.q_off + i * L.q_stride;
    float sum = 0.f, mx = 0.f;
    if (kI8) {
      for (int col = lane; col < a.D; col += 32) {
        const float v = qr[col];
        sum = __fadd_rn(sum, __fmul_rn(a.cent[(size_t)c * a.D + col], v));
        mx = fmaxf(mx, fabsf(__bfloat162float(__float2bfloat16_rn(v))));
      }
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
    }
    const int e = mx > 0.f ? max(-120, min(120, 14 - ilogbf(mx))) : 0;
    const float up = pow2(e);
    for (int col = lane; col < L.dp; col += 32) {
      const float v =
          col < a.D ? __bfloat162float(__float2bfloat16_rn(qr[col])) : 0.f;
      if (kI8)
        reinterpret_cast<__half*>(qs)[col] = __float2half_rn(v * up);
      else
        reinterpret_cast<__nv_bfloat16*>(qs)[col] = __float2bfloat16_rn(v);
    }
    if (kI8 && lane == 0) {
      cdot[i] = sum;
      qdown[i] = pow2(-e);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  const int m = warp % MT, ng = warp / MT;
  const int g = lane >> 2, t = lane & 3;
  float acc[NTW][4];
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    mbar_wait(smem_u32(smem + L.bar_off + 8 * slot), (s / kStages) & 1);
    const unsigned char* st = smem + slot * L.stage;
    const int rt = s / L.nkc, kc = s - rt * L.nkc;
    const int c0 = kc * L.kc, cols = min(L.kc, L.dp - c0);
    if (kc == 0) {
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj)
        acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
    }
    const unsigned char* ra = st + (m * 16 + g) * L.a_stride;
    const unsigned char* rb = ra + 8 * L.a_stride;
    const unsigned char* qb =
        smem + L.q_off + g * L.q_stride + (c0 + 8 * t) * 2;
    for (int kk = 0; kk < cols; kk += 32) {
      uint32_t x[8];  // A of the chunk's two k-steps: rows g, g + 8
      if (kI8) {
        const uint2 u = *reinterpret_cast<const uint2*>(ra + kk + 8 * t);
        const uint2 v = *reinterpret_cast<const uint2*>(rb + kk + 8 * t);
        i8x4_to_f16(u.x, x[0], x[2]);
        i8x4_to_f16(v.x, x[1], x[3]);
        i8x4_to_f16(u.y, x[4], x[6]);
        i8x4_to_f16(v.y, x[5], x[7]);
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(ra + (kk + 8 * t) * 2);
        const uint4 v = *reinterpret_cast<const uint4*>(rb + (kk + 8 * t) * 2);
        x[0] = u.x; x[1] = v.x; x[2] = u.y; x[3] = v.y;
        x[4] = u.z; x[5] = v.z; x[6] = u.w; x[7] = v.w;
      }
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj) {
        const int n0 = (jj * NG + ng) * 8;
        if (n0 < qn) {
          const uint4 bq = *reinterpret_cast<const uint4*>(
              qb + n0 * L.q_stride + kk * 2);
          mma<kI8>(acc[jj], x[0], x[1], x[2], x[3], bq.x, bq.y);
          mma<kI8>(acc[jj], x[4], x[5], x[6], x[7], bq.z, bq.w);
        }
      }
    }
    if (kc == L.nkc - 1) epilogue<kI8, NTW>(a, smem, st, acc, rt, qn, m, ng);
    __syncwarp();  // this warp is done with the slot
    if (lane == 0)
      mbar_arrive(smem_u32(smem + L.bar_off + 8 * (kStages + slot)));
  }
}

// The items of the work list from the sorted keys skey [n] (values in
// [0, K]): start[c] is the first position of a key >= c (in shared memory
// when K + 2 ints fit in kItemsSmem, else in the scratch `gstart`);
// group c's count cut into runs of qmax gives its items, at the offsets
// of a block-wide scan; items past the last are (K, n, 0).
constexpr int kItemsSmem = 96 * 1024;

__global__ void __launch_bounds__(1024)
items_kernel(const int32_t* __restrict__ skey, int n, int K, int qmax,
             int G, int32_t* __restrict__ gstart,
             int32_t* __restrict__ items) {
  extern __shared__ int sstart[];
  __shared__ int wsum[32];
  int* start = (K + 2) * 4 <= kItemsSmem ? sstart : gstart;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = tid; p <= n; p += 1024) {
    const int hi = p < n ? skey[p] : K + 1;
    for (int c = p > 0 ? skey[p - 1] + 1 : 0; c <= hi; ++c) start[c] = p;
  }
  __syncthreads();
  const int per = (K + 1 + 1023) / 1024;
  const int c0 = min(K + 1, tid * per), c1 = min(K + 1, c0 + per);
  int sum = 0;
  for (int c = c0; c < c1; ++c)
    sum += (start[c + 1] - start[c] + qmax - 1) / qmax;
  int v = sum;  // inclusive scan: in the warp, then over the warps
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int off = v - sum + (warp ? wsum[warp - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    const int s = start[c], cnt = start[c + 1] - s;
    for (int k = 0; k < cnt && off < G; k += qmax, ++off) {
      items[3 * off] = c;
      items[3 * off + 1] = s + k;
      items[3 * off + 2] = min(qmax, cnt - k);
    }
  }
  for (int i = wsum[31] + tid; i < G; i += 1024) {
    items[3 * i] = K;
    items[3 * i + 1] = n;
    items[3 * i + 2] = 0;
  }
}

inline cudaError_t launch_items(const int32_t* skey, int n, int K, int qmax,
                                int G, int32_t* start, int32_t* items,
                                cudaStream_t st) {
  if (G <= 0) return cudaSuccess;
  const int smem = (K + 2) * 4 <= kItemsSmem ? (K + 2) * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  items_kernel<<<1, 1024, smem, st>>>(skey, n, K, qmax, G, start, items);
  return cudaGetLastError();
}

template <bool kI8>
inline const void* kernel_for(int qmax) {
  switch (qmax / (8 * Tiling<kI8>::ngroups)) {
    case 8: return (const void*)scan_kernel<kI8, 8>;
    case 4: return (const void*)scan_kernel<kI8, 4>;
    case 2: return (const void*)scan_kernel<kI8, 2>;
    default: return (const void*)scan_kernel<kI8, 1>;
  }
}

// Checks the arguments, builds the items from the sorted keys `skey`
// into `items` [n_items, 3] (scratch `start`, K + 2) and launches one CTA
// per item on `stream`. Returns a cudaError_t (0 = launched).
template <bool kI8>
inline int launch(Args a, const int32_t* skey, int32_t* start,
                  int32_t* items, int n_items, int qmax, int vec,
                  void* stream) {
  const int elem = kI8 ? 1 : 2;
  const long long n = (long long)a.B * a.P;
  if (qmax != qmax_for(a.D) || a.B < 0 || a.P <= 0 || a.D <= 0 ||
      a.K <= 0 || n >= (1LL << 31) ||
      n_items != (n + qmax - 1) / qmax + (a.K < n ? a.K : n) ||
      (vec && ((a.D * elem) % 16 ||
               reinterpret_cast<uintptr_t>(a.rows) % 16)))
    return (int)cudaErrorInvalidValue;
  a.items = items;
  a.L = make_layout(a.D, elem, Tiling<kI8>::rows, qmax, a.cap, kI8, vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_items(skey, (int)n, a.K, qmax, n_items, start,
                                 items, st);
  if (err != cudaSuccess) return (int)err;
  const void* fn = kernel_for<kI8>(qmax);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             a.L.smem);
  if (err != cudaSuccess || n_items <= 0 || a.cap <= 0) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchKernel(fn, dim3(n_items), dim3(kThreads), params,
                         a.L.smem, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident CTAs per SM at width D (registers and shared memory), with
// the 16-byte path's layout.
template <bool kI8>
inline int ctas_per_sm(int D) {
  const int qmax = qmax_for(D);
  const Layout L = make_layout(D, kI8 ? 1 : 2, Tiling<kI8>::rows, qmax, 16,
                               kI8, true);
  const void* fn = kernel_for<kI8>(qmax);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L.smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                    L.smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace bucket_scan

// The work list's items alone (the card tests hold them against
// `bucket_worklist`): skey [n] sorted keys in [0, K], start scratch
// [K + 2], items [G, 3].
extern "C" int leann_bucket_items(const int32_t* skey, int n, int K,
                                  int qmax, int G, int32_t* start,
                                  int32_t* items, void* stream) {
  if (n < 0 || K <= 0 || qmax <= 0) return (int)cudaErrorInvalidValue;
  return (int)bucket_scan::launch_items(skey, n, K, qmax, G, start, items,
                                        static_cast<cudaStream_t>(stream));
}
