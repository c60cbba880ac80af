// Row-gather scoring for Hopper (sm_90a): kernel B5.
//
// Replaces the TPU kernel `leann_tpu/ops/gather_score.py:_make_kernel`,
// launched there by `_gather_score_call` / `gather_score` (the measured
// side of `evals/gather_roofline.py`). It computes
//
//   out[b, j] = sum_d bf16(q[b, d]) * corpus[ids[b, j], d]
//
// for the int8 corpus [N, D] (each value read as its integer), ids
// [B, R] int32 and q [B, D] f32, with float32 products and sums; out is
// [B, R] f32. Callers fold per-row dequantization scales outside.
//
// Bound. Bytes: B*R random rows of D bytes, plus the ids, the queries and
// the output, each once (2*D operations per row are far below the fp32
// rate). At 10M x 128, B=2048, R=48 that is 12.6 MB of 128-byte rows:
// 3.8 us at 3.35 TB/s. Such a kernel is short, so what it loses is
// latency (every round trip to memory that a CTA waits through in turn,
// every SM that idles while the last CTAs finish) and instruction rate:
// the scores take about 3 instructions per int8 value on the CUDA cores.
//
// Design (`gather_score_staged`, D % 16 == 0 and a 16-byte aligned
// corpus and query). The TPU kernel starts one DMA descriptor per row
// and waits for all of them once; here a tile is qpc queries x rps of
// their rows, and a CTA stages a tile in shared memory in two round trips:
// one coalesced read of the tile's ids and queries into registers (every
// load started before any is used; the queries rounded to bf16 there, once),
// then one 16-byte `cp.async.cg` per row chunk (past L1), all in one
// commit group. The grid is persistent, `ctas_per_sm` CTAs on each SM,
// sized so that a CTA gets about two tiles, and its CTAs walk over the
// tiles through a two-stage ring: a CTA reads its first two tiles' ids at
// once and puts both tiles' rows in flight, so it waits through the two
// round trips once; from then on, while tile i is scored, tile i+1's rows
// land and tile i+2's ids and queries load. Rows longer than the stage
// budget are staged in chunks of rps rows (tiles of one query's rows).
// Scoring stays on the CUDA cores: each row is a dot product with a query
// that no other query's row shares, so tensor cores would buy nothing. A
// group of G lanes (the largest power of two <= min(8, D / 16)) takes a
// block of RG = G / 2 rows of one query (1 where G is 1): each lane reads
// its 16-byte chunks of the RG rows from shared memory and the query's
// matching chunk once for all of them; an int8 value becomes its float
// by a byte permute into 2^23 + (x + 128) and one subtraction, both exact,
// then an FMA with the query (int8 x bf16 products are exact in float32,
// so each FMA rounds only its running sum; two sums a row, even and odd
// values, keep two FMA chains in flight), and log2(G) levels of shuffles,
// the first exchanging half of a lane's rows, leave each row's sum on one
// lane, which writes it.
//
// Other rows (`gather_score_rowwise`: D % 16 != 0 or a corpus not 16-byte
// aligned) keep the first design: one CTA per query, 4-byte or single
// byte loads straight from global memory. The wrapper chooses by shape.
//
// Any B, R and D. Row offsets are 64-bit: ids * D passes 2^31 at 17M x
// 128. An id outside [0, N) yields NaN and is never read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;       // staged kernel
constexpr int kMinCtas = 4;         // per SM: at most 64 registers a thread
constexpr int kIdsPerPass = 4;      // a tile holds <= 4 * kThreads rows
constexpr int kQPerPass = 1;        // query float4s a thread holds
constexpr int kRowThreads = 128;    // per-row kernel
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// n / d for 0 <= n < 2^31 as (umulhi(n, m) + n) >> l (Granlund and
// Montgomery), m and l made on the host: a kernel parameter, so the
// divisions of the tile bookkeeping cost two integer instructions.
struct Div {
  unsigned m, l;
};

Div make_div(unsigned d) {
  unsigned l = 0;
  while ((1u << l) < d) ++l;
  return {(unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1), l};
}

__device__ __forceinline__ int operator/(int n, Div v) {
  return (int)((__umulhi((unsigned)n, v.m) + (unsigned)n) >> v.l);
}

struct Tile {
  const int8_t* corpus;
  const int32_t* ids;
  const float* q;
  float* out;
  long long n;
  int b, r, d, qpc, rps, chunks, tiles, stage_bytes;
  Div by_rps, by_cpr, by_qchunks, by_chunks, by_blocks;
  // per stage: rows [qpc * rps, D] int8, queries [qpc, D] f32 (rounded to
  // bf16), ids [qpc * rps] int32
  __device__ int rows() const { return qpc * rps; }
  __device__ int q_off() const { return rows() * d; }
  __device__ int id_off() const { return rows() * d + qpc * d * 4; }
  __device__ int b0(int t) const { return (t / by_chunks) * qpc; }
  __device__ int j0(int t) const {
    return (t - (t / by_chunks) * chunks) * rps;
  }
  // slot k = qi * rps + j of tile t holds a (query, row) of the batch
  __device__ bool live(int t, int qi, int j) const {
    return b0(t) + qi < b && j0(t) + j < r;
  }
  __device__ bool inside(int id) const { return id >= 0 && id < n; }
};

// A tile's ids and queries in registers, loaded a tile ahead: id slot
// threadIdx.x + u * kThreads, query float4 threadIdx.x + u * kThreads.
struct Staged {
  int id[kIdsPerPass];
  float4 q[kQPerPass];
};

__device__ __forceinline__ float4 load_q4(const Tile p, int t, int e) {
  const int qi = e / p.by_qchunks;
  return __ldg(reinterpret_cast<const float4*>(
      p.q + (size_t)(p.b0(t) + qi) * p.d) + (e - qi * (p.d >> 2)));
}

__device__ __forceinline__ bool q_live(const Tile p, int t, int e) {
  return e < p.qpc * (p.d >> 2) && p.b0(t) + e / p.by_qchunks < p.b;
}

// Load tile t's ids and (the first kQPerPass * kThreads float4s of) its
// queries: every load started before any is used, one round trip.
__device__ __forceinline__ void load_tile(const Tile p, int t, Staged& x) {
  const int rows = p.rows(), b0 = p.b0(t), j0 = p.j0(t);
#pragma unroll
  for (int u = 0; u < kIdsPerPass; ++u) {
    const int k = u * kThreads + threadIdx.x;
    x.id[u] = -1;
    if (u * kThreads < rows && k < rows) {
      const int qi = k / p.by_rps, j = k - qi * p.rps;
      if (p.live(t, qi, j))
        x.id[u] = __ldg(p.ids + (size_t)(b0 + qi) * p.r + j0 + j);
    }
  }
#pragma unroll
  for (int u = 0; u < kQPerPass; ++u) {
    const int e = u * kThreads + threadIdx.x;
    if (q_live(p, t, e)) x.q[u] = load_q4(p, t, e);
  }
}

__device__ __forceinline__ float4 round4(float4 x) {
  return make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                     bf16_round(x.w));
}

// Store tile t's ids and its queries, rounded to bf16, into stage st; a
// query block longer than the registers hold (qpc * D > 4 * kQPerPass *
// kThreads) loads the rest here.
__device__ __forceinline__ void store_tile(const Tile p, unsigned char* st,
                                           int t, const Staged& x) {
  int* sid = reinterpret_cast<int*>(st + p.id_off());
  float4* qs = reinterpret_cast<float4*>(st + p.q_off());
#pragma unroll
  for (int u = 0; u < kIdsPerPass; ++u) {
    const int k = u * kThreads + threadIdx.x;
    if (u * kThreads < p.rows() && k < p.rows()) sid[k] = x.id[u];
  }
#pragma unroll
  for (int u = 0; u < kQPerPass; ++u) {
    const int e = u * kThreads + threadIdx.x;
    if (q_live(p, t, e)) qs[e] = round4(x.q[u]);
  }
  for (int e = kQPerPass * kThreads + threadIdx.x; q_live(p, t, e);
       e += kThreads)
    qs[e] = round4(load_q4(p, t, e));
}

// One cp.async per 16-byte chunk of each live row of tile t whose id lies
// in [0, N), into stage st (the ids already there and visible to every
// thread).
__device__ __forceinline__ void copy_rows(const Tile p, unsigned char* st,
                                          int t) {
  const int* sid = reinterpret_cast<const int*>(st + p.id_off());
  const int cpr = p.d >> 4;                      // 16-byte chunks of a row
  for (int k = threadIdx.x; k < p.rows() * cpr; k += kThreads) {
    const int row = k / p.by_cpr, qi = row / p.by_rps;
    const int id = sid[row];
    if (p.live(t, qi, row - qi * p.rps) && p.inside(id))
      cp_async16(st + (size_t)k * 16,
                 p.corpus + (long long)id * p.d + (k - row * cpr) * 16);
  }
}

// The integer value of byte `sel` of a word whose bytes were XORed with
// 0x80: the float 2^23 + (x + 128) built by a byte permute, less
// 2^23 + 128, exactly, on the integer and FMA pipes (no I2F).
__device__ __forceinline__ float byte_value(unsigned u, unsigned sel) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | sel)) -
         8388736.0f;
}

// a0 / a1 += <16 int8 values of v, 16 query values of f[0..3]>, the
// even and odd values in two sums, so that two FMA chains run at once
__device__ __forceinline__ void dot16(const int4 v, const float4 (&f)[4],
                                      float& a0, float& a1) {
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u,
                         (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u,
                         (unsigned)v.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a0 = fmaf(byte_value(w[k], 0), f[k].x, a0);
    a1 = fmaf(byte_value(w[k], 1), f[k].y, a1);
    a0 = fmaf(byte_value(w[k], 2), f[k].z, a0);
    a1 = fmaf(byte_value(w[k], 3), f[k].w, a1);
  }
}

// Score tile t from stage st. The tile's rows are cut into blocks of RG
// rows of one query, and a group of G lanes takes a block at a time: lane
// l adds chunks l, l + G, ... of each of the RG rows against the query's
// same chunks (read once for the RG rows). Then log2(G) shuffle levels
// sum each row's G partial sums; the first log2(RG) of them exchange
// half of a lane's rows each, so that row i's sum ends on lanes
// i * G / RG, ..., which the first of them writes.
template <int G, int RG>
__device__ __forceinline__ void score(const Tile p, const unsigned char* st,
                                      int t) {
  const int* sid = reinterpret_cast<const int*>(st + p.id_off());
  const float4* qs = reinterpret_cast<const float4*>(st + p.q_off());
  const int b0 = p.b0(t), j0 = p.j0(t);
  const int cpr = p.d >> 4, per_q = p.d >> 2;
  constexpr int kGroups = kThreads / G;
  const int g = threadIdx.x / G, gl = threadIdx.x % G;
  const int blocks = (p.rps + RG - 1) / RG;      // row blocks of a query
  const int items = p.qpc * blocks;
  // trip counts are the same for every lane, so the shuffles see all 32
  for (int i0 = 0; i0 < items; i0 += kGroups) {
    const int item = i0 + g;
    const int qi = item / p.by_blocks, jb = (item - qi * blocks) * RG;
    const bool qlive = item < items && b0 + qi < p.b;
    const int nr = qlive ? min(RG, p.rps - jb) : 0;
    // a block's rows past nr (beyond the query's run) read its first row
    // again, so every lane runs the same straight-line code
    const int4* row[RG];
    float a0[RG], a1[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      row[r] = reinterpret_cast<const int4*>(
          st + (size_t)(qi * p.rps + jb + (r < nr ? r : 0)) * p.d);
      a0[r] = a1[r] = 0.f;
    }
    for (int ch = gl; ch < cpr && nr > 0; ch += G) {
      const float4* qc = qs + qi * per_q + ch * 4;
      const float4 f[4] = {qc[0], qc[1], qc[2], qc[3]};
#pragma unroll
      for (int r = 0; r < RG; ++r) dot16(row[r][ch], f, a0[r], a1[r]);
    }
    float part[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) part[r] = a0[r] + a1[r];
#pragma unroll
    for (int i = 0; (G >> (i + 1)) > 0; ++i) {
      const int off = G >> (i + 1), half = RG >> (i + 1);
      if (half > 0) {
        const bool upper = gl & off;
#pragma unroll
        for (int r = 0; r < half; ++r) {
          const float send = upper ? part[r] : part[r + half];
          const float keep = upper ? part[r + half] : part[r];
          part[r] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      } else {
        part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
      }
    }
    const int jr = gl / (G / RG);
    if (gl % (G / RG) == 0 && jr < nr && j0 + jb + jr < p.r) {
      const int id = sid[qi * p.rps + jb + jr];
      p.out[(size_t)(b0 + qi) * p.r + j0 + jb + jr] =
          p.inside(id) ? part[0] : __int_as_float(0x7fc00000);
    }
  }
}

// The ring: a CTA loads its first two tiles' ids and queries at once (one
// round trip) and stages both; then, each time a tile is scored, its stage
// takes tile t + 2 grid, whose ids and queries were loaded into registers
// while tile t was awaited and scored.
template <int G, int RG>
__global__ void __launch_bounds__(kThreads, kMinCtas)
gather_score_staged(const Tile p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = gridDim.x;
  int t = blockIdx.x;
  if (t >= p.tiles) return;
  Staged x, y;
  load_tile(p, t, x);
  if (t + stride < p.tiles) load_tile(p, t + stride, y);
  store_tile(p, smem, t, x);
  if (t + stride < p.tiles) store_tile(p, smem + p.stage_bytes, t + stride, y);
  __syncthreads();
  copy_rows(p, smem, t);
  cp_commit();
  if (t + stride < p.tiles) copy_rows(p, smem + p.stage_bytes, t + stride);
  cp_commit();
  if (t + 2 * stride < p.tiles) load_tile(p, t + 2 * stride, x);
  for (int s = 0; t < p.tiles; t += stride, s ^= 1) {
    unsigned char* st = smem + s * p.stage_bytes;
    cp_wait_all_but_one();           // tile t's copies have landed
    __syncthreads();
    score<G, RG>(p, st, t);
    __syncthreads();                 // stage s is free again
    const int refill = t + 2 * stride;
    if (refill < p.tiles) {
      store_tile(p, st, refill, x);
      __syncthreads();
      copy_rows(p, st, refill);
    }
    cp_commit();                     // empty past the last tile
    if (refill + stride < p.tiles) load_tile(p, refill + stride, x);
  }
}

// The first design, for rows the staged kernel does not take: one CTA per
// query, G lanes per row reading W bytes each (4 or 1) from global memory.
__global__ void __launch_bounds__(kRowThreads)
gather_score_rowwise(const int8_t* __restrict__ corpus,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ q, float* __restrict__ out,
                     long long N, int R, int D, int W, int G) {
  extern __shared__ float qs[];  // [D] bf16-rounded query
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < D; i += kRowThreads)
    qs[i] = bf16_round(q[(size_t)b * D + i]);
  __syncthreads();

  const int rows = 32 / G;       // rows per warp and step
  const int sub = lane / G, gl = lane % G;
  for (int j0 = warp * rows; j0 < R; j0 += (kRowThreads / 32) * rows) {
    const int j = j0 + sub;
    float acc = 0.f;
    if (j < R) {
      const long long id = ids[(size_t)b * R + j];
      if (id < 0 || id >= N) {
        acc = __int_as_float(0x7fc00000);
      } else {
        const int8_t* row = corpus + id * D;
        if (W == 4) {
          for (int ch = gl; ch < D / 4; ch += G) {
            const int v = __ldg(reinterpret_cast<const int*>(row) + ch);
            const int8_t* x = reinterpret_cast<const int8_t*>(&v);
            const float* qq = qs + ch * 4;
#pragma unroll
            for (int k = 0; k < 4; ++k) acc = fmaf((float)x[k], qq[k], acc);
          }
        } else {
          for (int i = gl; i < D; i += G)
            acc = fmaf((float)row[i], qs[i], acc);
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (j < R && gl == 0) out[(size_t)b * R + j] = acc;
  }
}

std::atomic<bool> g_smem_set[kMaxDevices];

// Raise every kernel's dynamic shared-memory cap to the card's limit, once
// per device (the cap is a ceiling: it does not change occupancy).
int ensure_smem_cap(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (g_smem_set[dev].load(std::memory_order_acquire)) return 0;
  const void* kernels[] = {
      reinterpret_cast<const void*>(gather_score_staged<1, 1>),
      reinterpret_cast<const void*>(gather_score_staged<2, 1>),
      reinterpret_cast<const void*>(gather_score_staged<4, 2>),
      reinterpret_cast<const void*>(gather_score_staged<8, 4>),
      reinterpret_cast<const void*>(gather_score_rowwise)};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit);
    if (err != cudaSuccess) return (int)err;
  }
  g_smem_set[dev].store(true, std::memory_order_release);
  return 0;
}

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The staged kernel on `stream` with the wrapper's launch plan
// (`ops/gather_score.py:launch_plan`): qpc queries and rps rows of each
// per tile, `chunks` tiles per group of qpc queries, `grid` CTAs and
// `stage_bytes` of shared memory per stage (two stages); at most 4 * 256
// rows a tile. D % 16 == 0 and the corpus and the queries 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int leann_gather_score(const int8_t* corpus, const int32_t* ids,
                                  const float* q, float* out, long long N,
                                  int B, int R, int D, int qpc, int rps,
                                  int chunks, int grid, int stage_bytes,
                                  void* stream) {
  if (D <= 0 || D % 16 || N < 0 || qpc < 1 || rps < 1 || chunks < 1 ||
      (long long)rps * chunks < R || grid < 1 || stage_bytes % 16 ||
      (reinterpret_cast<uintptr_t>(corpus) & 15) ||
      (reinterpret_cast<uintptr_t>(q) & 15))
    return (int)cudaErrorInvalidValue;
  const long long need = (long long)qpc * rps * D + (long long)qpc * D * 4 +
                         (long long)qpc * rps * 4;
  if (stage_bytes < need || (long long)qpc * rps > kIdsPerPass * kThreads)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const int err = ensure_smem_cap(&limit);
  if (err) return err;
  const long long smem = 2LL * stage_bytes;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  if (B <= 0 || R <= 0) return 0;
  const long long tiles = (long long)((B + qpc - 1) / qpc) * chunks;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int G = 1;                           // lanes a row, RG = G / 2 rows a block
  while (G < 8 && 2 * G <= D / 16) G *= 2;
  const int RG = G > 1 ? G / 2 : 1;
  const Tile p{corpus, ids, q, out, N, B, R, D, qpc, rps, chunks,
               (int)tiles, stage_bytes, make_div(rps), make_div(D / 16),
               make_div(D / 4), make_div(chunks),
               make_div((rps + RG - 1) / RG)};
  const dim3 blocks(grid < tiles ? grid : (int)tiles);
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 1: gather_score_staged<1, 1><<<blocks, kThreads, smem, st>>>(p); break;
    case 2: gather_score_staged<2, 1><<<blocks, kThreads, smem, st>>>(p); break;
    case 4: gather_score_staged<4, 2><<<blocks, kThreads, smem, st>>>(p); break;
    default: gather_score_staged<8, 4><<<blocks, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// The per-row kernel on `stream`: one CTA per query; W the bytes per lane
// load (4 or 1; D % W == 0 and the corpus W-aligned), G the lanes per row
// (a power of two <= 32). Returns cudaGetLastError() after the launch.
extern "C" int leann_gather_score_rowwise(const int8_t* corpus,
                                          const int32_t* ids, const float* q,
                                          float* out, long long N, int B,
                                          int R, int D, int W, int G,
                                          void* stream) {
  if ((W != 4 && W != 1) || G < 1 || G > 32 || (G & (G - 1)) || D <= 0 ||
      D % W || N < 0 || (reinterpret_cast<uintptr_t>(corpus) % W))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const int err = ensure_smem_cap(&limit);
  if (err) return err;
  const long long smem = (long long)D * sizeof(float);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  if (B <= 0 || R <= 0) return 0;
  gather_score_rowwise<<<B, kRowThreads, (size_t)smem,
                         (cudaStream_t)stream>>>(corpus, ids, q, out, N, R, D,
                                                 W, G);
  return (int)cudaGetLastError();
}
