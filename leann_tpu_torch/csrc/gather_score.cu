// Row-gather scoring for Hopper (sm_90a): kernel B5.
//
// Replaces the TPU kernel `leann_tpu/ops/gather_score.py:_make_kernel`,
// launched there by `_gather_score_call` / `gather_score` (the measured
// side of `evals/gather_roofline.py`). It computes
//
//   out[b, j] = sum_d bf16(q[b, d]) * corpus[ids[b, j], d]
//
// for the int8 corpus [N, D] (each value read as its integer), ids
// [B, R] int32 and q [B, D] f32, with float32 accumulation; out is
// [B, R] f32. Callers fold per-row dequantization scales outside.
//
// Design. The TPU kernel issues one DMA descriptor per (query, neighbour)
// row and waits for all of a block before one small matrix product; its
// shapes (D and R padded to 128 lanes, B % qb == 0) are the TPU's tiling.
// Here a CTA of 128 threads takes one query: the query, rounded to bf16
// and held as float, sits in shared memory, and the R rows are dealt to
// groups of G lanes (G = the largest power of two <= min(32, D / W)).
// Lane j of a group reads chunks j, j+G, ... of its row, W bytes each:
// 16 where D % 16 == 0 (a 128-byte row is eight lanes' loads,
// neighbouring lanes on neighbouring addresses, a warp covers 32/G whole
// rows), 4 where D % 4 == 0, else single bytes. int8 x bf16 products are
// exact in float32, so each FMA rounds only the running sum; a butterfly
// of shuffles adds the G partial sums. Any B, any R, any D; nothing is
// padded.
//
// Bound. Bytes: B*R rows of D bytes, the ids, the queries and the output,
// each once. The rows are random 64-128 byte reads, so what limits the
// kernel is how many such reads the memory system keeps in flight, not
// arithmetic (2*D operations per row).
//
// Row offsets are 64-bit: ids * D passes 2^31 at 100M x 96. Ids are
// trusted to lie in [0, N); one that does not yields NaN, never a read
// outside the corpus.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_score_kernel(const int8_t* __restrict__ corpus,
                    const int32_t* __restrict__ ids,
                    const float* __restrict__ q, float* __restrict__ out,
                    long long N, int R, int D, int W, int G) {
  extern __shared__ float qs[];  // [D] bf16-rounded query
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < D; i += kThreads)
    qs[i] = __bfloat162float(__float2bfloat16_rn(q[(size_t)b * D + i]));
  __syncthreads();

  const int rows = 32 / G;       // rows per warp and step
  const int sub = lane / G, gl = lane % G;
  for (int j0 = warp * rows; j0 < R; j0 += kWarps * rows) {
    const int j = j0 + sub;
    float acc = 0.f;
    if (j < R) {
      const long long id = ids[(size_t)b * R + j];
      if (id < 0 || id >= N) {
        acc = __int_as_float(0x7fc00000);
      } else {
        const int8_t* row = corpus + (size_t)id * D;
        if (W == 16) {
          for (int ch = gl; ch < D / 16; ch += G) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(row) + ch);
            const int8_t* p = reinterpret_cast<const int8_t*>(&v);
            const float* qq = qs + ch * 16;
#pragma unroll
            for (int k = 0; k < 16; ++k) acc = fmaf((float)p[k], qq[k], acc);
          }
        } else if (W == 4) {
          for (int ch = gl; ch < D / 4; ch += G) {
            const int v = __ldg(reinterpret_cast<const int*>(row) + ch);
            const int8_t* p = reinterpret_cast<const int8_t*>(&v);
            const float* qq = qs + ch * 4;
#pragma unroll
            for (int k = 0; k < 4; ++k) acc = fmaf((float)p[k], qq[k], acc);
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

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches one CTA per query on `stream`; W is the bytes per lane load
// (16, 4 or 1; D % W == 0 and the corpus W-aligned), G the lanes per row
// (a power of two <= 32). Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int leann_gather_score(const int8_t* corpus, const int32_t* ids,
                                  const float* q, float* out, long long N,
                                  int B, int R, int D, int W, int G,
                                  void* stream) {
  if ((W != 16 && W != 4 && W != 1) || G < 1 || G > 32 || (G & (G - 1)) ||
      D <= 0 || D % W || N < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || R <= 0) return 0;
  gather_score_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      corpus, ids, q, out, N, R, D, W, G);
  return (int)cudaGetLastError();
}
