// IVF bucket dot products for Hopper (sm_90a): kernel B4.
//
// The earlier design of kernel B4, one CTA per (query, probe), kept as
// the yardstick of `ivf_bucket_dots.cu` (the bucket-major design that
// replaced it). Nothing in the package calls it: `chip_smoke.py` builds
// it beside the current source, times the two in turns and holds them
// to each other, as do the card tests. Its C interface is unchanged.
//
// Replaces the TPU kernel `leann_tpu/ops/pallas_kernels.py:
// _bucket_dots_kernel`, launched there by `ivf_bucket_dots` (the scan of
// `ivf_search_pallas`, which `IvfEngine.search_pallas` runs). It computes
//
//   out[p, b, r] = sum_d bf16(q[b, d]) * vecs[probe[b, p], r, d]
//
// for q [B, D] f32, probe [B, P] int32 and the bf16 bucket table
// vecs [K, cap, D], with float32 accumulation; out is [P, B, cap] f32.
// The caller folds in |v|^2 (l2), masks the sentinel slots and takes the
// top-k over [B, P*cap].
//
// Design. One CTA of 256 threads per (query, probe). The query, rounded
// to bf16 and held as float, sits in shared memory. The bucket's rows are
// dealt to groups of G lanes (G = the largest power of two <= min(32,
// D/8)): lane j of a group reads 16-byte chunks j, j+G, ... of its row (8
// bf16 values each; neighbouring lanes on neighbouring addresses, a warp
// covers 32/G whole rows) and adds the eight products in turn with
// float32 FMAs. bf16 x bf16 products are exact in float32, so each FMA
// rounds only the sum. A butterfly of shuffles inside the group adds the
// G partial sums. Where D % 8 != 0 (or the table is not 16-byte aligned)
// the lanes take single elements instead (W = 1).
//
// Bound. Bytes: the probed buckets' rows (cap * D * 2 bytes each) and the
// output. A bucket that several queries probe is read by each of them;
// the 50 MB L2 catches part of that reuse; `ivf_bucket_dots.cu` reads
// each bucket once for all its queries. The
// arithmetic (2 * cap * D per pair) is far below the byte time.
//
// Offsets are 64-bit: a 10M-row table passes 2^31 elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bucket_dots_kernel(const float* __restrict__ q,
                   const int32_t* __restrict__ probe,
                   const __nv_bfloat16* __restrict__ vecs,
                   float* __restrict__ out, int B, int P, int K, int cap,
                   int D, int W, int G) {
  extern __shared__ float qs[];  // [D] bf16-rounded query
  const int b = blockIdx.x, p = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < D; i += kThreads)
    qs[i] = __bfloat162float(__float2bfloat16_rn(q[(size_t)b * D + i]));
  const int c = probe[(size_t)b * P + p];
  float* o = out + ((size_t)p * B + b) * cap;
  if (c < 0 || c >= K) {  // a probe outside the table: NaN, never silence
    for (int r = tid; r < cap; r += kThreads) o[r] = __int_as_float(0x7fc00000);
    return;
  }
  __syncthreads();

  const __nv_bfloat16* base = vecs + (size_t)c * cap * D;
  const int rows = 32 / G;       // rows per warp and step
  const int sub = lane / G, gl = lane % G;
  for (int r0 = warp * rows; r0 < cap; r0 += kWarps * rows) {
    const int r = r0 + sub;
    float acc = 0.f;
    if (r < cap) {
      const __nv_bfloat16* row = base + (size_t)r * D;
      if (W == 8) {
        for (int ch = gl; ch < D / 8; ch += G) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + ch * 8);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
          const float* qq = qs + ch * 8;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(h[k]);
            acc = fmaf(f.x, qq[2 * k], acc);
            acc = fmaf(f.y, qq[2 * k + 1], acc);
          }
        }
      } else {
        for (int i = gl; i < D; i += G)
          acc = fmaf(__bfloat162float(row[i]), qs[i], acc);
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < cap && gl == 0) o[r] = acc;
  }
}

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches one CTA per (query, probe) on `stream`; W is 8 (16-byte
// chunks) or 1, G the lanes per row (a power of two <= 32). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int leann_ivf_bucket_dots(const float* q, const int32_t* probe,
                                     const __nv_bfloat16* vecs, float* out,
                                     int B, int P, int K, int cap, int D,
                                     int W, int G, void* stream) {
  if ((W != 8 && W != 1) || G < 1 || G > 32 || (G & (G - 1)) ||
      (W == 8 && D % 8))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || P <= 0 || cap <= 0) return 0;
  bucket_dots_kernel<<<dim3(B, P), kThreads, smem, (cudaStream_t)stream>>>(
      q, probe, vecs, out, B, P, K, cap, D, W, G);
  return (int)cudaGetLastError();
}
