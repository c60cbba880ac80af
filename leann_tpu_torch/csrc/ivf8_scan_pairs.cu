// Residual-int8 IVF bucket scan for Hopper (sm_90a): kernel B2.
//
// The earlier design of kernel B2, one CTA per (query, probe), kept as
// the yardstick of `ivf8_scan.cu` (the bucket-major design that
// replaced it). Nothing in the package calls it: `chip_smoke.py` builds
// it beside the current source, times the two in turns and holds them
// to each other, as do the card tests. Its C interface is unchanged.
//
// Replaces the TPU kernel `leann_tpu/ops/pallas_kernels.py:
// _make_ivf8_kernel`, launched there by `ivf8_bucket_scores` (the scan of
// `IvfInt8Engine` under LEANN_IVF8_PALLAS=1). For every (query b, probe p)
// with bucket c = probe[b, p] and slot r it computes
//
//   dots  = <cent[c], q[b]> + scale[c, r] * <bf16(q[b]), payload[c, r]>
//   score = 2 * dots - nsq[c, r]   (l2)   or   dots   (ip)
//   out[b, p, r] = -inf where ids[c, r] == -1, else score
//
// for q [B, D] f32, payload [K, cap, D] int8 (row residuals against the
// bucket centroid), scale / nsq [K, cap] f32, ids [K, cap] int32 and
// cent [K, D] f32; out is [B, P, cap] f32. The centroid term is a float32
// dot over the unrounded query, as the reference computes it.
//
// Design. One CTA of 256 threads per (query, probe). The query sits in
// shared memory twice: as float (centroid term) and rounded to bf16 and
// held as float (row dots). Warp 0 forms the centroid term (lane-strided
// float32 products and sums, then a shuffle butterfly). The bucket's rows
// are dealt to groups of G lanes (G = the largest power of two <=
// min(32, D/16)): lane j of a group reads 16-byte chunks j, j+G, ... of
// its row (16 int8 values each; a warp covers 32/G whole rows) and adds
// the products with float32 FMAs. int8 x bf16 products are exact in
// float32, so each FMA rounds only the sum. A butterfly inside the group
// adds the G partial sums; the group's first lane applies the scale, the
// centroid term, the l2 fold and the mask. Where D % 16 != 0 (or the
// table is not 16-byte aligned) the lanes take single bytes (W = 1).
//
// Bound. Bytes: each probed bucket's payload (cap * D), scale, nsq and
// ids (12 * cap) and centroid (4 * D), and the output (4 * cap per pair).
// A bucket that several queries probe is read by each of them; the 50 MB
// L2 catches part of that reuse; `ivf8_scan.cu` reads each bucket once.
//
// Offsets are 64-bit: at 10M x 96 the payload passes 1.3e9 bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ivf8_scan_kernel(const float* __restrict__ q,
                 const int32_t* __restrict__ probe,
                 const int8_t* __restrict__ payload,
                 const float* __restrict__ scale,
                 const float* __restrict__ nsq,
                 const int32_t* __restrict__ ids,
                 const float* __restrict__ cent, float* __restrict__ out,
                 int B, int P, int K, int cap, int D, int W, int G, int l2) {
  extern __shared__ float smem[];
  float* qf = smem;       // [D] query
  float* qb = smem + D;   // [D] bf16-rounded query
  __shared__ float cdot_s;
  const int b = blockIdx.x, p = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < D; i += kThreads) {
    const float v = q[(size_t)b * D + i];
    qf[i] = v;
    qb[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  const int c = probe[(size_t)b * P + p];
  float* o = out + ((size_t)b * P + p) * cap;
  if (c < 0 || c >= K) {  // a probe outside the table: NaN, never silence
    for (int r = tid; r < cap; r += kThreads) o[r] = __int_as_float(0x7fc00000);
    return;
  }
  __syncthreads();
  if (warp == 0) {
    const float* cr = cent + (size_t)c * D;
    float a = 0.f;
    for (int i = lane; i < D; i += 32) a = __fadd_rn(a, __fmul_rn(cr[i], qf[i]));
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) cdot_s = a;
  }
  __syncthreads();
  const float cdot = cdot_s;

  const size_t slot0 = (size_t)c * cap;
  const int8_t* base = payload + slot0 * D;
  const int rows = 32 / G;       // rows per warp and step
  const int sub = lane / G, gl = lane % G;
  for (int r0 = warp * rows; r0 < cap; r0 += kWarps * rows) {
    const int r = r0 + sub;
    float acc = 0.f;
    if (r < cap) {
      const int8_t* row = base + (size_t)r * D;
      if (W == 16) {
        for (int ch = gl; ch < D / 16; ch += G) {
          const int4 v = *reinterpret_cast<const int4*>(row + ch * 16);
          const int8_t* x = reinterpret_cast<const int8_t*>(&v);
          const float* qq = qb + ch * 16;
#pragma unroll
          for (int k = 0; k < 16; ++k) acc = fmaf((float)x[k], qq[k], acc);
        }
      } else {
        for (int i = gl; i < D; i += G) acc = fmaf((float)row[i], qb[i], acc);
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < cap && gl == 0) {
      const size_t s = slot0 + r;
      const float dots = __fadd_rn(cdot, __fmul_rn(acc, scale[s]));
      const float sc = l2 ? __fsub_rn(__fmul_rn(2.f, dots), nsq[s]) : dots;
      o[r] = ids[s] == -1 ? __int_as_float(0xff800000) : sc;
    }
  }
}

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches one CTA per (query, probe) on `stream`; W is 16 (16-byte
// chunks) or 1, G the lanes per row (a power of two <= 32). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int leann_ivf8_bucket_scores(
    const float* q, const int32_t* probe, const int8_t* payload,
    const float* scale, const float* nsq, const int32_t* ids,
    const float* cent, float* out, int B, int P, int K, int cap, int D,
    int W, int G, int l2, void* stream) {
  if ((W != 16 && W != 1) || G < 1 || G > 32 || (G & (G - 1)) ||
      (W == 16 && D % 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ivf8_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || P <= 0 || cap <= 0) return 0;
  ivf8_scan_kernel<<<dim3(B, P), kThreads, smem, (cudaStream_t)stream>>>(
      q, probe, payload, scale, nsq, ids, cent, out, B, P, K, cap, D, W, G,
      l2);
  return (int)cudaGetLastError();
}
