// Decode cross-attention over int8 K/V with per-position scales (K4):
//
//   s[r, tau] = (sum_d q[r, d] * kq[d, tau]) * Dh^-1/2 * k_scale[tau]
//   p[r, tau] = exp(s[r, tau] - max_tau s[r, :]),  l[r] = sum_tau p[r, tau]
//   o[r, d]   = (sum_tau (p[r, tau] * v_scale[tau]) * vq[d, tau]) / max(l[r], 1e-30)
//
// per (batch, head), fp32 throughout, the output cast to q's dtype (fp32
// or bf16). K and V are int8, head-dim-major ([BH, Dh, T], the layout of
// QuantKVT); their scales fold into the score columns (K) and the
// probability columns (V), so no dense dequantized copy exists anywhere.
//
// Replaces the Pallas kernel janus_tpu/ops/cross_attn.py:_kernel (entry
// point cross_attention_kv, via _cross_bh).
//
// Bound on the H100: bytes. At the large-v3 flagship decode step (B 8,
// H 20, Dh 64, T 500, one query row) a launch reads 10.24 MB of int8 K/V
// and 0.64 MB of fp32 scales for ~1.3 MFLOP: ~3.2 us at 3.35 TB/s.
//
// Design: the Pallas kernel runs one program per batch row and loops over
// heads inside it, which here would fill 8 of 132 SMs. This kernel gives
// each (b, h) pair, and each chunk of QB query rows, a block of its own.
// Scores for the block's query rows stay in shared memory (QB x T fp32:
// 24 KB at T 1500). For Q K^T threads run across tau, so each d row of
// K is an int8 load of consecutive bytes across a warp; max and sum are
// block reductions; for P V warps take slices of d, lanes take tau, and a
// warp reduction finishes each output. Columns tau >= T are never touched,
// so no padding is needed. Plain SIMT fp32 math: the first, simple kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int QB = 4;            // query rows per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// block-wide reduction; every thread gets the result. `red` holds NWARPS
// floats; the trailing barrier lets the caller reuse it at once.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARPS; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(NT)
cross_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                       const float* __restrict__ ks,
                       const int8_t* __restrict__ vq,
                       const float* __restrict__ vs, T* __restrict__ out,
                       int tq, int t_len, int dh, float scale) {
  extern __shared__ float smem[];
  __shared__ float red[NWARPS];
  __shared__ float row_l[QB];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, tq - q0);
  float* s = smem;                          // [QB][t_len] scores, then p*vs
  float* qs = smem + (size_t)QB * t_len;    // [QB][dh]

  const T* qb = q + ((size_t)bh * tq + q0) * dh;
  for (int i = threadIdx.x; i < QB * dh; i += NT)
    qs[i] = i < nq * dh ? to_float(qb[i]) : 0.f;
  __syncthreads();

  // s = (q . k) * Dh^-1/2 * k_scale, threads across tau
  const int8_t* kb = kq + (size_t)bh * dh * t_len;
  const float* ksb = ks + (size_t)bh * t_len;
  for (int tau = threadIdx.x; tau < t_len; tau += NT) {
    float acc[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) acc[r] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kv = static_cast<float>(kb[(size_t)d * t_len + tau]);
#pragma unroll
      for (int r = 0; r < QB; ++r) acc[r] = fmaf(qs[r * dh + d], kv, acc[r]);
    }
    const float ksc = ksb[tau];
#pragma unroll
    for (int r = 0; r < QB; ++r)
      if (r < nq) s[(size_t)r * t_len + tau] = acc[r] * scale * ksc;
  }
  __syncthreads();

  // per row: max, exp, sum; then fold the V scale into p
  const float* vsb = vs + (size_t)bh * t_len;
  for (int r = 0; r < nq; ++r) {
    float* sr = s + (size_t)r * t_len;
    float m = -INFINITY;
    for (int tau = threadIdx.x; tau < t_len; tau += NT) m = fmaxf(m, sr[tau]);
    m = block_reduce<true>(m, red);
    float l = 0.f;
    for (int tau = threadIdx.x; tau < t_len; tau += NT) {
      const float p = expf(sr[tau] - m);
      l += p;
      sr[tau] = p * vsb[tau];
    }
    l = block_reduce<false>(l, red);
    if (threadIdx.x == 0) row_l[r] = l;
  }
  __syncthreads();

  // o = (p * v_scale) . v / max(l, 1e-30): warps over d, lanes over tau
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* vb = vq + (size_t)bh * dh * t_len;
  T* ob = out + ((size_t)bh * tq + q0) * dh;
  for (int d = warp; d < dh; d += NWARPS) {
    const int8_t* vrow = vb + (size_t)d * t_len;
    float acc[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) acc[r] = 0.f;
    for (int tau = lane; tau < t_len; tau += 32) {
      const float vv = static_cast<float>(vrow[tau]);
#pragma unroll
      for (int r = 0; r < QB; ++r)
        if (r < nq) acc[r] = fmaf(s[(size_t)r * t_len + tau], vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      const float o = warp_sum(acc[r]);
      if (lane == 0 && r < nq)
        store(ob + (size_t)r * dh + d, o / fmaxf(row_l[r], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, void* out, int bh, int tq, int t_len, int dh,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)QB * (t_len + dh);
  cudaError_t err = cudaFuncSetAttribute(
      cross_attn_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tq + QB - 1) / QB);
  cross_attn_int8_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<T*>(out), tq, t_len, dh,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out: [bh, tq, dh] (dtype 0 = fp32, 1 = bf16); kq, vq: int8
// [bh, dh, t_len]; ks, vs: fp32 [bh, t_len]; scale = dh^-1/2 as fp32.
int cross_attn_int8(const void* q, const void* kq, const void* ks,
                    const void* vq, const void* vs, void* out, int bh, int tq,
                    int t_len, int dh, int dtype, float scale, void* stream) {
  if (bh < 1 || tq < 1 || t_len < 1 || dh < 1 || (tq + QB - 1) / QB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kq, ks, vq, vs, out, bh, tq, t_len, dh, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, out, bh, tq, t_len, dh,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
