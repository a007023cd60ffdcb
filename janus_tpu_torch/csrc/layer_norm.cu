// Fused layer norm over the last axis of a row-major [rows, d] tensor:
//
//   mean = sum(x) / d,  var = sum((x - mean)^2) / d      (two passes, fp32)
//   y    = ((x - mean) * rsqrt(var + eps)) * scale + bias  (fp32)
//
// rounded once to x's dtype. x and the parameters are fp32 or bf16, each on
// its own (the TTS decode step runs fp32 activations against bf16 scale and
// bias). This is exactly the plain function janus_tpu_torch/ops/layers.py
// layer_norm, the counterpart of janus_tpu/ops/layers.py:46 layer_norm, which
// XLA compiles into one fusion on the TPU (it has no Pallas kernel). On the
// card the plain version is about 12 launches, each a pass over the row.
//
// With a residual (delta, of x's dtype or bf16 under fp32 x, broadcast over
// the leading rows: row i adds delta row i % delta_rows) the kernel first
// forms r = x + delta in fp32, rounded to x's dtype exactly as PyTorch's add
// rounds it, writes r once and normalises r as stored, from registers: the
// residual add that feeds every pre-norm in the decode steps and the
// encoder, taken into the norm's launch (XLA compiles the two as one fusion
// on the TPU: janus_tpu/models/asr.py:384-395, janus_tpu/models/tts.py:
// 138-140). The pair then reads x and delta and writes r and y once each,
// where the add and the norm apart read x, delta and r and write r and y.
//
// Arithmetic, to match the plain version: x widened to fp32; the mean as the
// sum times 1/d (PyTorch's CUDA mean multiplies by that factor); the variance
// as the mean of squared deviations, each square rounded before it is added
// (not Welford, which rounds differently); rsqrtf, which is what PyTorch's
// CUDA rsqrt calls for fp32; the normalisation, the scale and the bias as
// three separately rounded operations (no contraction into an FMA, as the
// plain version's three elementwise kernels round each). Only the order of
// the two row sums differs from PyTorch's.
//
// Bound on the H100: bytes. A row is read once and written once (the
// parameters are shared by every row and stay in L1/L2): at the large-v3
// encoder's [8, 1500, 1280] bf16, 61 MB, ~18 us at 3.35 TB/s; at the decode
// step's [8, 1, 1280], 41 KB, which no launch can approach.
//
// Design, for that bound: the row is held in registers, read from device
// memory once. One warp takes a row of up to 2048 values (40 a lane at
// d = 1280), reducing with shuffles only; a wider row (up to 8192) takes a
// block of 8 warps, reducing through shared memory. Where the row is a whole
// number of 16-byte chunks and 16-byte aligned, each lane loads and stores 16
// bytes at a time (8 bf16 or 4 fp32 values), neighbouring lanes on
// neighbouring chunks; otherwise one value at a time, still coalesced. With
// few rows (a decode step's 1-64) the launch is latency-bound: the scale and
// bias are then loaded into registers first, beside x, so that no load waits
// behind the row sums (chip_smoke.py's [8, 1, 1280] row: 2.5 us, against
// 3.25 us when they were read last); with many rows the registers that costs
// would lower the occupancy a bandwidth-bound pass needs, so they are read
// after. The residual's delta joins x's chunked loads (16 bytes, or 8 where
// bf16 delta meets fp32 x) in the same unrolled loop, so that both are in
// flight together, and r leaves in x's 16-byte chunks.
//
// A block lets the next kernel of the stream start as soon as it starts
// (griddepcontrol.launch_dependents): a kernel launched programmatically
// after the norm (the mixed linear, the int8 linear's quantization) then
// runs its prologue, and asks the L2 cache for its weight, while the norm
// runs; it waits for the norm's end before it reads or writes anything
// (csrc/mixed_linear.cu has the measurement: the trigger placed after the
// row was read came too late to hide anything). A kernel launched the
// ordinary way is not affected.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP_ROWS = 4;      // rows (warps) per block, warp mode

// programmatic dependent launch: the next kernel of the stream may start
// (one launched programmatically waits for this one before its first read)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
constexpr int WIDE_THREADS = 256;  // threads per row, block mode

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// VEC consecutive values of T, widened: one 16- or 8-byte load where the
// chunk is that wide, else one value at a time
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (VEC * sizeof(T) == 16) {
    __align__(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_float(e[i]);
  } else if constexpr (VEC * sizeof(T) == 8) {
    __align__(8) T e[VEC];
    *reinterpret_cast<uint2*>(e) = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_float(p[i]);
  }
}

template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (TPR == 32) return v;
  // block mode: the warps' sums through shared memory, in warp order
  constexpr int NW = TPR / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// TPR threads per row (32: a warp, WIDE_THREADS: a block); each holds
// CHUNKS chunks of VEC consecutive values, chunk k of the row at lane
// index + TPR * j. RES: the row is r = x + delta, written to r_out, and
// normalised as stored.
template <typename TX, typename TP, typename TD, bool RES, int TPR,
          int CHUNKS, int VEC, bool EARLY>
__global__ void __launch_bounds__(TPR == 32 ? 32 * WARP_ROWS : TPR)
layer_norm_kernel(const TX* __restrict__ x, const TP* __restrict__ scale,
                  const TP* __restrict__ bias, TX* __restrict__ y,
                  const TD* __restrict__ delta, int delta_rows,
                  TX* __restrict__ r_out, int rows, int d, float inv_d,
                  float eps) {
  __shared__ float red[TPR / 32];
  // the next kernel may start: it waits for this one before its first read
  launch_dependents();
  const int lane = TPR == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const long long row =
      TPR == 32 ? (long long)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5)
                : (long long)blockIdx.x;
  if (row >= rows) return;  // whole warps leave; block mode has one row
  const TX* xr = x + row * d;
  TX* yr = y + row * d;

  // EARLY: the parameters in registers before x is read
  float sv[EARLY ? CHUNKS : 1][VEC], bv[EARLY ? CHUNKS : 1][VEC];
  if constexpr (EARLY) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int col = (lane + TPR * j) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sv[j][i] = col < d ? to_float(scale[col + i]) : 0.f;
        bv[j][i] = col < d ? to_float(bias[col + i]) : 0.f;
      }
    }
  }
  float v[CHUNKS][VEC];
  const TD* dr = RES ? delta + (row % delta_rows) * d : nullptr;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int col = (lane + TPR * j) * VEC;
    if constexpr (VEC > 1) {
      // 16 bytes: VEC values of TX
      __align__(16) TX e[VEC];
      *reinterpret_cast<uint4*>(e) =
          col < d ? __ldg(reinterpret_cast<const uint4*>(xr + col))
                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = to_float(e[i]);
    } else {
      v[j][0] = col < d ? to_float(xr[col]) : 0.f;
    }
    if constexpr (RES) {
      // r = x + delta, rounded to x's dtype as PyTorch's add rounds it;
      // the norm is taken of r as stored (zeros past the row stay zero)
      float dv[VEC];
      if (col < d) {
        load_vec<TD, VEC>(dr + col, dv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dv[i] = 0.f;
      }
      __align__(16) TX e[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        from_float(__fadd_rn(v[j][i], dv[i]), &e[i]);
        v[j][i] = to_float(e[i]);
      }
      if (col < d) {
        TX* rr = r_out + row * d + col;
        if constexpr (VEC > 1)
          *reinterpret_cast<uint4*>(rr) = *reinterpret_cast<const uint4*>(e);
        else
          rr[0] = e[0];
      }
    }
  }

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += v[j][i];  // zeros past the row
  const float mean = __fmul_rn(row_sum<TPR>(s, red), inv_d);

  float q = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const bool ok = (lane + TPR * j) * VEC < d;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float c = __fsub_rn(v[j][i], mean);
      q = __fadd_rn(q, ok ? __fmul_rn(c, c) : 0.f);
    }
  }
  const float var = __fmul_rn(row_sum<TPR>(q, red), inv_d);
  const float rstd = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int col = (lane + TPR * j) * VEC;
    if (col >= d) continue;
    __align__(16) TX out[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float n = __fmul_rn(__fsub_rn(v[j][i], mean), rstd);
      float sc, bi;
      if constexpr (EARLY) {
        sc = sv[j][i];
        bi = bv[j][i];
      } else {
        sc = to_float(scale[col + i]);
        bi = to_float(bias[col + i]);
      }
      const float t = __fadd_rn(__fmul_rn(n, sc), bi);
      from_float(t, &out[i]);
    }
    if constexpr (VEC > 1)
      *reinterpret_cast<uint4*>(yr + col) =
          *reinterpret_cast<const uint4*>(out);
    else
      yr[col] = out[0];
  }
}

struct Args {
  const void *x, *scale, *bias;
  void* y;
  const void* delta;
  int delta_rows;
  void* r_out;
  int rows, d;
  float eps;
  cudaStream_t stream;
};

template <typename TX, typename TP, typename TD, bool RES, int TPR,
          int CHUNKS, int VEC, bool EARLY>
int launch_as(const Args& a) {
  const int threads = TPR == 32 ? 32 * WARP_ROWS : TPR;
  const long long blocks =
      TPR == 32 ? ((long long)a.rows + WARP_ROWS - 1) / WARP_ROWS : a.rows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_kernel<TX, TP, TD, RES, TPR, CHUNKS, VEC, EARLY>
      <<<(unsigned)blocks, threads, 0, a.stream>>>(
          static_cast<const TX*>(a.x), static_cast<const TP*>(a.scale),
          static_cast<const TP*>(a.bias), static_cast<TX*>(a.y),
          static_cast<const TD*>(a.delta), a.delta_rows,
          static_cast<TX*>(a.r_out), a.rows, a.d, 1.0f / (float)a.d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// the parameters read early for a warp a row and at most EARLY_ROWS rows
constexpr int EARLY_ROWS = 1024;

template <typename TX, typename TP, typename TD, bool RES, int TPR,
          int CHUNKS, int VEC>
int launch(const Args& a) {
  if (TPR == 32 && a.rows <= EARLY_ROWS)
    return launch_as<TX, TP, TD, RES, TPR, CHUNKS, VEC, TPR == 32>(a);
  return launch_as<TX, TP, TD, RES, TPR, CHUNKS, VEC, false>(a);
}

// the fewest values a thread holds for the width: warp mode for d <= 2048
// (8, 16, 32, 40 or 64 a lane), block mode up to 8192 (16 or 32 a thread)
template <typename TX, typename TP, typename TD, bool RES, int VEC>
int by_width(const Args& a) {
  const int d = a.d;
  if (d <= 32 * 8) return launch<TX, TP, TD, RES, 32, 8 / VEC, VEC>(a);
  if (d <= 32 * 16) return launch<TX, TP, TD, RES, 32, 16 / VEC, VEC>(a);
  if (d <= 32 * 32) return launch<TX, TP, TD, RES, 32, 32 / VEC, VEC>(a);
  if (d <= 32 * 40) return launch<TX, TP, TD, RES, 32, 40 / VEC, VEC>(a);
  if (d <= 32 * 64) return launch<TX, TP, TD, RES, 32, 64 / VEC, VEC>(a);
  if (d <= WIDE_THREADS * 16)
    return launch<TX, TP, TD, RES, WIDE_THREADS, 16 / VEC, VEC>(a);
  if (d <= WIDE_THREADS * 32)
    return launch<TX, TP, TD, RES, WIDE_THREADS, 32 / VEC, VEC>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the residual only in 16-byte chunks (its callers' widths)
template <typename TX, typename TP, typename TD, bool RES>
int by_vec(int vec, const Args& a) {
  constexpr int WIDE = 16 / sizeof(TX);
  if (vec == WIDE) return by_width<TX, TP, TD, RES, WIDE>(a);
  if constexpr (!RES)
    if (vec == 1) return by_width<TX, TP, TD, RES, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// no residual; or delta in x's dtype, or bf16 under fp32 x (r = x + delta
// is then fp32)
template <typename TX, typename TP>
int by_delta(int d_dtype, int vec, const Args& a) {
  const int x_code = sizeof(TX) == 4 ? 0 : 1;
  if (a.delta == nullptr) return by_vec<TX, TP, TX, false>(vec, a);
  if (d_dtype == x_code) return by_vec<TX, TP, TX, true>(vec, a);
  if (x_code == 0 && d_dtype == 1)
    return by_vec<TX, TP, __nv_bfloat16, true>(vec, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX>
int by_param(int p_dtype, int d_dtype, int vec, const Args& a) {
  if (p_dtype == 0) return by_delta<TX, float>(d_dtype, vec, a);
  if (p_dtype == 1) return by_delta<TX, __nv_bfloat16>(d_dtype, vec, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: [rows, d] row-major (dtype 0 = fp32, 1 = bf16); scale, bias: [d]
// (p_dtype, the same codes); d in [1, 8192]; vec: values a lane loads at a
// time, 16 / sizeof(x's element) (x, y, delta and r_out aligned to a chunk,
// d a multiple of vec) or 1. delta: null, or [delta_rows, d] row-major
// (d_dtype: x's, or bf16 under fp32 x; row i of x adds row i % delta_rows;
// vec 16 / sizeof(x's element) only), with r_out [rows, d] in x's dtype:
// the norm is then of r = x + delta, which is written to r_out.
int layer_norm_fwd(const void* x, const void* scale, const void* bias,
                   void* y, const void* delta, int delta_rows, int d_dtype,
                   void* r_out, int rows, int d, int x_dtype, int p_dtype,
                   float eps, int vec, void* stream) {
  if (rows < 1 || d < 1 || d > WIDE_THREADS * 32 ||
      (delta && (!r_out || delta_rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!delta) d_dtype = x_dtype;
  if (vec != 1) {
    const int bytes = x_dtype == 0 ? 4 : 2;
    if (vec * bytes != 16 || d % vec)
      return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
         reinterpret_cast<uintptr_t>(r_out)) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const int d_chunk = vec * (d_dtype == 0 ? 4 : 2);
    if (reinterpret_cast<uintptr_t>(delta) % d_chunk)
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Args a = {x, scale, bias, y, delta, delta_rows, r_out, rows, d, eps,
                  static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0) return by_param<float>(p_dtype, d_dtype, vec, a);
  if (x_dtype == 1) return by_param<__nv_bfloat16>(p_dtype, d_dtype, vec, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
