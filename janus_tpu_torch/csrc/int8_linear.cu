// The dynamic-int8 linear: per-row activation quantization, an int8 x int8
// product on the tensor cores with int32 sums, and the fp32 rescale, bias
// and cast, for x[M, K] (fp32 or bf16) against a per-output-channel int8
// weight q[K, N] with scales ws[N] and an optional bias b[N] (each fp32 or
// bf16, widened exactly):
//
//   xs[m]    = max(amax_k |x[m, k]|, 1e-8) / 127             (IEEE division)
//   xq[m, k] = clamp(rint(x[m, k] / xs[m]), -127, 127)       (half to even)
//   acc      = xq @ q                                         (int32, exact)
//   y[m, n]  = ((float(acc) * xs[m]) * ws[n]) + b[n]          (fp32, rounded
//                                                             at each step)
//
// rounded once to x's dtype. This is exactly the plain function
// janus_tpu_torch/ops/int8_linear.py int8_linear_plain, the counterpart of
// janus_tpu/ops/quant.py:144 linear_int8_dynamic, which XLA compiles on the
// TPU into one fusion around an int8 dot_general (no Pallas kernel). In
// plain PyTorch it is about 15 launches a call. Here it is two: the
// quantization, then the product with the rescale in its epilogue.
//
// Bit for bit with the plain version: the scale is an IEEE division
// (__fdiv_rn), each value is rounded as the IEEE division x / xs rounds it
// (quantize16), the epilogue's products and add are rounded one at a time
// (__fmul_rn, __fadd_rn: no contraction into an FMA), the int32 sum is
// converted with __int2float_rn (|acc| reaches 127^2 * 5120 > 2^24), and
// the int32 sums are exact, so neither the order of the k-steps nor the
// split of K changes a bit.
//
// Bound on the H100. Decode steps (M <= 64 rows): bytes, the weight read
// once: 1280 x 5120 int8 is 6.55 MB, 1.96 us at 3.35 TB/s, 1280 x 1280 0.49
// us. The encoder (M = 4000 rows of 10 s at b = 8): operations, 2 M K N
// over 1979 TOP/s int8: 13.1 GOP at 1280 x 1280, 6.6 us; the L2 cache's
// rate to the SMs bounds a tile's loads before that (a 256 x 160 tile does
// 197 operations a byte it loads).
//
// The weight is read as [N, K], K contiguous (int8 MMA takes both operands
// K-major): the tree keeps q[K, N] as the transposed view of such a copy,
// made once (ops/quant.py column_major). A programmatic launch asks for the
// weight before it waits for the kernel before it, so the weight must not
// be written by that kernel.
//
// Design.
// - quantize_rows: a block of 128 threads a row, 16-byte loads held in
//   registers from the row's amax (shuffles) to its quantization. It lets
//   the next launch start (programmatic dependent launch), so that the
//   product's weight loads overlap it: at once where it was itself launched
//   after the kernel before had finished (M <= 64), after its own wait
//   where it was launched programmatically (M > 64), so that the product
//   never reads a weight that the kernel before it is still writing.
// - stream_product (M <= 64): the weight is the A operand, y^T = q^T xq^T
//   with mma.sync m16n8k32 s8: 16 output channels a warp, the activation
//   rows fill n = 8 (NT tiles of 8 for up to 64 rows), so no half-empty tile
//   is multiplied for the 16-row m. A block takes 64 channels and a range
//   of K; the ranges of one channel tile form a thread-block cluster of
//   `splits` blocks (1-8, so that all SMs stream: fc2 at N 1280 has 20
//   channel tiles). Each block asks the TMA unit for all its weight rows at
//   the start, one bulk copy a row and slot of 256 bytes of k, each slot on
//   its own mbarrier (a ring where the range is longer than the slots),
//   before it waits for the quantization; then the activation rows. Rows are
//   272 bytes apart in shared memory, so ldmatrix reads them without bank
//   conflicts. The int32 partials go to each block's shared memory; after a
//   cluster barrier each block sums its share of the tile's outputs over the
//   cluster's blocks through distributed shared memory and writes them
//   through the epilogue: no workspace in device memory, nothing to reset
//   between calls, so a captured step replays. (A one-launch form that
//   quantized each block's range of x inside the cluster, sharing the row
//   amaxes through distributed shared memory, was slower in a replayed step
//   and 1.5-3.7x slower at 32 and 64 rows, where every channel tile
//   quantized x again.)
// - tile_product (M > 64): 256 x 160 output tiles, warp-specialised and
//   persistent: one block an SM walks the tiles in a fixed order (rows
//   fastest, so the blocks in flight share a weight panel; no atomics, so
//   replays repeat and nothing is reset between them). One thread of the
//   producer warpgroup keeps a 4-stage ring of 128-byte k slices of xq and
//   the weight full through the TMA unit (2-d tensor maps, 128-byte
//   swizzle, rows and k past M, N, K zero-filled), each stage with a full
//   and an empty mbarrier, running on into the next tile while the
//   consumers rescale the last one; the producer gives up its registers
//   (setmaxnreg) to two consumer warpgroups of 128 rows, each two wgmma
//   m64n160k32 s8 a k-step, which free a stage as soon as their products on
//   it are done. No block-wide barrier lies in the main loop. The
//   epilogue writes from the accumulators, two neighbouring columns a
//   store. Launched programmatically, the producer asks for the weight's
//   first stages before it waits for the quantization, and for xq's after.
//   (No cluster: two blocks multicasting the xq tile were slower at every
//   encoder shape.)

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_MAX = 227 * 1024;  // a block's shared memory, H100

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// two neighbouring values, p aligned to the pair
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(x0);
  v.y = __float2bfloat16_rn(x1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// 16 bytes of x widened to fp32
__device__ __forceinline__ void widen(const uint4& w, float* f, const float*) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void widen(const uint4& w, float* f,
                                      const __nv_bfloat16*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// the largest |x| of 16 bytes of x
template <typename TX>
__device__ __forceinline__ float amax16(const uint4& w, float a) {
  constexpr int E = 16 / sizeof(TX);
  float f[E];
  widen(w, f, static_cast<const TX*>(nullptr));
#pragma unroll
  for (int e = 0; e < E; ++e) a = fmaxf(a, fabsf(f[e]));
  return a;
}
// 16 bytes of x quantized with the row's scale s: 16 / sizeof(TX) int8
// values packed into 32-bit words, lowest k first. rint(x / s) as the IEEE
// division rounds x / s, from the product with r = 1 / s (rounded): that
// product lies within 2^-16 of x / s wherever |x / s| <= 128, so where it
// is 2^-14 or more from every half-integer the division rounds to the same
// integer; nearer (one value in ~8000), the division itself decides (ties
// to even among them), after the products of all the 16 bytes.
template <typename TX>
__device__ __forceinline__ void quantize16(const uint4& w, float s, float r,
                                           uint32_t* packed) {
  constexpr int E = 16 / sizeof(TX);
  float f[E];
  widen(w, f, static_cast<const TX*>(nullptr));
  int qv[E];
  bool near = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float t = __fmul_rn(f[e], r);
    qv[e] = __float2int_rn(t);
    near |= fabsf(t - (floorf(t) + 0.5f)) < 0x1p-14f;
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float t = __fmul_rn(f[e], r);
      if (fabsf(t - (floorf(t) + 0.5f)) < 0x1p-14f)
        qv[e] = __float2int_rn(__fdiv_rn(f[e], s));
    }
  }
#pragma unroll
  for (int i = 0; i < E / 4; ++i) packed[i] = 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    packed[e / 4] |= (uint32_t)(max(-127, min(127, qv[e])) & 0xff)
                     << (8 * (e % 4));
}
template <typename TX>
__device__ __forceinline__ void put_packed(void* dst, const uint32_t* packed) {
  if constexpr (sizeof(TX) == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = packed[0];
  }
}
__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}
// max(amax, 1e-8) / 127, an IEEE division
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(amax < 1e-8f ? 1e-8f : amax, 127.0f);
}

// the weight's scales and the bias: fp32 or bf16 (a tree's parameters
// cast to bf16 take their scales along), widened exactly
struct Params {
  const void* ws;
  const void* bias;  // or null
  int ws_bf16, b_bf16;
};
__device__ __forceinline__ float param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
// ((float(acc) * xs) * w) + b, each operation rounded on its own; no add
// without a bias (an added 0 would turn -0 into +0)
__device__ __forceinline__ float rescale(int acc, float xs, float w, float b,
                                         bool bias) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), w);
  return bias ? __fadd_rn(v, b) : v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// programmatic dependent launch: let the next kernel of the stream start;
// wait until the previous one has finished and its writes are visible (a
// no-op where the launch did not overlap)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival of a phase, expecting `bytes` from its bulk copies (which
// may complete before it: the count of pending bytes may go below zero)
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory by the TMA unit,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- tensor-core fragments ------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// -- (a) few rows: the weight streamed -----------------------------------------

constexpr int SW = 4;             // warps a block
constexpr int ST = SW * 32;       // threads a block
constexpr int BNS = 16 * SW;      // output channels a block
constexpr int CHUNK = 256;        // bytes of k a slot
constexpr int ROW = CHUNK + 16;   // a row's stride in shared memory
constexpr int MAX_SLOTS = 4;
constexpr int MAX_SPLITS = 8;     // a portable cluster
constexpr int STREAM_ROWS = 64;

// grid (splits, ceil(N / BNS)), cluster (splits, 1, 1), block ST; dynamic
// shared memory: `slots` slots of BNS weight rows and 8 NT activation rows,
// ROW bytes apart. w: [N, K] rows w_stride bytes apart; xq [M, K]; M <= 8 NT.
template <int NT, typename TY>
__global__ void __launch_bounds__(ST)
stream_product(const int8_t* __restrict__ w, long long w_stride, Params p,
               const int8_t* __restrict__ xq, const float* __restrict__ xs,
               TY* __restrict__ y, int m, int k, int n, int slots) {
  constexpr int XR = 8 * NT;  // activation rows a slot holds
  constexpr int SLOT = (BNS + XR) * ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar[MAX_SLOTS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * BNS;
  const int rows_w = min(BNS, n - n0);
  // this block's k32 steps [s0, s1) of K / 32, in slots of CHUNK / 32
  const int steps = k / 32;
  const int s0 = (int)((long long)steps * split / nsplit);
  const int s1 = (int)((long long)steps * (split + 1) / nsplit);
  constexpr int PER = CHUNK / 32;
  const int nchunk = (s1 - s0 + PER - 1) / PER;

  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // chunk c into its slot: thread 0 posts the bytes; each warp copies its
  // own 16 weight rows (lane r < 16), then, past the quantization, a
  // quarter of the activation rows (lanes 16-31)
  auto produce_w = [&](int c) {
    const int s = c % slots;
    const int k0 = (s0 + c * PER) * 32;
    const unsigned bytes = (unsigned)(min(PER, s1 - s0 - c * PER) * 32);
    if (tid == 0) mbar_expect(&bar[s], (unsigned)(rows_w + m) * bytes);
    const int r = warp * 16 + lane;
    if (lane < 16 && r < rows_w)
      bulk_copy(smem + (size_t)s * SLOT + r * ROW,
                w + (long long)(n0 + r) * w_stride + k0, bytes, &bar[s]);
  };
  auto produce_x = [&](int c) {
    const int s = c % slots;
    const int k0 = (s0 + c * PER) * 32;
    const unsigned bytes = (unsigned)(min(PER, s1 - s0 - c * PER) * 32);
    for (int r = warp * 16 + lane - 16; lane >= 16 && r < m; r += 16 * SW)
      bulk_copy(smem + (size_t)s * SLOT + (BNS + r) * ROW,
                xq + (long long)r * k + k0, bytes, &bar[s]);
  };
  const int first = min(slots, nchunk);
  for (int c = 0; c < first; ++c) produce_w(c);
  wait_prerequisites();  // xq and xs are the quantization's
  for (int c = 0; c < first; ++c) produce_x(c);

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int c = 0; c < nchunk; ++c) {
    const int s = c % slots;
    mbar_wait(&bar[s], (unsigned)((c / slots) & 1));
    const unsigned char* ws_ = smem + (size_t)s * SLOT;
    const unsigned char* xs_ = ws_ + BNS * ROW;
    const int nstep = min(PER, s1 - s0 - c * PER);
    for (int t = 0; t < nstep; ++t) {
      uint32_t a[4];
      ldmatrix_x4(a, ws_ + (warp * 16 + (lane & 15)) * ROW + t * 32 +
                         (lane >> 4) * 16);
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, xs_ + (lane & 7) * ROW + t * 32 +
                           ((lane >> 3) & 1) * 16);
        mma_s8(acc[0], a, b);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, xs_ + (8 * (j + (lane >> 4)) + (lane & 7)) * ROW +
                             t * 32 + ((lane >> 3) & 1) * 16);
          mma_s8(acc[j], a, b);
          mma_s8(acc[j + 1], a, b + 2);
        }
      }
    }
    if (c + slots < nchunk) {  // refill the slot once every warp has read it
      __syncthreads();
      proxy_fence();
      produce_w(c + slots);
      produce_x(c + slots);
    }
  }

  // the block's int32 partial, part[row][channel], over slot 0
  __syncthreads();
  int* part = reinterpret_cast<int*>(smem);
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int ch = warp * 16 + g;
    part[(8 * j + q2) * BNS + ch] = acc[j][0];
    part[(8 * j + q2 + 1) * BNS + ch] = acc[j][1];
    part[(8 * j + q2) * BNS + ch + 8] = acc[j][2];
    part[(8 * j + q2 + 1) * BNS + ch + 8] = acc[j][3];
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (nsplit > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // this block's share of the tile's outputs, summed over the cluster's
  // partials and written through the epilogue, n fastest
  const int total = m * BNS;
  const int e0 = (int)((long long)total * split / nsplit);
  const int e1 = (int)((long long)total * (split + 1) / nsplit);
  for (int e = e0 + tid; e < e1; e += ST) {
    const int row = e / BNS, ch = e % BNS;
    if (ch >= rows_w) continue;
    int sum = 0;
    for (int r = 0; r < nsplit; ++r)
      sum += nsplit > 1 ? *cluster.map_shared_rank(part + e, r) : part[e];
    const int col = n0 + ch;
    const bool bias = p.bias != nullptr;
    store(y + (long long)row * n + col,
          rescale(sum, xs[row], param(p.ws, p.ws_bf16, col),
                  bias ? param(p.bias, p.b_bf16, col) : 0.f, bias));
  }
  if (nsplit > 1) cluster.sync();  // no block leaves while it is read
}

// -- (b) the activations quantized per row ------------------------------------

constexpr int QT = 128;  // threads a row
constexpr int HOLD = 8;  // 16-byte loads of x a thread has in flight

// grid (M), block QT; x, xq: [M, K] row-major, K a multiple of
// 16 / sizeof(TX), x 16-byte aligned. A row of up to QT x HOLD 16-byte
// vectors stays in registers between its amax and its quantization.
template <typename TX>
__global__ void __launch_bounds__(QT)
quantize_rows(const TX* __restrict__ x, int8_t* __restrict__ xq,
              float* __restrict__ xs, int k) {
  constexpr int E = 16 / sizeof(TX);
  __shared__ float part[QT / 32];
  if (gridDim.x > STREAM_ROWS) {
    // launched programmatically before the tile product, which asks for
    // the weight before its own wait: let it start only once the kernel
    // before has finished, so that a weight that kernel wrote is visible
    wait_prerequisites();  // x is the previous kernel's
    launch_dependents();
  } else {
    // launched after the kernel before has finished: the streamed
    // product's weight loads may overlap the whole quantization
    launch_dependents();
    wait_prerequisites();
  }
  const int tid = threadIdx.x, row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + (long long)row * k);
  const int nv = k / E;
  uint4 held[HOLD];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < HOLD; ++u) {
      const int i = base + u * QT + tid;
      if (i < nv) held[u] = __ldg(src + i);
    }
  };
  float a = 0.f;
  for (int base = 0; base < nv; base += QT * HOLD) {
    load(base);
#pragma unroll
    for (int u = 0; u < HOLD; ++u)
      if (base + u * QT + tid < nv) a = amax16<TX>(held[u], a);
  }
  a = warp_max(a);
  if ((tid & 31) == 0) part[tid >> 5] = a;
  __syncthreads();
  a = part[0];
#pragma unroll
  for (int i = 1; i < QT / 32; ++i) a = fmaxf(a, part[i]);
  const float s = row_scale(a), r = __frcp_rn(s);
  int8_t* dst = xq + (long long)row * k;
  for (int base = 0; base < nv; base += QT * HOLD) {
    if (nv > QT * HOLD) load(base);
#pragma unroll
    for (int u = 0; u < HOLD; ++u) {
      const int i = base + u * QT + tid;
      if (i < nv) {
        uint32_t packed[E / 4];
        quantize16<TX>(held[u], s, r, packed);
        put_packed<TX>(dst + i * E, packed);
      }
    }
  }
  if (tid == 0) xs[row] = s;
}

// -- (c) many rows: a warp-specialised, persistent warpgroup product ----------

constexpr int PT = 384;              // a producer and two consumer warpgroups
constexpr int TBM = 256, TBN = 160;  // a tile (N 1280 = 8 x 160)
constexpr int TBK = 128;             // bytes of k a stage: one swizzle atom
constexpr int TSTAGES = 4;
constexpr int TA = TBM * TBK, TB = TBN * TBK;
constexpr int TSTAGE = TA + TB;      // a whole number of 1024-byte periods
static_assert(TSTAGE % 1024 == 0, "stages keep the swizzle's alignment");
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register file");

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: start address >> 4, LBO 1 (unused one atom wide), SBO 1024 bytes
// (8 rows of 128) >> 4, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// a barrier of `threads` threads (whole warps) on named barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

#define JT_ACC80                                                   \
  "{"                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                       \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "             \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "             \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "             \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "             \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "             \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "             \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"               \
  "}"
#define JT_ACC80_OPERANDS(d)                                        \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),      \
  "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),      \
  "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
  "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), \
  "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), \
  "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), \
  "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), \
  "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), \
  "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), \
  "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), \
  "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])

// d[64 x 160] += A[64 x 32] B[32 x 160]: int8 from shared memory (both
// K-major), int32 sums in registers. Accumulator fragment (thread t of the
// warpgroup, warp w = t / 32, g = lane / 4, c = lane % 4): d[4j + e] is row
// 16w + g, column 8j + 2c + e; d[4j + 2 + e] is row 16w + g + 8.
__device__ __forceinline__ void wgmma_s8(int (&d)[80], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 " JT_ACC80
      ", %80, %81, p;\n}\n"
      : JT_ACC80_OPERANDS(d)
      : "l"(a), "l"(b), "n"(1));
}

// the box of a 2-d tensor map at (c0 bytes of k, c1 rows) by the TMA unit,
// completing on `bar` (past the tensor's end zero-filled)
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1,
                                       unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// rows r and r + 8 of a 64-row accumulator d through the epilogue: columns
// n0 + 8j + c2 and the next, whose weight scales and bias are w0/w1, b0/b1
template <typename TY>
__device__ __forceinline__ void put_tile_pair(TY* __restrict__ y, int row,
                                              int col, int n, bool pair,
                                              float sx, int v0, int v1,
                                              float w0, float w1, float b0,
                                              float b1, bool bias) {
  TY* yr = y + (long long)row * n + col;
  const float y0 = rescale(v0, sx, w0, b0, bias);
  if (pair) {
    store2(yr, y0, rescale(v1, sx, w1, b1, bias));
  } else {
    store(yr, y0);
    if (col + 1 < n) store(yr + 1, rescale(v1, sx, w1, b1, bias));
  }
}

// grid: at most one block an SM, block b walking tiles b, b + gridDim.x,
// ... of mtiles x ceil(N / TBN) (rows fastest, so the blocks in flight
// share weight panels); block PT, dynamic shared memory TSTAGES x TSTAGE +
// 1024 (for the alignment). map_x: xq [M, K] (boxes of TBM rows); map_w:
// the weight [N, K] (boxes of TBN rows); TBK bytes of k a box, 128-byte
// swizzle.
template <typename TY>
__global__ void __launch_bounds__(PT, 1)
tile_product(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_w, Params p,
             const float* __restrict__ xs, TY* __restrict__ y, int m, int k,
             int n, int mtiles, int tiles) {
  extern __shared__ __align__(1024) unsigned char graw[];
  unsigned char* smem = graw + ((1024 - (smem_u32(graw) & 1023)) & 1023);
  __shared__ __align__(8) unsigned long long full[TSTAGES], empty[TSTAGES];
  __shared__ float tile_w[2][TBN], tile_b[2][TBN];  // a consumer's columns
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ktiles = (k + TBK - 1) / TBK;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&map_w))
                 : "memory");
    for (int i = 0; i < TSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: the weight's first stages of the first tile before the
    // wait (constants), xq's after it (the quantization's); then every
    // stage once both consumers have freed it
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      int pre = 0;
      if ((int)blockIdx.x < tiles) {
        pre = min(TSTAGES, ktiles);
        const int n0 = (blockIdx.x / mtiles) * TBN;
        for (int i = 0; i < pre; ++i) {
          mbar_expect(&full[i], TSTAGE);
          tma_2d(smem + (size_t)i * TSTAGE + TA, &map_w, i * TBK, n0,
                 &full[i]);
        }
      }
      wait_prerequisites();
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mtiles) * TBM, n0 = (tile / mtiles) * TBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % TSTAGES;
          unsigned char* st = smem + (size_t)s * TSTAGE;
          if (it >= pre) {
            mbar_wait(&empty[s], (unsigned)(((it / TSTAGES) & 1) ^ 1));
            mbar_expect(&full[s], TSTAGE);
            tma_2d(st + TA, &map_w, kt * TBK, n0, &full[s]);
          }
          tma_2d(st, &map_x, kt * TBK, m0, &full[s]);
        }
      }
    }
  } else {
    // a consumer: rows 128 (wg - 1) of each tile, two 64-row products
    setmaxnreg_inc<CONSUMER_REGS>();
    wait_prerequisites();  // xs is the quantization's; y may be read
    const int c = wg - 1, t = tid & 127, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const bool even = (n & 1) == 0, bias = p.bias != nullptr;
    const uint32_t base = smem_u32(smem);
    int acc0[80], acc1[80];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mtiles) * TBM, n0 = (tile / mtiles) * TBN;
      // the epilogue's operands, asked for before the products: the
      // columns' weight scales and bias (once the last epilogue has read
      // them) and the rows' scales
      named_sync(1 + c, 128);
      for (int i = t; i < TBN; i += 128) {
        const int col = n0 + i;
        tile_w[c][i] = col < n ? param(p.ws, p.ws_bf16, col) : 0.f;
        tile_b[c][i] = bias && col < n ? param(p.bias, p.b_bf16, col) : 0.f;
      }
      const int r0 = m0 + c * 128 + warp * 16 + g;
      const int rows[4] = {r0, r0 + 8, r0 + 64, r0 + 72};
      float sx[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) sx[q] = rows[q] < m ? xs[rows[q]] : 0.f;
#pragma unroll
      for (int i = 0; i < 80; ++i) acc0[i] = acc1[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % TSTAGES;
        mbar_wait(&full[s], (unsigned)((it / TSTAGES) & 1));
        const uint32_t a = base + s * TSTAGE + c * 128 * TBK;
        const uint32_t b = base + s * TSTAGE + TA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 32; ++kk) {
          wgmma_s8(acc0, make_desc(a + kk * 32), make_desc(b + kk * 32));
          wgmma_s8(acc1, make_desc(a + 64 * TBK + kk * 32),
                   make_desc(b + kk * 32));
        }
        wgmma_commit();
        // the previous slice's products are done: free its stage
        wgmma_wait<1>();
        if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % TSTAGES]);
      }
      wgmma_wait<0>();
      if (t == 0) mbar_arrive(&empty[(it - 1) % TSTAGES]);

      // the epilogue, while the producer fills the next tile's stages:
      // rows r, r + 8 of each 64-row half; two neighbouring columns in one
      // store where rows are an even count of values apart
      named_sync(1 + c, 128);  // the columns' operands are in
#pragma unroll
      for (int j = 0; j < TBN / 8; ++j) {
        const int col = n0 + 8 * j + c2;
        if (col < n) {
          const bool has1 = col + 1 < n;
          const float w0 = tile_w[c][8 * j + c2];
          const float w1 = tile_w[c][8 * j + c2 + 1];
          const float b0 = tile_b[c][8 * j + c2];
          const float b1 = tile_b[c][8 * j + c2 + 1];
          const bool pair = has1 && even;
          if (rows[0] < m)
            put_tile_pair(y, rows[0], col, n, pair, sx[0], acc0[4 * j],
                          acc0[4 * j + 1], w0, w1, b0, b1, bias);
          if (rows[1] < m)
            put_tile_pair(y, rows[1], col, n, pair, sx[1], acc0[4 * j + 2],
                          acc0[4 * j + 3], w0, w1, b0, b1, bias);
          if (rows[2] < m)
            put_tile_pair(y, rows[2], col, n, pair, sx[2], acc1[4 * j],
                          acc1[4 * j + 1], w0, w1, b0, b1, bias);
          if (rows[3] < m)
            put_tile_pair(y, rows[3], col, n, pair, sx[3], acc1[4 * j + 2],
                          acc1[4 * j + 3], w0, w1, b0, b1, bias);
        }
      }
    }
  }
}

// -- launchers -----------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    cudaGetLastError();
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-d tensor map over [rows, k] int8 rows `stride` bytes apart, boxes of
// TBK bytes by box_rows rows under the 128-byte swizzle
cudaError_t int8_map(CUtensorMap* map, const void* base, int rows, int k,
                     long long stride, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)TBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void* x;
  int8_t* xq;
  float* xs;
  const int8_t* w;
  long long w_stride;
  Params p;
  void* y;
  int m, k, n, splits, pdl;
  cudaStream_t stream;
};

cudaError_t allow_smem(const void* kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX - (int)attr.sharedSizeBytes);
  return err;
}

template <typename T>
cudaError_t allow_all() {
  const void* ks[] = {(const void*)stream_product<1, T>,
                      (const void*)stream_product<2, T>,
                      (const void*)stream_product<4, T>,
                      (const void*)stream_product<8, T>,
                      (const void*)tile_product<T>};
  for (const void* kk : ks) {
    const cudaError_t err = allow_smem(kk);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// every product kernel's shared memory, allowed at the first call (so never
// first inside a stream capture)
cudaError_t allow_once() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    cudaError_t err = allow_all<float>();
    if (err == cudaSuccess) err = allow_all<__nv_bfloat16>();
    if (err != cudaSuccess) cudaGetLastError();
    done = err;
  }
  return done;
}

// the current device's SMs, read at its first call
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64))
    err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && cached[dev] == 0)
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess) *sms = cached[dev];
  return err;
}

// the tile product's tiles at m x n: (row tiles, all tiles, persistent
// blocks), one block an SM and no more blocks than tiles
cudaError_t tile_plan(int m, int n, int* mtiles, int* tiles, int* grid) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  *mtiles = (m + TBM - 1) / TBM;
  *tiles = *mtiles * ((n + TBN - 1) / TBN);
  *grid = min(*tiles, sms);
  return err;
}

// slots of a streaming block: its longest range of k, in CHUNK slices, up to
// MAX_SLOTS
int stream_slots(int k, int splits) {
  const int per = (k / 32 + splits - 1) / splits;
  return min(MAX_SLOTS, (per + CHUNK / 32 - 1) / (CHUNK / 32));
}

// a launch's configuration: the programmatic attribute (and a cluster)
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  Launch(dim3 grid, int block, size_t smem, cudaStream_t stream, int pdl,
         int cluster) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(block);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = pdl;
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 0 ? 2 : 1;
  }
};

// the quantization into xq and xs, programmatic where `pdl` is set
template <typename T>
cudaError_t launch_quantize(const Args& a, int pdl) {
  Launch q(dim3(a.m), QT, 0, a.stream, pdl, 0);
  return cudaLaunchKernelEx(&q.cfg, quantize_rows<T>,
                            static_cast<const T*>(a.x), a.xq, a.xs, a.k);
}

template <int NT, typename T>
cudaError_t launch_stream(const Args& a) {
  const int slots = stream_slots(a.k, a.splits);
  Launch l(dim3(a.splits, (a.n + BNS - 1) / BNS), ST,
           (size_t)slots * (BNS + 8 * NT) * ROW, a.stream, a.pdl, a.splits);
  return cudaLaunchKernelEx(&l.cfg, stream_product<NT, T>, a.w, a.w_stride,
                            a.p, (const int8_t*)a.xq, (const float*)a.xs,
                            static_cast<T*>(a.y), a.m, a.k, a.n, slots);
}

template <typename T>
cudaError_t launch_tiles(const Args& a) {
  CUtensorMap maps[2];
  int mtiles = 0, tiles = 0, grid = 0;
  cudaError_t err = tile_plan(a.m, a.n, &mtiles, &tiles, &grid);
  if (err == cudaSuccess)
    err = int8_map(&maps[0], a.xq, a.m, a.k, a.k, TBM);
  if (err == cudaSuccess)
    err = int8_map(&maps[1], a.w, a.n, a.k, a.w_stride, TBN);
  if (err == cudaSuccess) err = launch_quantize<T>(a, a.pdl);
  if (err != cudaSuccess) return err;
  Launch l(dim3(grid), PT, (size_t)TSTAGES * TSTAGE + 1024, a.stream, a.pdl,
           0);
  return cudaLaunchKernelEx(&l.cfg, tile_product<T>, maps[0], maps[1], a.p,
                            (const float*)a.xs, static_cast<T*>(a.y), a.m,
                            a.k, a.n, mtiles, tiles);
}

template <typename T>
cudaError_t launch(const Args& a) {
  if (a.splits == 0) return launch_tiles<T>(a);
  // the streamed product's weight loads overlap the quantization (where
  // a.pdl), which waits for the kernel before
  const cudaError_t err = launch_quantize<T>(a, 0);
  if (err != cudaSuccess) return err;
  if (a.m <= 8) return launch_stream<1, T>(a);
  if (a.m <= 16) return launch_stream<2, T>(a);
  if (a.m <= 32) return launch_stream<4, T>(a);
  return launch_stream<8, T>(a);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [m, k] row-major, 16-byte aligned (x_dtype 0 = fp32, 1 = bf16); xq:
// [m, k] int8 (16-byte aligned) and xs: [m] fp32, written; w: the weight
// [n, k] int8, rows w_stride bytes apart (a multiple of 16, w 16-byte
// aligned), not written by the kernel just before the call (with pdl the
// tile product reads it before the wait); ws: [n] (ws_dtype 0 = fp32, 1 =
// bf16); bias: null or [n] (b_dtype, the same codes); y: [m, n] row-major
// in x's dtype. k a multiple of 32. Two launches, the quantization and a
// product: splits 1, 2, 4 or 8 (at most k / 32), the streamed product of
// `splits` blocks a cluster (m <= 64); 0, the tile product on one
// persistent block an SM.
// pdl: launch the product programmatically, so that its weight loads
// overlap the quantization; with the tile product the quantization too,
// so that it overlaps the kernel before it.
int int8_linear_fwd(const void* x, int x_dtype, void* xq, void* xs,
                    const void* w, long long w_stride, const void* ws,
                    int ws_dtype, const void* bias, int b_dtype, void* y,
                    int m, int k, int n, int splits, int pdl, void* stream) {
  if (m < 1 || k < 32 || k % 32 || n < 1 || w_stride < k || w_stride % 16 ||
      splits < 0 || xq == nullptr || xs == nullptr ||
      (splits > 0 && (m > STREAM_ROWS || splits > MAX_SPLITS ||
                       (splits & (splits - 1)) || splits > k / 32 ||
                       (n + BNS - 1) / BNS > 65535)) ||
      (x_dtype | ws_dtype | b_dtype) & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xq) |
       reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = allow_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a = {x, static_cast<int8_t*>(xq), static_cast<float*>(xs),
                  static_cast<const int8_t*>(w), w_stride,
                  Params{ws, bias, ws_dtype, b_dtype}, y, m, k, n, splits,
                  pdl ? 1 : 0, static_cast<cudaStream_t>(stream)};
  err = x_dtype == 0 ? launch<float>(a) : launch<__nv_bfloat16>(a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// the tile product's plan at m x n rows and channels on the current
// device: plan[0..2] = tile rows, tile channels, persistent blocks
int int8_linear_tiles(int m, int n, int* plan) {
  int mtiles = 0, tiles = 0;
  plan[0] = TBM;
  plan[1] = TBN;
  return static_cast<int>(tile_plan(m, n, &mtiles, &tiles, &plan[2]));
}

}  // extern "C"
