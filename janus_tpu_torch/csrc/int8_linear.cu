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
// Bit for bit with the plain version: the divisions are IEEE (__fdiv_rn,
// never a reciprocal product), the epilogue's products and add are rounded
// one at a time (__fmul_rn, __fadd_rn: no contraction into an FMA), the int32
// sum is converted with __int2float_rn (|acc| reaches 127^2 * 5120 > 2^24),
// and the int32 sums are exact, so neither the order of the k-steps nor the
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
// made once (ops/quant.py column_major).
//
// Design.
// - quantize_rows: one block of 128 threads a row, 16-byte loads; the row's
//   amax by shuffles, then the row read again (from L1) and quantized. It
//   lets the product's launch start at once (programmatic dependent launch),
//   so that the product's weight loads overlap the quantization.
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
//   between calls, so a captured step replays.
// - wgmma_product (M > 64): 256 x 160 output tiles (N 1280 is 8 of them),
//   four warpgroups of 64 rows, each wgmma m64n160k32 s8 from shared
//   memory; a 4-stage ring of 128-byte k slices of xq and the weight,
//   loaded by the TMA unit through 2-d tensor maps under the 128-byte
//   swizzle (rows and k past M, N, K zero-filled), one mbarrier a stage,
//   each stage refilled once every warpgroup has retired its products; the
//   epilogue from the accumulators, two neighbouring columns a store. (It
//   replaced an mma.sync m16n8k32 kernel of 128 x 128 tiles on a cp.async
//   ring, and 128 x 160 wgmma tiles two blocks an SM, both slower at the
//   encoder's shapes: short K leaves each tile few stages to hide its
//   loads behind, and the L2 cache feeds a smaller tile's loads slower.)

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
// ((float(acc) * xs) * ws[n]) + b[n], each operation rounded on its own
__device__ __forceinline__ float rescale(int acc, float xs, const Params& p,
                                         int n) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs),
                      param(p.ws, p.ws_bf16, n));
  if (p.bias != nullptr) v = __fadd_rn(v, param(p.bias, p.b_bf16, n));
  return v;
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

// -- (a) the activations, quantized per row ----------------------------------

constexpr int QT = 128;  // threads a row

// grid (M), block QT; x, xq: [M, K] row-major, K a multiple of 16 / sizeof
// (TX), x 16-byte aligned
template <typename TX>
__global__ void __launch_bounds__(QT)
quantize_rows(const TX* __restrict__ x, int8_t* __restrict__ xq,
              float* __restrict__ xs, int k) {
  constexpr int E = 16 / sizeof(TX);  // values a 16-byte load
  __shared__ float part[QT / 32];
  launch_dependents();
  const int tid = threadIdx.x, row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * k);
  const int nv = k / E;
  float amax = 0.f;
  for (int i = tid; i < nv; i += QT) {
    float f[E];
    widen(__ldg(src + i), f, x);
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) part[tid >> 5] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < QT / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = __fdiv_rn(amax < 1e-8f ? 1e-8f : amax, 127.0f);
  for (int i = tid; i < nv; i += QT) {
    float f[E];
    widen(__ldg(src + i), f, x);
    uint32_t packed[E / 4] = {};
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int qv = max(-127, min(127, __float2int_rn(__fdiv_rn(f[e], s))));
      packed[e / 4] |= (uint32_t)(qv & 0xff) << (8 * (e % 4));
    }
    int8_t* dst = xq + (size_t)row * k + (size_t)i * E;
    if constexpr (E == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = packed[0];
    }
  }
  if (tid == 0) xs[row] = s;
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

// -- (b1) few rows: the weight streamed --------------------------------------

constexpr int SW = 4;             // warps a block
constexpr int ST = SW * 32;       // threads a block
constexpr int BNS = 16 * SW;      // output channels a block
constexpr int CHUNK = 256;        // bytes of k a slot
constexpr int ROW = CHUNK + 16;   // a row's stride in shared memory
constexpr int MAX_SLOTS = 4;
constexpr int MAX_SPLITS = 8;     // a portable cluster

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
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
    for (int i = 0; i < slots; ++i) mbar_init(&bar[i]);
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
    store(y + (long long)row * n + col, rescale(sum, xs[row], p, col));
  }
  if (nsplit > 1) cluster.sync();  // no block leaves while it is read
}

// -- (b2) many rows: warpgroup products ---------------------------------------

constexpr int GT = 512;              // four warpgroups, 64 rows each
constexpr int GBM = 256, GBN = 160;  // a block's tile (N 1280 = 8 x 160)
constexpr int GBK = 128;             // bytes of k a stage: one swizzle atom
constexpr int GSTAGES = 4;
constexpr int GA = GBM * GBK, GB = GBN * GBK;
constexpr int GSTAGE = GA + GB;      // a whole number of 1024-byte periods
static_assert(GSTAGE % 1024 == 0, "stages keep the swizzle's alignment");

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: start address >> 4, LBO 1 (unused one atom wide), SBO 1024 bytes
// (8 rows of 128) >> 4, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
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

// grid (ceil(N / GBN), ceil(M / GBM)), block GT, dynamic shared memory
// GSTAGES x GSTAGE + 1024 (for the alignment). map_x: xq [M, K]; map_w: the
// weight [N, K]; boxes of GBK bytes of k by GBM / GBN rows, 128-byte swizzle.
template <typename TY>
__global__ void __launch_bounds__(GT, 1)
wgmma_product(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w, Params p,
              const float* __restrict__ xs, TY* __restrict__ y, int m, int k,
              int n) {
  extern __shared__ __align__(1024) unsigned char graw[];
  unsigned char* smem = graw + ((1024 - (smem_u32(graw) & 1023)) & 1023);
  __shared__ __align__(8) unsigned long long full[GSTAGES];
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int ktiles = (k + GBK - 1) / GBK;

  // stage s <- k slice kt of the block's xq rows and weight rows
  auto load = [&](int kt, int s) {
    unsigned char* st = smem + (size_t)s * GSTAGE;
    mbar_expect(&full[s], GSTAGE);
    tma_2d(st, &map_x, kt * GBK, m0, &full[s]);
    tma_2d(st + GA, &map_w, kt * GBK, n0, &full[s]);
  };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&map_w))
                 : "memory");
    for (int i = 0; i < GSTAGES; ++i) mbar_init(&full[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(GSTAGES, ktiles); ++i) load(i, i);

  int acc[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % GSTAGES;
    mbar_wait(&full[s], (unsigned)((kt / GSTAGES) & 1));
    const uint32_t a = smem_u32(smem + (size_t)s * GSTAGE) + wg * 64 * GBK;
    const uint32_t b = smem_u32(smem + (size_t)s * GSTAGE + GA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 32; ++kk)
      wgmma_s8(acc, make_desc(a + kk * 32), make_desc(b + kk * 32));
    wgmma_commit();
    // the previous slice's products are done: every warpgroup past this
    // point free its stage for the slice GSTAGES on
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0 && kt > 0 && kt - 1 + GSTAGES < ktiles)
      load(kt - 1 + GSTAGES, (kt - 1) % GSTAGES);
  }
  wgmma_wait<0>();

  // two neighbouring columns in one store where rows are an even count
  // of values apart (so the pair is aligned)
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool even = (n & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
    if (row < m) {
      const float sx = xs[row];
      TY* yr = y + (long long)row * n;
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        const int col = n0 + 8 * j + c2;
        if (col + 1 < n && even) {
          store2(yr + col, rescale(acc[4 * j + 2 * h], sx, p, col),
                 rescale(acc[4 * j + 2 * h + 1], sx, p, col + 1));
        } else {
          if (col < n)
            store(yr + col, rescale(acc[4 * j + 2 * h], sx, p, col));
          if (col + 1 < n)
            store(yr + col + 1,
                  rescale(acc[4 * j + 2 * h + 1], sx, p, col + 1));
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
// GBK bytes by box_rows rows under the 128-byte swizzle
cudaError_t int8_map(CUtensorMap* map, const void* base, int rows, int k,
                     long long stride, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)GBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
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

template <typename TY>
cudaError_t allow_all() {
  const void* ks[] = {(const void*)stream_product<1, TY>,
                      (const void*)stream_product<2, TY>,
                      (const void*)stream_product<4, TY>,
                      (const void*)stream_product<8, TY>,
                      (const void*)wgmma_product<TY>};
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

// slots of a streaming block: its longest range of k, in CHUNK slices, up to
// MAX_SLOTS
int stream_slots(int k, int splits) {
  const int per = (k / 32 + splits - 1) / splits;
  return min(MAX_SLOTS, (per + CHUNK / 32 - 1) / (CHUNK / 32));
}

template <int NT, typename TY>
cudaError_t launch_stream(const Args& a) {
  const int slots = stream_slots(a.k, a.splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, (a.n + BNS - 1) / BNS);
  cfg.blockDim = dim3(ST);
  cfg.dynamicSmemBytes = (size_t)slots * (BNS + 8 * NT) * ROW;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = a.pdl;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, stream_product<NT, TY>, a.w, a.w_stride,
                            a.p, a.xq, a.xs, static_cast<TY*>(a.y), a.m, a.k,
                            a.n, slots);
}

template <typename TY>
cudaError_t launch_product(const Args& a) {
  if (a.splits == 0) {
    CUtensorMap maps[2];
    cudaError_t err = int8_map(&maps[0], a.xq, a.m, a.k, a.k, GBM);
    if (err == cudaSuccess)
      err = int8_map(&maps[1], a.w, a.n, a.k, a.w_stride, GBN);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n + GBN - 1) / GBN, (a.m + GBM - 1) / GBM);
    wgmma_product<TY>
        <<<grid, GT, (size_t)GSTAGES * GSTAGE + 1024, a.stream>>>(
            maps[0], maps[1], a.p, a.xs, static_cast<TY*>(a.y), a.m, a.k,
            a.n);
    return cudaGetLastError();
  }
  if (a.m <= 8) return launch_stream<1, TY>(a);
  if (a.m <= 16) return launch_stream<2, TY>(a);
  if (a.m <= 32) return launch_stream<4, TY>(a);
  return launch_stream<8, TY>(a);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [m, k] row-major, 16-byte aligned (x_dtype 0 = fp32, 1 = bf16); xq:
// [m, k] int8 (16-byte aligned) and xs: [m] fp32, written; w: the weight
// [n, k] int8, rows w_stride bytes apart (a multiple of 16, w 16-byte
// aligned); ws: [n] (ws_dtype 0 = fp32, 1 = bf16); bias: null or [n]
// (b_dtype, the same codes); y: [m, n] row-major in x's dtype. k a multiple
// of 32. splits: 0 for the warpgroup product, else 1, 2, 4 or 8 (at most
// k / 32) blocks a cluster for the streamed one (m <= 64). pdl: let the
// streamed product start during the quantization (programmatic dependent
// launch).
int int8_linear_fwd(const void* x, int x_dtype, void* xq, void* xs,
                    const void* w, long long w_stride, const void* ws,
                    int ws_dtype, const void* bias, int b_dtype, void* y,
                    int m, int k, int n, int splits, int pdl, void* stream) {
  if (m < 1 || k < 32 || k % 32 || n < 1 || w_stride < k || w_stride % 16 ||
      splits < 0 ||
      (splits > 0 && (m > 64 || splits > MAX_SPLITS ||
                       (splits & (splits - 1)) || splits > k / 32 ||
                       (n + BNS - 1) / BNS > 65535)) ||
      (m + GBM - 1) / GBM > 65535 || (x_dtype | ws_dtype | b_dtype) & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xq) |
       reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = allow_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  if (x_dtype == 0)
    quantize_rows<float><<<m, QT, 0, st>>>(static_cast<const float*>(x), q, s,
                                           k);
  else
    quantize_rows<__nv_bfloat16><<<m, QT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a = {q, s, static_cast<const int8_t*>(w), w_stride,
                  Params{ws, bias, ws_dtype, b_dtype}, y, m, k, n, splits,
                  pdl ? 1 : 0, st};
  err = x_dtype == 0 ? launch_product<float>(a)
                     : launch_product<__nv_bfloat16>(a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
