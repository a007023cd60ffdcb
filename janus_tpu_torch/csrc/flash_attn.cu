// Fused attention forward: softmax(Q K^T * Dh^-1/2 + mask) V with an
// online (running max and sum) softmax; scores never reach HBM.
//
// Replaces the Pallas kernel janus_tpu/ops/flash.py:_kernel (via _flash_bh
// and flash_attention). Semantics kept exactly: scores in fp32, keys at or
// past the key length masked (plus col <= row when causal) with a -1e30
// fill before the max, the unnormalised probabilities cast to V's dtype
// before the PV product, fp32 accumulation, a final divide by
// max(l, 1e-30), output in Q's dtype, tq != tk allowed. The running-max
// form rounds p against the running rather than the final row max:
// identical in fp32, within bf16 rounding of p in bf16.
//
// Bound on the H100: bytes and operations nearly tie. At the large-v3
// encoder shape (B*H = 160, T = 500, Dh = 64) one call moves ~41 MB of q,
// k, v and output in bf16 (0.012 ms at 3.35 TB/s) and does 4 * 160 *
// 500^2 * 64 = 10.2 GFLOP (0.010 ms at the 989 TFLOP/s bf16 tensor-core
// rate, 0.15 ms at the 67 TFLOP/s of the fp32 pipes).
//
// Two kernels, chosen by the wrapper from (dtype, Dh):
//
// 1. flash_fwd_wgmma_kernel, bf16 at Dh = 64 (the large-v3 encoder; the
//    template takes any multiple of 64). Both products run on the tensor
//    cores through wgmma (m64n64k16) with fp32 accumulators. A block is two
//    warpgroups of 64 query rows each, which share every K/V tile they
//    stream (half the L2 traffic of one warpgroup a block). Q lives in
//    registers as A fragments, read once from device memory. K/V tiles of
//    64 keys sit in shared memory as 64-column panels of 128-byte rows
//    under the 128-byte swizzle, which one layout serves twice: K-major for
//    S = Q K^T and MN-major (the transpose-B bit) for V in O += P V. P
//    never leaves registers: the S accumulator fragment of m64n64 is, pair
//    by pair, the A fragment of m64k16, so the exponentials are packed to
//    bf16x2 in place. K/V tiles arrive through a ring of four cp.async
//    stages, two tiles ahead of the one in use; rows past the key length
//    are zero-filled by the copy and masked in the scores. Per tile a
//    warpgroup hands S of tile i and O += P V of tile i-1 to the tensor
//    cores together and runs the softmax of tile i while the second is
//    still at work; with four warpgroups on an SM the rest overlaps across
//    them. The softmax runs on the accumulator layout (four lanes share a
//    row: two shuffles; max and sum as four independent chains a row), in
//    base 2 with Dh^-1/2 * log2(e) folded into one fused multiply-add
//    before ex2.approx, and O is rescaled only when a row's max moved.
//    At Dh 64 the exponentials (16 a clock on an SM) weigh about as much
//    as the tensor-core work, and the narrow m64n64 shape stays under the
//    tensor peak: the kernel sits near the sum of the two, not at the
//    bound. The output tile is staged through the ring and stored 16 bytes
//    a thread.
//
// 2. flash_fwd_kernel, fp32 (any supported Dh) and Dh = 32: SIMT on the
//    fp32 pipes. The demo checkpoint runs fp32 at Dh 32 and its packets
//    must stay byte-equal between the card and the CPU; TF32 tensor cores
//    would cost about three decimal digits there. A block owns 64 query
//    rows and streams 32-key tiles (converted to fp32 once) through shared
//    memory; four lanes share a row. It also serves as the yardstick the
//    tensor-core kernel is timed against on the same inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 32;    // keys per tile
constexpr int NT = 256;   // threads: 4 per query row
constexpr int KPT = BK / 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
// p rounded through the value dtype (the Pallas kernel's p.astype(v.dtype))
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
                 float scale, int causal) {
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK + 1];
  constexpr int DPT = D / 4;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;
  const int qi = q0 + r;
  const bool qvalid = qi < tq;

  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = qvalid ? to_f(qb[(size_t)qi * D + d]) : 0.f;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int kend = causal ? min(tk, q0 + BQ) : tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < tk) {
        kv = to_f(kb[(size_t)kj * D + d]);
        vv = to_f(vb[(size_t)kj * D + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = c + 4 * i;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const bool valid = kj < tk && (!causal || kj <= qi);
      s[i] = valid ? dot * scale : -1e30f;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      lsum += p;
      ps[r][c + 4 * i] = round_as(p, (const T*)nullptr);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = l * alpha + lsum;
    m = m_new;
    // a row's probabilities are written by its four lanes, all in one warp
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = ps[r][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][c + 4 * i], acc[i]);
    }
    __syncwarp();
  }

  if (qvalid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* ob = o + ((size_t)bh * tq + qi) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) from_f(acc[i] * inv, ob + c + 4 * i);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int tq, int tk, int causal, void* stream) {
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  const float scale = (float)(1.0 / sqrt((double)D));  // as Dh ** -0.5
  flash_fwd_kernel<T, D><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             void* o, int bh, int tq, int tk, int causal, void* stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, bh, tq, tk, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, tq, tk, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the tensor-core kernel (bf16, Dh a multiple of 64) -------------------

namespace tc {

constexpr int WG_ROWS = 64;  // query rows per warpgroup: one wgmma M
constexpr int BK = 64;       // keys per tile
constexpr int WGS = 2;       // warpgroups per block, sharing the K/V tiles
constexpr int NT = 128 * WGS;
constexpr int BQ = WG_ROWS * WGS;   // query rows per block
constexpr int MIN_BLOCKS = 2;   // blocks per SM: at most 128 registers a thread
constexpr int PREFETCH = 2;  // K/V tiles requested ahead of the one in use
constexpr int STAGES = PREFETCH + 2;   // tiles i-1 .. i+PREFETCH are live
constexpr int PANEL = 64 * 128;  // bytes of one [64 rows][64 bf16] panel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) made visible to wgmma's async-proxy reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of (row, 16-byte chunk c of the row) in a tile of 64 rows x D
// bf16: 64-column panels, 128-byte rows, chunk index XORed with row % 8
// (the 128-byte swizzle of wgmma and TMA)
__device__ __forceinline__ uint32_t tile_offset(int row, int c) {
  return (c >> 3) * PANEL + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

// One thread's share of the copy of a [64][D] bf16 tile into shared memory:
// the 16-byte chunk `c` of rows r, r + RPP, r + 2 RPP, ... Its offsets are
// worked out once; RPP is a multiple of 8, so the swizzle term is the same
// for all its rows.
template <int D>
struct TileCopy {
  static constexpr int CHUNKS = D / 8;       // 16-byte chunks per row
  static constexpr int RPP = NT / CHUNKS;    // rows the block copies per pass
  static_assert(NT % CHUNKS == 0 && RPP % 8 == 0 && 64 % RPP == 0,
                "whole rows per pass, whole swizzle periods between passes");
  int row;        // first row of this thread
  uint32_t dst;   // its byte offset in the tile
  int src;        // its element offset in the source

  __device__ __forceinline__ explicit TileCopy(int tid)
      : row(tid / CHUNKS),
        dst(tile_offset(tid / CHUNKS, tid % CHUNKS)),
        src((tid / CHUNKS) * D + (tid % CHUNKS) * 8) {}

  // rows [0, rows_valid) of `from` ([rows][D] bf16, row 0 valid) into the
  // tile at `to`; the rest of the tile is zero-filled
  __device__ __forceinline__ void operator()(uint32_t to,
                                             const __nv_bfloat16* from,
                                             int rows_valid) const {
#pragma unroll
    for (int pass = 0; pass < 64 / RPP; ++pass) {
      const bool ok = row + pass * RPP < rows_valid;
      cp_async16(to + dst + pass * RPP * 128,
                 from + (ok ? src + pass * RPP * D : 0), ok);
    }
  }
};

// wgmma shared-memory descriptor: start address >> 4, LBO (unused by a
// swizzled operand one atom wide) 1, SBO 1024 bytes (8 rows of 128 bytes)
// >> 4, 128-byte swizzle. The tile base is 1024-byte aligned.
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
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin accumulators behind the wait that precedes this call, so that no use
// of them is scheduled before it
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 32 accumulator registers of an m64n64 wgmma, as asm operands 0..31
#define JT_ACC_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define JT_ACC_OPERANDS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (bf16x2 pairs in
// the layout of an accumulator fragment), B from shared memory. TRANS_B 0:
// B is K-major (64 rows of keys, 16 head-dim columns contiguous: K for
// S = Q K^T). TRANS_B 1: B is MN-major (16 rows of keys, 64 head-dim
// columns contiguous: V for O += P V).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      JT_ACC_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : JT_ACC_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
constexpr int smem_bytes() {
  return 1024 + 64 * D * 2 * 2 * STAGES;
}

// Accumulator fragment of m64n64 (thread t of the warpgroup, warp w = t/32,
// g = lane/4, c = lane%4): d[4j + e] is row 16w + g, column 8j + 2c + e;
// d[4j + 2 + e] is row 16w + g + 8, same column (j < 8, e < 2). The A
// fragment of one k16 step is four such pairs: (row, k 2c), (row + 8,
// k 2c), (row, k 2c + 8), (row + 8, k 2c + 8).
template <int D>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int tq, int tk,
                       float scale_log2, int causal) {
  static_assert(D % 64 == 0, "head dim in 64-column panels");
  constexpr int NP = D / 64;             // panels per tile
  constexpr int TILE = 64 * D * 2;       // bytes of a 64-row tile
  static_assert(STAGES >= PREFETCH + 2, "tiles i-1 .. i+PREFETCH are live");
  static_assert(2 * STAGES >= WGS, "the ring also stages the output tiles");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage s: K at tile 2s, V at tile 2s + 1

  const int tid = threadIdx.x;
  const int wg = tid >> 7;               // warpgroup
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wg_q0 = q0 + wg * WG_ROWS;   // this warpgroup's first query row
  const int row0 = wg_q0 + warp * 16 + g;   // this thread's rows: row0, +8
  const __nv_bfloat16* qb = q + (size_t)bh * tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * D;

  // causal: tiles past the block's last row are not streamed (a tile past
  // this warpgroup's rows only is masked whole: p = 0, nothing changes)
  const int ntiles = ((causal ? min(tk, q0 + BQ) : tk) + BK - 1) / BK;

  const TileCopy<D> copy(tid);
  auto load_kv = [&](int tile) {
    const uint32_t dst = ring + (2 * (tile % STAGES)) * TILE;
    copy(dst, kb + (size_t)tile * BK * D, tk - tile * BK);
    copy(dst + TILE, vb + (size_t)tile * BK * D, tk - tile * BK);
  };
  // tile i has landed for everyone; tile i + PREFETCH is requested into the
  // stage of tile i - 2, whose last reader (O += P V) every warp waited on
  auto advance = [&](int i) {
    cp_async_wait<PREFETCH - 1>();
    fence_proxy_async();
    __syncthreads();
    if (i + PREFETCH < ntiles) load_kv(i + PREFETCH);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  // Q as A fragments, straight from device memory (rows past tq are zero)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1);
      const int col = 16 * kk + 8 * (r >> 1) + 2 * c4;
      qa[kk][r] = row < tq ? __ldg(reinterpret_cast<const uint32_t*>(
                                 qb + (size_t)row * D + col))
                           : 0u;
    }

  float o_acc[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[n][i] = 0.f;
  // running row max in units of the raw scores; this lane's share of the
  // row sums; the factor the last tile's new max puts on O
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  float s[32];                 // S of the tile in hand, then its p
  uint32_t pa[BK / 16][4];     // p rounded to bf16x2: the A operand of P V

  // S = Q K^T of a tile, asynchronously (one commit group)
  auto start_qk = [&](int tile) {
    const uint32_t s_k = ring + (2 * (tile % STAGES)) * TILE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs<0>(s, qa[kk],
                  make_desc(s_k + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
    wgmma_commit();
  };
  // O += P V of a tile, asynchronously (one commit group)
  auto start_pv = [&](int tile) {
    const uint32_t s_v = ring + (2 * (tile % STAGES) + 1) * TILE;
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1>(o_acc[n], pa[kk],
                    make_desc(s_v + n * PANEL + kk * 16 * 128), 1);
    wgmma_commit();
  };
  // O takes the factor of the last new max, where a row of the warp saw one
  auto rescale_o = [&]() {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o_acc[n][4 * j] *= alpha[0];
          o_acc[n][4 * j + 1] *= alpha[0];
          o_acc[n][4 * j + 2] *= alpha[1];
          o_acc[n][4 * j + 3] *= alpha[1];
        }
    }
  };
  // The online softmax of one tile on the accumulator layout: s holds raw
  // scores on entry and p = exp(score - running max) on exit.
  auto softmax = [&](int tile) {
    // keys past the length (and past the diagonal) get the -1e30 fill
    // before the max
    const int k0 = tile * BK;
    if ((k0 + BK > tk) || (causal && k0 + BK - 1 > wg_q0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * c4 + (e & 1);
          const bool ok = col < tk && (!causal || col <= row0 + 8 * (e >> 1));
          s[4 * j + e] = ok ? s[4 * j + e] : -1e30f;
        }
    }
    // max and sum over this lane's 16 values of a row run as four
    // independent chains (index [row half][chain]), not one of 16
    float mx[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[h][c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& m = mx[e >> 1][2 * (j & 1) + (e & 1)];
        m = fmaxf(m, s[4 * j + e]);
      }
    float ms[2];   // the new max in base-2 units: Dh^-1/2 log2(e) m
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run[h], tmax);
      alpha[h] = ex2((m_run[h] - m_new) * scale_log2);   // 0 at tile 0
      m_run[h] = m_new;
      ms[h] = m_new * scale_log2;
    }
    // p = 2^(s Dh^-1/2 log2(e) - ms): one fused multiply-add and one ex2
    float ls[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) ls[h][c] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], scale_log2, -ms[e >> 1]));
        ls[e >> 1][2 * (j & 1) + (e & 1)] += p;
        s[4 * j + e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_run[h] = l_run[h] * alpha[h] +
                 ((ls[h][0] + ls[h][1]) + (ls[h][2] + ls[h][3]));
  };
  // p rounded to bf16 in pairs: the accumulator fragment of S is the A
  // fragment of P V (k step kk covers keys 16kk .. 16kk + 15 of the tile)
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

  // tile 0: S and its softmax, nothing to overlap with yet
  advance(0);
  wgmma_fence();
  start_qk(0);
  wgmma_wait<0>();
  pin(s);
  softmax(0);
  pack_p();
  // tile i: S of tile i and O += P V of tile i-1 go to the tensor cores
  // together; the softmax of tile i runs while the second is still at work
  for (int i = 1; i < ntiles; ++i) {
    advance(i);
    rescale_o();
    wgmma_fence();
    start_qk(i);
    start_pv(i - 1);
    wgmma_wait<1>();   // S is done (the groups retire in order)
    pin(s);
    softmax(i);
    wgmma_wait<0>();   // O is done, and pa is no longer being read
#pragma unroll
    for (int n = 0; n < NP; ++n) pin(o_acc[n]);
    pack_p();
  }
  rescale_o();
  wgmma_fence();
  start_pv(ntiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NP; ++n) pin(o_acc[n]);
  cp_async_wait<0>();

  // O / max(l, 1e-30) to bf16, staged through the ring (one tile a
  // warpgroup, same swizzle) and stored 16 bytes a thread
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    l_run[h] = 1.f / fmaxf(l_run[h], 1e-30f);
  }
  __syncthreads();   // every warpgroup is done reading the ring
  unsigned char* o_tile =
      smem_raw + (ring - smem_u32(smem_raw)) + wg * TILE;
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h;
        const uint32_t val = pack_bf16(o_acc[n][4 * j + 2 * h] * l_run[h],
                                       o_acc[n][4 * j + 2 * h + 1] * l_run[h]);
        *reinterpret_cast<uint32_t*>(o_tile + tile_offset(row, 8 * n + j) +
                                     4 * c4) = val;
      }
  // the warpgroup's own rows only: a barrier of its 128 threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
  constexpr int CHUNKS = D / 8;
  __nv_bfloat16* ob = o + ((size_t)bh * tq + wg_q0) * D;
  const int wtid = tid & 127;
#pragma unroll
  for (int pass = 0; pass < 64 * CHUNKS / 128; ++pass) {
    const int i = wtid + pass * 128;
    const int row = i / CHUNKS, c = i % CHUNKS;
    if (wg_q0 + row < tq)
      *reinterpret_cast<uint4*>(ob + (size_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(o_tile + tile_offset(row, c));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int tq, int tk, int causal, void* stream) {
  constexpr int smem = smem_bytes<D>();
  static bool configured = false;   // the attribute is set once, not per launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  // scores in base 2: Dh^-1/2 * log2(e) in one factor
  const float scale_log2 =
      (float)((1.0 / sqrt((double)D)) * 1.4426950408889634);
  flash_fwd_wgmma_kernel<D>
      <<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), tq, tk, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [bh, tq, D], k/v: [bh, tk, D], o: [bh, tq, D], all contiguous, one
// dtype: 0 = float32, 1 = bfloat16. D in {32, 64} (the demo, large-v3).
// The SIMT kernel.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   int bh, int tq, int tk, int head_dim, int dtype,
                   int causal, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(head_dim, q, k, v, o, bh, tq, tk, causal, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, bh, tq, tk, causal,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 q, k, v, o as above, D = 64; every
// pointer 16-byte aligned.
int flash_attn_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                         int bh, int tq, int tk, int head_dim, int causal,
                         void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || head_dim != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return tc::launch<64>(q, k, v, o, bh, tq, tk, causal, stream);
}

}  // extern "C"
