// The mixed-dtype linear: fp32 rows against a bf16 weight,
//
//   y[m, n] = sum_k x[m, k] * float(w[k, n])  (+ float(b[n]))
//
// x [M, K] fp32 row-major, w [K, N] bf16 with N contiguous (rows ld values
// apart), b [N] fp32 or bf16 or none, y [M, N] fp32, for 1 <= M <= 64. Each
// bf16 weight value is widened in registers (exactly), multiplied by the
// fp32 row value and summed in fp32 (fused multiply-adds); the bias is added
// once, after the whole sum, in fp32, and y is stored once. This is the
// function of janus_tpu_torch/ops/mixed_linear.py mixed_linear_plain, the
// counterpart of janus_tpu/ops/layers.py:40 linear under mixed dtypes: the
// TTS's AR step re-enters from its fp32 mel buffer, so its activations stay
// fp32 against bf16 parameters, and XLA fuses the weight's convert into the
// dot on the TPU (no Pallas kernel). In plain PyTorch the weight is widened
// to an fp32 copy for cuBLAS's fp32 product, on every call or once for a
// tree: twice the weight's bytes, read again by the product.
//
// Bound on the H100: bytes, the bf16 weight read once. At the AR step's 8
// rows: 1280 x 1280 is 3.3 MB, 0.98 us at 3.35 TB/s; 1280 x 5120 and 5120
// x 1280 13.1 MB, 3.9 us. The fp32 multiply-adds, M a weight value, stay
// under that up to ~16 rows (67 TFLOP/s outside the tensor cores). Tensor
// cores would round the fp32 rows to TF32, which is not the reference's
// fp32 product, so the product stays on the FMA units.
//
// Design.
// - A block takes 64 output columns (128 bytes of a weight row) and a range
//   of K. The ranges of one column tile form a thread-block cluster of
//   `splits` blocks (1-8), so that every SM streams: a 1280-wide output is
//   20 column tiles, 160 blocks at 8 splits. Ranges start on multiples of 8
//   k-rows.
// - The weight is read row-major as the tree holds it: no transposed or
//   widened copy. 256 threads: 8 column chunks of 8 columns (one 16-byte
//   load, 8 bf16 values widened in registers) x k-lanes x row groups. Each
//   thread loads its own weight chunks straight into registers, in batches
//   of 8 k-rows (4 at 8 rows a group), two batches in flight, each refilled
//   as soon as it is multiplied; the first two are asked for before x, so
//   the weight streams from the start. A weight whose rows are not 16-byte
//   chunks (the stop head's N = 1) is loaded a value at a time, its ragged
//   edge zero-filled.
// - x's rows over the block's range of K are copied into shared memory
//   asynchronously (cp.async: no register holds them while the weight is in
//   flight; passes of at most 24 KB at many rows), one barrier, and the
//   multiply-adds read them from there.
// - The rows are split into groups of 1, 2, 4 or 8 rows (1, 2, 4 or 8
//   groups: 32, 16, 8 or 4 k-lanes); the groups load the same weight
//   chunks, the later ones from the L1 cache, so the weight is read from
//   device memory once at up to 64 rows. A thread keeps 8 columns x its
//   group's rows of fp32 sums.
// - The sums, in a fixed order: each k-lane over its k-rows in increasing
//   order; the four k-lanes of a warp by shuffles ((0 + 1) + (2 + 3)); the
//   warps' sums in order through shared memory; the cluster's blocks in
//   split order. Each block owns an equal share of the tile's outputs:
//   every block stores its sums for a share straight into the owner's
//   shared memory (distributed shared memory, one slot a split), one
//   cluster barrier, then each owner adds its slots in split order, adds
//   the bias and writes y. No atomics and no workspace in device memory:
//   the same inputs give the same bits on every launch, nothing is reset
//   between calls, and a captured step replays.
// - Measured on the H100 (a 1280 x 1280 call at 8 rows inside the
//   replayed AR step, tools/trace_step.py): three earlier forms were
//   slower. The tile brought into shared memory by the TMA unit, one
//   128-byte bulk copy a weight row: 16.5 us (the copies, not the bytes,
//   bounded it). Loads into registers, x staged by plain loads and the
//   owners reading their peers' sums after a cluster barrier, with a second
//   before leaving: 11.1 us (the staging and the reduction's barriers and
//   remote reads cost more than the multiply-adds). x loaded beside the
//   weight from L1, the sums pushed to their owners: 9.1 us. This form:
//   8.5 us.
// - Every block arrives at the cluster barrier at its start and waits on it
//   before its first store into a peer (a peer's shared memory is written
//   only once the peer runs), and every block reaches the second barrier
//   (a block with no columns still owns outputs).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads a block
constexpr int BN = 64;           // output columns a block
constexpr int UNIT = 8;          // a split's range starts on a multiple
constexpr int MAX_SPLITS = 8;    // a portable cluster
constexpr int MAX_ROWS = 64;
constexpr int X_BYTES = 24 * 1024;  // the x rows staged at once, at most

// 8 bf16 values (16 bytes, lowest column first) widened to fp32, exactly
__device__ __forceinline__ void widen8(const uint4& v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ float param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// one fp32 value from global to shared memory, asynchronously (no register
// holds it); then every copy of this thread waited for
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// the cluster barrier in two halves: arrive (release, or relaxed where
// nothing need be seen), then wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 8 weight values of row `row` from column c0 as bf16 bits: one 16-byte
// load (VEC: the chunk lies inside N and is aligned), else one value at a
// time with the columns past N zero
template <bool VEC>
__device__ __forceinline__ uint4 load_w(const __nv_bfloat16* __restrict__ w,
                                        long long ld, int row, int c0,
                                        int n) {
  const __nv_bfloat16* p = w + (long long)row * ld + c0;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = c0 + 2 * i < n ? __ldg(h + 2 * i) : 0u;
    const uint32_t hi = c0 + 2 * i + 1 < n ? __ldg(h + 2 * i + 1) : 0u;
    u[i] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// MT rows a row group, RG row groups: the x rows, the k-lanes, the weight
// rows a thread loads a batch, and the k-lane groups' sums in shared
// memory, [KL / 4][XR][BN] (the owners' slots follow them)
template <int MT, int RG>
struct Plan {
  static constexpr int XR = MT * RG;
  static constexpr int KL = 32 / RG;
  static constexpr int U = MT <= 4 ? 8 : 4;
  static constexpr int PART = (KL / 4) * XR * BN;
};

// grid (splits, ceil(N / BN)), cluster (splits, 1, 1), block NT; dynamic
// shared memory, fp32: the owners' slots (splits x share, share = ceil(m BN
// / splits), rounded up to 4), then max(XR x pass, PART): the x rows of a
// pass (pass k-rows, a multiple of 32), later the k-lane groups' sums.
// VEC: 16-byte weight loads (N and ld multiples of 8, w 16-byte aligned).
template <int MT, int RG, bool VEC>
__global__ void __launch_bounds__(NT, 2)
mixed_linear(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             long long ld, const void* __restrict__ bias, int b_bf16,
             float* __restrict__ y, int m, int k, int n, int pass) {
  using P = Plan<MT, RG>;
  constexpr int XR = P::XR, KL = P::KL, U = P::U;
  extern __shared__ __align__(16) float shared[];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int total = m * BN;
  const int share = (total + nsplit - 1) / nsplit;
  float* slots = shared;  // [nsplit][share], this block's share of y
  float* smem = shared + (nsplit * share + 3) / 4 * 4;
  if (nsplit > 1) cluster_arrive_relaxed();  // this block runs
  const int tid = threadIdx.x;
  const int cc = tid & 7;        // the column chunk
  const int t2 = tid >> 3;
  const int kl = t2 % KL;        // the k-lane
  const int rg = t2 / KL;        // the row group
  const int n0 = blockIdx.y * BN;
  const int cols = min(BN, n - n0);
  const int c0 = n0 + cc * 8;    // this thread's first column
  const bool live = cc * 8 < cols;
  const int units = (k + UNIT - 1) / UNIT;
  const int k0 = (int)((long long)units * split / nsplit) * UNIT;
  const int k1 = min(k, (int)((long long)units * (split + 1) / nsplit) * UNIT);

  float acc[MT][8];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  // batch b of a pass: this thread's weight chunks at k-rows kl + (b U +
  // u) KL of it
  auto load = [&](uint4* wv, int kp, int plen, int b) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = kl + (b * U + u) * KL;
      wv[u] = (live && r < plen) ? load_w<VEC>(w, ld, kp + r, c0, n)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto multiply = [&](const uint4* wv, int plen, int b) {
    const float* xs = smem + rg * MT * pass;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = kl + (b * U + u) * KL;
      if (live && r < plen) {
        float wf[8];
        widen8(wv[u], wf);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float xv = xs[i * pass + r];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(xv, wf[e], acc[i][e]);
        }
      }
    }
  };

  for (int kp = k0; kp < k1; kp += pass) {
    const int plen = min(pass, k1 - kp);
    const int nb = ((plen + KL - 1) / KL + U - 1) / U;  // batches
    uint4 wa[U], wb[U];
    // two batches of the weight in flight, then the pass's x rows copied
    // to shared memory asynchronously (no registers held), then each
    // buffer refilled as soon as it is multiplied
    load(wa, kp, plen, 0);
    if (nb > 1) load(wb, kp, plen, 1);
    if (kp != k0) __syncthreads();  // every thread is done with the last x
    for (int row = 0; row < m && row < XR; ++row)
      for (int r = tid; r < plen; r += NT)
        copy_async4(smem + row * pass + r, x + (long long)row * k + kp + r);
    copy_async_wait();
    __syncthreads();
    for (int j = 0; j < nb; j += 2) {
      multiply(wa, plen, j);
      if (j + 2 < nb) load(wa, kp, plen, j + 2);
      if (j + 1 < nb) {
        multiply(wb, plen, j + 1);
        if (j + 3 < nb) load(wb, kp, plen, j + 3);
      }
    }
  }
  __syncthreads();  // every thread is done with x

  // the warp's four k-lanes, then the warps' sums
  float* part = smem;  // [KL / 4][XR][BN]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = acc[i][e];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
      acc[i][e] = v;
    }
  if ((t2 & 3) == 0) {
    float* dst = part + ((size_t)(kl / 4) * XR + rg * MT) * BN + cc * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float4* d4 = reinterpret_cast<float4*>(dst + i * BN);
      d4[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      d4[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();

  // each output's block sum into its owner's slot for this split
  cg::cluster_group cluster = cg::this_cluster();
  if (nsplit > 1) cluster_wait();  // every peer runs
  for (int e = tid; e < total; e += NT) {
    float s = part[e];
    for (int g = 1; g < KL / 4; ++g) s = __fadd_rn(s, part[g * XR * BN + e]);
    const int owner = e / share;
    float* dst = slots + split * share + (e - owner * share);
    if (nsplit > 1) {
      *cluster.map_shared_rank(dst, owner) = s;
    } else {
      *dst = s;
    }
  }
  if (nsplit > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // this block's share, its splits' sums added in split order, the bias
  const int e0 = split * share;
  const int e1 = min(total, e0 + share);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int ch = e % BN;
    if (ch >= cols) continue;
    float s = slots[e - e0];
    for (int r = 1; r < nsplit; ++r) s = __fadd_rn(s, slots[r * share + e - e0]);
    if (bias != nullptr) s = __fadd_rn(s, param(bias, b_bf16, n0 + ch));
    y[(long long)(e / BN) * n + n0 + ch] = s;
  }
}

struct Args {
  const float* x;
  const __nv_bfloat16* w;
  long long ld;
  const void* bias;
  int b_bf16;
  float* y;
  int m, k, n, splits, rows;
  cudaStream_t stream;
};

// the k-rows of x staged at once: the longest range of a split, in whole
// 32s, at most X_BYTES of the XR rows
int x_pass(int k, int splits, int xr) {
  const int units = (k + UNIT - 1) / UNIT;
  const int longest = ((units + splits - 1) / splits) * UNIT;
  const int cap = (X_BYTES / (4 * xr)) / 32 * 32;
  const int need = (longest + 31) / 32 * 32;
  return need < cap ? need : cap;
}

template <int MT, int RG, bool VEC>
cudaError_t launch_one(const Args& a) {
  using P = Plan<MT, RG>;
  const int share = (a.m * BN + a.splits - 1) / a.splits;
  const int pass = x_pass(a.k, a.splits, P::XR);
  const int xs = P::XR * pass > P::PART ? P::XR * pass : P::PART;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(a.splits, (a.n + BN - 1) / BN);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)((a.splits * share + 3) / 4 * 4 + xs) * 4;
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mixed_linear<MT, RG, VEC>, a.x, a.w, a.ld,
                            a.bias, a.b_bf16, a.y, a.m, a.k, a.n, pass);
}

// `rows` (MT) rows a group, as many groups (RG, up to 8) as m needs
template <int MT, bool VEC>
cudaError_t launch_groups(const Args& a) {
  const int groups = (a.m + MT - 1) / MT;
  if (groups <= 1) return launch_one<MT, 1, VEC>(a);
  if (groups <= 2) return launch_one<MT, 2, VEC>(a);
  if (groups <= 4) return launch_one<MT, 4, VEC>(a);
  return launch_one<MT, 8, VEC>(a);
}

template <bool VEC>
cudaError_t launch(const Args& a) {
  if (a.rows == 1) return launch_groups<1, VEC>(a);
  if (a.rows == 2) return launch_groups<2, VEC>(a);
  if (a.rows == 4) return launch_groups<4, VEC>(a);
  return launch_groups<8, VEC>(a);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [m, k] fp32 row-major; w: [k, n] bf16, rows ld values apart (n
// contiguous); bias: null or [n] (b_dtype 0 = fp32, 1 = bf16); y: [m, n]
// fp32 row-major, written. 1 <= m <= 64; splits 1, 2, 4 or 8 blocks a
// column tile, at most ceil(k / 8); rows 1, 2, 4 or 8 rows a thread's group
// (at most 8 groups: rows >= m / 8). vec: 16-byte weight loads, which need
// n and ld multiples of 8 and w 16-byte aligned; 0: a value at a time (any
// shape).
int mixed_linear_fwd(const void* x, const void* w, long long ld,
                     const void* bias, int b_dtype, void* y, int m, int k,
                     int n, int splits, int rows, int vec, void* stream) {
  if (m < 1 || m > MAX_ROWS || k < 1 || n < 1 || ld < n || splits < 1 ||
      splits > MAX_SPLITS || (splits & (splits - 1)) ||
      splits > (k + UNIT - 1) / UNIT || (n + BN - 1) / BN > 65535 ||
      rows < 1 || rows > 8 || (rows & (rows - 1)) || 8 * rows < m ||
      (b_dtype & ~1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (n % 8 || ld % 8 || (reinterpret_cast<uintptr_t>(w) & 15)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a = {static_cast<const float*>(x),
                  static_cast<const __nv_bfloat16*>(w), ld, bias, b_dtype,
                  static_cast<float*>(y), m, k, n, splits, rows,
                  static_cast<cudaStream_t>(stream)};
  const cudaError_t err = vec ? launch<true>(a) : launch<false>(a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
