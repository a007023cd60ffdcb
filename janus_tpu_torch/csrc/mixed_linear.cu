// The mixed-dtype linear: fp32 rows against bf16 weights, one launch for
// one to four weights that share their rows,
//
//   y_g[m, n] = act(sum_k x[m, k] * float(w_g[k, n]) (+ float(b_g[n])))
//
// x [M, K] fp32 row-major; for each member g of the group, w_g [K, N_g]
// bf16 with N contiguous (rows ld_g values apart), b_g [N_g] fp32 or bf16
// or none, y_g [M, N_g] fp32, for 1 <= M <= 64; act is the identity or the
// exact (erf) GELU. Each bf16 weight value is widened in registers
// (exactly), multiplied by the fp32 row value and summed in fp32 (fused
// multiply-adds); the bias is added once, after the whole sum, in fp32,
// then the GELU where asked, and y is stored once. This is the function of
// janus_tpu_torch/ops/mixed_linear.py mixed_linear_plain (gelu of it, one
// call a member), the counterpart of janus_tpu/ops/layers.py:40 linear
// under mixed dtypes (and :256 gelu after fc1): the TTS's AR step
// re-enters from its fp32 mel buffer, so its activations stay fp32 against
// bf16 parameters, and XLA fuses the weight's convert into the dot on the
// TPU (no Pallas kernel). In plain PyTorch the weight is widened to an fp32
// copy for cuBLAS's fp32 product, on every call or once for a tree: twice
// the weight's bytes, read again by the product.
//
// Bound on the H100: bytes, the bf16 weight read once. At the AR step's 8
// rows the product does 2 M = 16 operations a weight value, 8 a weight
// byte, under the fp32 ridge of ~20 (67 TFLOP/s outside the tensor cores
// over 3.35 TB/s): 1280 x 1280 is 3.3 MB, 0.98 us; 1280 x 5120 and 5120 x
// 1280 13.1 MB, 3.9 us. Tensor cores would round the fp32 rows to TF32,
// which is not the reference's fp32 product, so the product stays on the
// FMA units.
//
// Most of a call at a step's few rows is fixed (launch, the first round
// trip to memory, the cluster barrier, the owners' sums), and it does not
// shrink inside a launch. So the design overlaps it with the kernel before
// and pays it fewer times:
// - Programmatic dependent launch. The kernel is launched with
//   programmatic stream serialisation, and the step's kernels before it
//   (the layer norm, the decode attention, this kernel itself) let their
//   dependents start as soon as they start (griddepcontrol.launch_dependents
//   first thing: placed after their inputs were read, the trigger came too
//   late to hide anything; the replayed AR step at b = 8 took 2.06-2.07 ms
//   so against 1.86 with the triggers first, tools/trace_step.py on an H100
//   80GB HBM3 at 700 W). So the kernel starts while the kernel before it
//   still runs. Before griddepcontrol.wait a block only arrives at its
//   cluster barrier, works out its tile and asks the L2 cache for its own
//   range of the weight (cp.async.bulk.prefetch.L2, one request of 128
//   bytes a weight row; a ragged member a prefetch a line): no load into
//   registers or shared memory and no store (without the prefetch the step
//   took 1.90 ms, with a line prefetch for every member 1.89). Hazard
//   note: the weight may have been written by the kernel before (a weight
//   made on the card, then used at once), and that kernel may still run.
//   The prefetch cannot hand a stale value to this kernel: the L2 is the
//   point of coherence, every write lands there and a prefetch only moves
//   lines into it, and every read into a register or shared memory (the
//   weight, x, the bias) and every store come after the wait, which
//   returns once the kernel before has finished and its writes are
//   visible.
// - Members. Linears that read the same rows (q, k, v; the mel and stop
//   heads) are one launch: the column tiles of all members form the grid,
//   each block finds its member from its tile. A member with ragged rows
//   (the stop head's N = 1) is loaded a value at a time in its own tile,
//   the others 16 bytes at a time, in the same launch.
// - GELU in the epilogue (fc1's calls): the owners add the bias, then take
//   the exact GELU, x / 2 (1 + erf(x / sqrt 2)), as PyTorch's kernel takes
//   it.
//
// The product (measured in the replayed step against three other forms:
// the tile brought into shared memory by the TMA unit, one 128-byte bulk
// copy a weight row, 16.5 us at 1280 x 1280 and 8 rows, the copies
// bounding it; loads into registers with x staged by plain loads and the
// owners reading their peers' sums, 11.1 us; x from L1 with the sums pushed
// to their owners, 9.1 us; this form 8.5 us):
// - A block takes 64 output columns (128 bytes of a weight row) and a range
//   of K. The ranges of one column tile form a thread-block cluster of
//   `splits` blocks (1-8), so that every SM streams. Ranges start on
//   multiples of 8 k-rows.
// - The weight is read row-major as the tree holds it: no transposed or
//   widened copy. 256 threads: 8 column chunks of 8 columns (one 16-byte
//   load, 8 bf16 values widened in registers) x k-lanes x row groups. Each
//   thread loads its own weight chunks straight into registers, in batches
//   of 8 k-rows (4 at 8 rows a group), two batches in flight, each refilled
//   as soon as it is multiplied; the first two are asked for before x, so
//   the weight streams from the start.
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
//   the bias (and takes the GELU) and writes y. No atomics and no workspace
//   in device memory: the same inputs give the same bits on every launch,
//   nothing is reset between calls, and a captured step replays.
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
constexpr int MAX_MEMBERS = 4;   // weights a launch
constexpr int X_BYTES = 24 * 1024;  // the x rows staged at once, at most

// one weight of a launch: its column tiles start at tile0 of the grid
struct Member {
  const __nv_bfloat16* w;
  long long ld;
  const void* bias;
  float* y;
  int n, b_bf16, vec, tile0;
};
struct Group {
  Member m[MAX_MEMBERS];
  int count;
};

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
// the exact GELU as PyTorch's kernel takes it: (x * 0.5) * (1 + erf(x *
// sqrt(1/2))), each operation rounded on its own
__device__ __forceinline__ float gelu_erf(float v) {
  return __fmul_rn(__fmul_rn(v, 0.5f),
                   __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
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

// the L2 cache asked for `bytes` (a multiple of 16, 16-byte aligned) from
// p by the TMA unit, or for the line that holds p; nothing reaches a
// register
__device__ __forceinline__ void prefetch_l2_bulk(const void* p,
                                                 unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void prefetch_l2_line(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// programmatic dependent launch: let the next kernel of the stream start;
// wait until the kernel before has finished and its writes are visible (a
// no-op where the launch did not overlap)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// this thread's sums over k-rows [k0, k1): acc[i][e] for row rg MT + i,
// column c0 + e
template <int MT, int RG, bool VEC>
__device__ __forceinline__ void accumulate(
    float (&acc)[MT][8], const float* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, long long ld, float* smem, int m,
    int k, int n, int k0, int k1, int pass, int c0, bool live) {
  using P = Plan<MT, RG>;
  constexpr int XR = P::XR, KL = P::KL, U = P::U;
  const int tid = threadIdx.x;
  const int t2 = tid >> 3;
  const int kl = t2 % KL;  // the k-lane
  const int rg = t2 / KL;  // the row group

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
}

// grid (splits, the members' column tiles), cluster (splits, 1, 1), block
// NT; dynamic shared memory, fp32: the owners' slots (splits x share, share
// = ceil(m BN / splits), rounded up to 4), then max(XR x pass, PART): the x
// rows of a pass (pass k-rows, a multiple of 32), later the k-lane groups'
// sums. A member's vec: 16-byte weight loads (N and ld multiples of 8, w
// 16-byte aligned). act 1: the GELU after the bias.
template <int MT, int RG>
__global__ void __launch_bounds__(NT, 2)
mixed_linear(const float* __restrict__ x, const Group g, int m, int k,
             int pass, int act) {
  using P = Plan<MT, RG>;
  constexpr int XR = P::XR, KL = P::KL;
  extern __shared__ __align__(16) float shared[];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int total = m * BN;
  const int share = (total + nsplit - 1) / nsplit;
  float* slots = shared;  // [nsplit][share], this block's share of y
  float* smem = shared + (nsplit * share + 3) / 4 * 4;
  if (nsplit > 1) cluster_arrive_relaxed();  // this block runs
  // the next kernel may start: it waits for this one before its first read
  launch_dependents();

  // this block's member (a cluster's blocks share one column tile)
  const int tile = blockIdx.y;
  Member mb = g.m[0];
#pragma unroll
  for (int i = 1; i < MAX_MEMBERS; ++i)
    if (i < g.count && tile >= g.m[i].tile0) mb = g.m[i];
  const int tid = threadIdx.x;
  const int cc = tid & 7;        // the column chunk
  const int n0 = (tile - mb.tile0) * BN;
  const int cols = min(BN, mb.n - n0);
  const int c0 = n0 + cc * 8;    // this thread's first column
  const bool live = cc * 8 < cols;
  const int units = (k + UNIT - 1) / UNIT;
  const int k0 = (int)((long long)units * split / nsplit) * UNIT;
  const int k1 = min(k, (int)((long long)units * (split + 1) / nsplit) * UNIT);

  // before the wait: this block's weight rows asked of the L2 cache, and
  // nothing read into a register or written (the hazard note above)
  for (int r = k0 + tid; r < k1; r += NT) {
    const __nv_bfloat16* row = mb.w + (long long)r * mb.ld + n0;
    if (mb.vec) {
      prefetch_l2_bulk(row, (unsigned)(cols * 2));
    } else {
      prefetch_l2_line(row);
      prefetch_l2_line(row + cols - 1);
    }
  }
  wait_prerequisites();

  float acc[MT][8];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  if (mb.vec)
    accumulate<MT, RG, true>(acc, x, mb.w, mb.ld, smem, m, k, mb.n, k0, k1,
                             pass, c0, live);
  else
    accumulate<MT, RG, false>(acc, x, mb.w, mb.ld, smem, m, k, mb.n, k0, k1,
                              pass, c0, live);
  __syncthreads();  // every thread is done with x

  // the warp's four k-lanes, then the warps' sums
  const int t2 = tid >> 3, kl = t2 % KL, rg = t2 / KL;
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
    for (int q = 1; q < KL / 4; ++q) s = __fadd_rn(s, part[q * XR * BN + e]);
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

  // this block's share, its splits' sums added in split order, the bias,
  // the GELU where asked
  const int e0 = split * share;
  const int e1 = min(total, e0 + share);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int ch = e % BN;
    if (ch >= cols) continue;
    float s = slots[e - e0];
    for (int r = 1; r < nsplit; ++r) s = __fadd_rn(s, slots[r * share + e - e0]);
    if (mb.bias != nullptr) s = __fadd_rn(s, param(mb.bias, mb.b_bf16, n0 + ch));
    if (act) s = gelu_erf(s);
    mb.y[(long long)(e / BN) * mb.n + n0 + ch] = s;
  }
}

struct Args {
  const float* x;
  Group g;
  int m, k, tiles, splits, rows, act, pdl;
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

template <int MT, int RG>
cudaError_t launch_one(const Args& a) {
  using P = Plan<MT, RG>;
  const int share = (a.m * BN + a.splits - 1) / a.splits;
  const int pass = x_pass(a.k, a.splits, P::XR);
  const int xs = P::XR * pass > P::PART ? P::XR * pass : P::PART;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  cfg.gridDim = dim3(a.splits, a.tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)((a.splits * share + 3) / 4 * 4 + xs) * 4;
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = a.pdl;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, mixed_linear<MT, RG>, a.x, a.g, a.m, a.k,
                            pass, a.act);
}

// `rows` (MT) rows a group, as many groups (RG, up to 8) as m needs
template <int MT>
cudaError_t launch_groups(const Args& a) {
  const int groups = (a.m + MT - 1) / MT;
  if (groups <= 1) return launch_one<MT, 1>(a);
  if (groups <= 2) return launch_one<MT, 2>(a);
  if (groups <= 4) return launch_one<MT, 4>(a);
  return launch_one<MT, 8>(a);
}

cudaError_t launch(const Args& a) {
  if (a.rows == 1) return launch_groups<1>(a);
  if (a.rows == 2) return launch_groups<2>(a);
  if (a.rows == 4) return launch_groups<4>(a);
  return launch_groups<8>(a);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [m, k] fp32 row-major. `count` members (1-4), each seven values of
// `members`: w (a [k, n] bf16 weight, rows ld values apart, n contiguous),
// ld, bias (null or [n]), b_dtype (0 = fp32, 1 = bf16), y ([m, n] fp32
// row-major, written), n, vec (16-byte weight loads, which need n and ld
// multiples of 8 and w 16-byte aligned; 0: a value at a time, any shape).
// 1 <= m <= 64; splits 1, 2, 4 or 8 blocks a column tile, at most ceil(k /
// 8); rows 1, 2, 4 or 8 rows a thread's group (at most 8 groups: rows >= m
// / 8); act 0 (none) or 1 (the exact GELU after the bias); pdl: a
// programmatic launch (the kernel starts while the one before runs and
// waits for it before its first read).
int mixed_linear_fwd(const void* x, int m, int k, int count,
                     const long long* members, int splits, int rows, int act,
                     int pdl, void* stream) {
  if (m < 1 || m > MAX_ROWS || k < 1 || count < 1 || count > MAX_MEMBERS ||
      splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) ||
      splits > (k + UNIT - 1) / UNIT || rows < 1 || rows > 8 ||
      (rows & (rows - 1)) || 8 * rows < m || (act & ~1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.g.count = count;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = members + 7 * i;
    Member& mb = a.g.m[i];
    mb.w = reinterpret_cast<const __nv_bfloat16*>(d[0]);
    mb.ld = d[1];
    mb.bias = reinterpret_cast<const void*>(d[2]);
    mb.b_bf16 = static_cast<int>(d[3]);
    mb.y = reinterpret_cast<float*>(d[4]);
    mb.n = static_cast<int>(d[5]);
    mb.vec = static_cast<int>(d[6]);
    mb.tile0 = tiles;
    if (mb.n < 1 || mb.ld < mb.n || (mb.b_bf16 & ~1) || mb.w == nullptr ||
        mb.y == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (mb.vec && (mb.n % 8 || mb.ld % 8 ||
                   (reinterpret_cast<uintptr_t>(mb.w) & 15)))
      return static_cast<int>(cudaErrorMisalignedAddress);
    tiles += (mb.n + BN - 1) / BN;
  }
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  a.m = m;
  a.k = k;
  a.tiles = tiles;
  a.splits = splits;
  a.rows = rows;
  a.act = act;
  a.pdl = pdl ? 1 : 0;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch(a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
