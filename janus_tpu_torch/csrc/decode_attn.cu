// Dense attention at decode widths: a few query rows over a KV cache or the
// cross-attention K/V, per (batch, head):
//
//   s[r, j] = (sum_d q[r, d] * k[j, d]) * Dh^-1/2         for j <= pos + r
//   p[r, j] = exp(s[r, j] - max_j s[r, :]) / sum_j exp(s[r, j] - max_j s[r, :])
//   o[r, d] = sum_j bf(p[r, j]) * v[j, d]
//
// in fp32, bf() rounding p to v's dtype after the normalisation, the output
// rounded to q's dtype. Keys past pos + r are masked for row r (the decode
// caches' rule: pos is the fill point before this step's write); without a
// mask every key is attended (cross-attention). q is fp32 or bf16, K and V
// fp32 or bf16 (the TTS step's fp32 queries meet a bf16 cache), Dh 32, 48
// (the demo TTS), 64 or 128, at most 16 query rows.
//
// With the step's new rows (k_new, v_new: [B, H, tq, Dh] in q's dtype) the
// kernel also writes the cache: it rounds the rows to the cache's dtype,
// stores them at slots pos .. pos + tq - 1 and scores those keys from the
// rounded values it stored, which is KVCache.write_at followed by the call
// without the rows, bit for bit. The JAX package writes its cache and
// attends inside one compiled step (janus_tpu/ops/attention.py:135-136).
//
// This is exactly janus_tpu_torch/ops/attention.py attend with the caches'
// mask, the counterpart of janus_tpu/ops/attention.py:43 attend, which XLA
// compiles on the TPU at decode widths (no Pallas kernel).
//
// Bound on the H100: bytes. At the large-v3 decode step's cross-attention
// (B 8, H 20, T 500, Dh 64, bf16) a launch must read 20.5 MB of K and V:
// ~6.1 us at 3.35 TB/s. Its self-attention over a cache of 25 positions
// reads ~1 MB, which launch latency outweighs.
//
// Design, for that bound: every byte of a block's keys requested the moment
// it starts, by a copy engine rather than by the threads, and no block-wide
// barrier between a stage landing and the work on it. (Staged by the
// threads' own 16-byte cp.async copies instead, the blocks stalled issuing
// them, the load/store queue full, before any score was taken.)
//
// - Grid (splits, B*H, query-row chunks of QB = 1 or 4); the splits of one
//   (batch, head) form a thread-block cluster (1, 2, 4 or 8 blocks). The
//   keys a chunk reads, [0, n_read) with n_read = min(T, pos + last row + 1)
//   read on the device, are cut into `splits` contiguous ranges, one a
//   block; keys past n_read are never read, so stale slots of a reused
//   cache never enter (masked by index, not assumed zero).
// - Loads: thread 0 asks the TMA unit for the whole range at once, into a
//   ring of STAGES shared-memory slots of `chunk` rows (K in the first
//   half, V in the second, where the range fits; a longer range cycles the
//   ring, each slot refilled once all have read it), each slot completing
//   on its own mbarrier. Strided K/V read whole (the cross-attention's,
//   split_heads of a [B, T, H*Dh] projection: rows H*Dh apart) come as
//   boxes of rows through 4-d tensor maps encoded on the host (rows past T
//   zero-filled); contiguous caches as one bulk copy a slot of exactly the
//   rows before the fill point. The query rows load while K lands.
// - Scores from shared memory as each K slot's barrier completes (G lanes
//   a key, one 16-byte chunk each, a shuffle tree), into a [QB][range]
//   fp32 buffer; V keeps landing meanwhile. No online softmax: p is
//   rounded only after the normalisation. Each block finds its row maxima
//   m_s and its sums l_s of exp(s - m_s) and pushes them into every block
//   of the cluster (one exchange through distributed shared memory, after
//   an early arrive that shows all have started), which gives each the
//   cluster's m = max_s m_s and l = sum_s l_s exp(m_s - m) (in split
//   order); each block forms p = exp(s - m) / l, rounds it to v's dtype
//   and multiplies its V slots. The blocks push their PV partials into
//   block 0's first K slot (read to the end by then); block 0 adds them in
//   split order: deterministic, no scratch in device memory, no atomics,
//   two cluster barriers. A lone block writes its own sum.
// - New rows (fused write) are loaded into registers at the start, rounded
//   to the cache's dtype, placed in their slot when it is read, and stored
//   to the cache by the one block that owns the slot (the split holding it,
//   in the query chunk of its row); every other block that reads the slot
//   takes it from the same registers' source, so none waits on another's
//   store, and the TMA copies stop at the fill point.
// - Shared memory: STAGES x chunk rows of K/V plus QB x range scores (and,
//   for a ring, the partials), dynamic, up to what the static arrays leave
//   of the block's 227 KB (allowed once per instantiation with
//   cudaFuncSetAttribute); the launcher plans chunk (plan_chunk), the
//   caller the splits (plan_splits in ops/decode_attention.py).
// - The output is written through its strides: the wrapper hands a
//   [B, tq, H, Dh] buffer, so merging the heads afterwards is a view.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int STAGES = 4;  // shared-memory stages of the K/V ring
constexpr int MAX_SPLITS = 8;
constexpr int SMEM_MAX = 227 * 1024;  // a block's shared memory, H100

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T's precision, back in fp32
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <typename TKV, int DH>
struct Tiling {
  static constexpr int E = 16 / sizeof(TKV);        // values in a chunk
  static constexpr int NC = DH / E;                 // chunks of a row
  static constexpr int G = pow2_at_least(NC);       // lanes per key
  static constexpr int PPP = NT / G;                // keys per pass
  static constexpr int ROWB = DH * sizeof(TKV);     // bytes of a row
  static_assert(G <= 32 && DH % E == 0, "row in whole chunks");
};

__device__ __forceinline__ void cvt(const uint4& w, float* f, const float*) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void cvt(const uint4& w, float* f,
                                    const __nv_bfloat16*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the producer's arrival, expecting `bytes` from its bulk copies
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
// the box of the 4-d tensor map `map` at (0, c1, c2, c3) by the TMA unit,
// completing on `bar` (rows past the tensor's end are zero-filled)
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c1, int c2, int c3,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(0), "r"(c1),
      "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// the cluster barrier in halves: this thread has started (relaxed), and
// every thread of the cluster has
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// programmatic dependent launch: the next kernel of the stream may start
// (one launched programmatically, the mixed linear of the TTS step's out
// projection, waits for this one before its first read)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// the shared memory this thread's generic loads read is free for the TMA
// unit's writes
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Strides {
  long long b, h, t;  // elements between batches, heads, rows
};

// grid (splits, B*H, ceil(tq / QB)), cluster (splits, 1, 1)
template <typename TQ, typename TKV, int DH, int QB>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const TQ* __restrict__ q, TKV* k, TKV* v,
                   TQ* __restrict__ out, const TQ* k_new, const TQ* v_new,
                   int heads, int tq, int t_len, int cap, int chunk,
                   int slots, Strides qs, Strides ks, Strides vs, Strides os,
                   Strides kns, Strides vns,
                   const long long* __restrict__ pos_dev, long long pos_host,
                   int masked, float scale,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, int box,
                   int heads_inner, int part_off) {
  using Ti = Tiling<TKV, DH>;
  constexpr int E = Ti::E, NC = Ti::NC, G = Ti::G, PPP = Ti::PPP,
                ROWB = Ti::ROWB;
  // [slots][chunk] rows of K or V, then the scores [QB][cap]
  extern __shared__ __align__(128) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem + (size_t)slots * chunk * ROWB);
  __shared__ float wred[NWARPS][QB];
  __shared__ __align__(16) float red[NWARPS][QB][DH];
  // every block's row maxima and sums, pushed by each block into all
  __shared__ float all_m[MAX_SPLITS][QB];
  __shared__ float all_l[MAX_SPLITS][QB];
  // a slot's rows have landed (one phase a fill)
  __shared__ __align__(8) unsigned long long bar[STAGES];

  // the next kernel may start: it waits for this one before its first read
  launch_dependents();
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % G;           // chunk of the row: values c*E .. + E - 1
  const bool has_chunk = c < NC;   // lanes past the row's chunks idle
  const int pp = tid / G;          // key within a pass
  const int split = blockIdx.x, nsplit = gridDim.x;
  const bool clustered = nsplit > 1;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.z * QB;
  const int nq = min(QB, tq - q0);

  // this block has started; waited on before its first write into another
  if (clustered) cluster_arrive_relaxed();
  if (box > 0 && tid == 0) {  // the tensor maps, fetched ahead of the copies
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&map_k))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<unsigned long long>(&map_v))
                 : "memory");
  }

  // keys j <= last[r] for row r; none at or past n_read are read
  const long long base_pos =
      masked ? (pos_dev ? *pos_dev : pos_host) : (long long)t_len;
  const int n_read =
      (int)min((long long)t_len, masked ? base_pos + q0 + nq : t_len);
  const int per = (n_read + nsplit - 1) / nsplit;
  const int lo = min(n_read, split * per);
  const int len = min(n_read, lo + per) - lo;
  const int nchunk = (len + chunk - 1) / chunk;
  const int items = 2 * nchunk;  // K stages, then V stages

  TKV* kb = k + b * ks.b + h * ks.h;
  TKV* vb = v + b * vs.b + h * vs.h;
  const bool fused = k_new != nullptr;
  // the cache's rows this range reads end at the fill point where there are
  // new rows; the rest are the new rows
  const long long wpos = fused ? base_pos : (long long)t_len;

  // the producer (thread 0): a slot's rows by the TMA unit. Strided K/V
  // read whole (cross-attention, box > 0): boxes of `box` rows through the
  // tensor maps; contiguous rows: one bulk copy of the rows before the
  // fill point; strided rows under a mask: a bulk copy a row.
  auto produce = [&](int item) {
    const int s = item % slots;
    unsigned char* dst = smem + (size_t)s * chunk * ROWB;
    const bool is_k = item < nchunk;
    const int key0 = (is_k ? item : item - nchunk) * chunk;
    const long long j0 = lo + key0;
    const int need = min(chunk, len - key0);
    if (box > 0) {
      const int nbox = (need + box - 1) / box;
      mbar_expect(&bar[s], (unsigned)(nbox * box * ROWB));
      // the map's dims ordered by stride: (dim, head, row, batch) where
      // the heads lie inside a row (a split projection), else (dim, row,
      // head, batch)
      const bool inner = (heads_inner >> (is_k ? 0 : 1)) & 1;
      for (int x = 0; x < nbox; ++x) {
        const int row = (int)j0 + x * box;
        tensor_copy(dst + (size_t)x * box * ROWB, is_k ? &map_k : &map_v,
                    inner ? h : row, inner ? row : h, b, &bar[s]);
      }
      return;
    }
    const int n = (int)max(0LL, min((long long)need, wpos - j0));
    mbar_expect(&bar[s], (unsigned)(n * ROWB));
    const TKV* src = is_k ? kb : vb;
    const long long st = is_k ? ks.t : vs.t;
    if (st == DH) {
      if (n > 0) bulk_copy(dst, src + j0 * st, (unsigned)(n * ROWB), &bar[s]);
    } else {
      for (int r = 0; r < n; ++r)
        bulk_copy(dst + r * ROWB, src + (j0 + r) * st, ROWB, &bar[s]);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(slots, items); ++i) produce(i);
  }

  // this lane's chunk of every query row, widened (rows past tq are zero),
  // read while the stages land
  float qf[QB][E];
  const TQ* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.t + c * E;
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qf[r][e] = r < nq && has_chunk ? to_float(qb[r * qs.t + e]) : 0.f;

  // the new rows this range reads (slots wpos .. lo + len - 1), rounded to
  // the cache's dtype, this thread's chunks of them in registers; they
  // enter their stages as those are read, and the block that owns a slot
  // (its row in this query chunk) stores it to the cache
  constexpr int NEW = (16 * NC + NT - 1) / NT;
  const int new0 = (int)(max((long long)lo, wpos) - wpos);
  const int nnew = fused ? max(0, (int)(lo + len - wpos) - new0) : 0;
  uint4 nk[NEW], nv[NEW];
#pragma unroll
  for (int u = 0; u < NEW; ++u) {
    const int idx = tid + u * NT;
    if (idx < nnew * NC) {
      const int row = new0 + idx / NC, c2 = idx % NC;
      const TQ* sk = k_new + b * kns.b + h * kns.h + row * kns.t + c2 * E;
      const TQ* sv = v_new + b * vns.b + h * vns.h + row * vns.t + c2 * E;
      __align__(16) TKV wk[E], wv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        store(&wk[e], to_float(sk[e]));
        store(&wv[e], to_float(sv[e]));
      }
      nk[u] = *reinterpret_cast<const uint4*>(wk);
      nv[u] = *reinterpret_cast<const uint4*>(wv);
    }
  }
  // the new rows of item `item` into its slot (and, where owned, the cache)
  auto place_new = [&](int item) {
    const bool is_k = item < nchunk;
    const int key0 = (is_k ? item : item - nchunk) * chunk;
    const long long j0 = lo + key0;
    const int n = min(chunk, len - key0);
    unsigned char* dst = smem + (size_t)(item % slots) * chunk * ROWB;
#pragma unroll
    for (int u = 0; u < NEW; ++u) {
      const int idx = tid + u * NT;
      if (idx < nnew * NC) {
        const int row = new0 + idx / NC, c2 = idx % NC;
        const long long j = wpos + row;
        if (j >= j0 && j < j0 + n) {
          const uint4 w = is_k ? nk[u] : nv[u];
          *reinterpret_cast<uint4*>(dst + (j - j0) * ROWB + c2 * 16) = w;
          if (row >= q0 && row < q0 + nq)
            *reinterpret_cast<uint4*>((is_k ? kb + j * ks.t : vb + j * vs.t) +
                                      c2 * E) = w;
        }
      }
    }
  };
  // whether item `item` holds new rows (the same in every thread)
  auto has_new = [&](int item) {
    const int key0 = (item < nchunk ? item : item - nchunk) * chunk;
    return nnew > 0 && lo + key0 + min(chunk, len - key0) > wpos;
  };

  long long last[QB];
#pragma unroll
  for (int r = 0; r < QB; ++r) last[r] = masked ? base_pos + q0 + r : t_len;

  // scores: s * scale for keys a row sees, -inf for the keys it does not;
  // each K stage as it lands, the lanes keeping their row maxima
  float tmax[QB];
#pragma unroll
  for (int r = 0; r < QB; ++r) tmax[r] = -INFINITY;
#pragma unroll 1
  for (int i = 0; i < nchunk; ++i) {
    mbar_wait(&bar[i % slots], (i / slots) & 1);
    if (has_new(i)) {
      place_new(i);
      __syncthreads();
    }
    const unsigned char* stg = smem + (size_t)(i % slots) * chunk * ROWB;
    const int key0 = i * chunk, n = min(chunk, len - key0);
#pragma unroll 4
    for (int kb0 = 0; kb0 < n; kb0 += PPP) {  // a trip count the block shares
      const int kk = kb0 + pp;
      const bool ok = kk < n;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (ok && has_chunk)
        w = *reinterpret_cast<const uint4*>(stg + kk * ROWB + c * 16);
      float kf[E];
      cvt(w, kf, static_cast<const TKV*>(nullptr));
      float dot[QB];
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        dot[r] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot[r] = fmaf(qf[r][e], kf[e], dot[r]);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      }
      if (c == 0 && ok) {
        const long long j = lo + key0 + kk;
#pragma unroll
        for (int r = 0; r < QB; ++r) {
          const float s = j <= last[r] ? dot[r] * scale : -INFINITY;
          sc[r * cap + key0 + kk] = s;
          tmax[r] = fmaxf(tmax[r], s);
        }
      }
    }
    if (i + slots < items) {  // the ring: the slot is free once all read it
      __syncthreads();
      if (tid == 0) {
        proxy_fence();
        produce(i + slots);
      }
    }
  }

  // this block's row maxima and its sums of exp(s - its max)
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float m = tmax[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) wred[warp][r] = m;
  }
  __syncthreads();
  float m_blk[QB];
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    m_blk[r] = wred[0][r];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m_blk[r] = fmaxf(m_blk[r], wred[w][r]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float l = 0.f;
    if (m_blk[r] > -INFINITY)
      for (int li = tid; li < len; li += NT)
        l += expf(sc[r * cap + li] - m_blk[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) wred[warp][r] = l;
  }
  __syncthreads();
  // exchange one: each block pushes its maxima and sums into every block
  // of the cluster (all have started), then one barrier; then the
  // cluster's max m and the sum as sum_s l_s exp(m_s - m) in split order.
  // A lone block skips the cluster's barriers.
  if (clustered) cluster_wait();
  if (tid < QB) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) l += wred[w][tid];
    for (int s = 0; s < nsplit; ++s) {
      *(clustered ? cluster.map_shared_rank(&all_m[split][tid], s)
                  : &all_m[split][tid]) = m_blk[tid];
      *(clustered ? cluster.map_shared_rank(&all_l[split][tid], s)
                  : &all_l[split][tid]) = l;
    }
  }
  if (clustered)
    cluster.sync();
  else
    __syncthreads();
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float m = -INFINITY;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, all_m[s][r]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ms = all_m[s][r];
      if (ms > -INFINITY) l = fmaf(all_l[s][r], expf(ms - m), l);
    }
    // p = exp(s - m) / l, then rounded to v's dtype
    for (int li = tid; li < len; li += NT)
      sc[r * cap + li] = round_to(expf(sc[r * cap + li] - m) / l,
                                  static_cast<const TKV*>(nullptr));
  }
  __syncthreads();

  // PV over this block's V stages, this lane's E columns, keys in order
  float acc[QB][E];
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
#pragma unroll 1
  for (int i = nchunk; i < items; ++i) {
    mbar_wait(&bar[i % slots], (i / slots) & 1);
    if (has_new(i)) {
      place_new(i);
      __syncthreads();
    }
    const unsigned char* stg = smem + (size_t)(i % slots) * chunk * ROWB;
    const int key0 = (i - nchunk) * chunk, n = min(chunk, len - key0);
    if (has_chunk) {
#pragma unroll 4
      for (int kk = pp; kk < n; kk += PPP) {
        float vf[E];
        cvt(*reinterpret_cast<const uint4*>(stg + kk * ROWB + c * 16), vf,
            static_cast<const TKV*>(nullptr));
#pragma unroll
        for (int r = 0; r < QB; ++r) {
          const float p = sc[r * cap + key0 + kk];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
    if (i + slots < items) {
      __syncthreads();
      if (tid == 0) {
        proxy_fence();
        produce(i + slots);
      }
    }
  }
  // over the lanes of a warp that hold the same columns, then the warps
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  if (lane < G && has_chunk) {
#pragma unroll
    for (int r = 0; r < QB; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) red[warp][r][c * E + e] = acc[r][e];
  }
  __syncthreads();
  TQ* ob = out + b * os.b + h * os.h + (long long)q0 * os.t;
  if (!clustered) {  // a lone block: its warps' sum is the output
    for (int idx = tid; idx < nq * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) o += red[w][r][d];
      store(ob + r * os.t + d, o);
    }
    return;
  }
  // this block's partial, pushed into block 0's [split][QB][DH] partials,
  // which lie in block 0's first K slot (read to the end before exchange
  // one) or, for a ring, past the scores
  float* part_o = reinterpret_cast<float*>(smem + part_off);
  float* dst0 = cluster.map_shared_rank(part_o + split * QB * DH, 0);
  for (int idx = tid; idx < QB * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[w][r][d];
    dst0[idx] = o;
  }
  // exchange two: after it no block touches another's shared memory, so
  // the others leave while block 0 adds the partials in split order
  cluster.sync();
  if (split == 0) {
    for (int idx = tid; idx < nq * DH; idx += NT) {
      float o = 0.f;
      for (int s = 0; s < nsplit; ++s) o += part_o[s * QB * DH + idx];
      store(ob + (idx / DH) * os.t + idx % DH, o);
    }
  }
}

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

struct Args {
  const void *q, *k, *v;
  void* out;
  const void *k_new, *v_new;
  int batch, heads, tq, t_len;
  Strides qs, ks, vs, os, kns, vns;
  const long long* pos_dev;
  long long pos_host;
  int masked;
  float scale;
  int splits;
  cudaStream_t stream;
};

// keys a slot holds: the block's most keys over half the STAGES slots, in
// whole passes (K and V then all requested at once; block 0's first K slot
// then also takes the cluster's partials, so it is made at least that
// large),
// or as many whole passes as the `room` bytes of dynamic shared memory
// leave beside the scores and the partials (the ring then cycles); 0 if
// not even a pass a slot fits. `part_off`: where the partials lie.
// A block's scores (fp32, its rows times its keys) that a launch always has
// room for: beside the largest static arrays (4 rows at Dh 128, and their
// alignment), the largest partials (8 splits) and a ring of one pass a slot
// (a pass's rows are at most a 16-byte chunk a thread), plan_chunk then
// finds a chunk. ops/decode_attention.py routes only such calls here.
constexpr int SCORE_BYTES = 160 * 1024;
constexpr int STATIC_MAX =
    sizeof(float) * (NWARPS * 4 * (1 + 128) + 2 * MAX_SPLITS * 4) +
    8 * STAGES + 128;
constexpr int PART_MAX = sizeof(float) * MAX_SPLITS * 4 * 128;
static_assert(SCORE_BYTES + STATIC_MAX + PART_MAX + STAGES * NT * 16 <=
                  SMEM_MAX,
              "a block within SCORE_BYTES of scores must have a plan");

template <typename TKV, int DH, int QB>
int plan_chunk(int cap, int splits, size_t room, int* slots, size_t* smem,
               int* part_off) {
  using Ti = Tiling<TKV, DH>;
  const size_t scores = sizeof(float) * QB * (size_t)cap;
  const size_t part = splits > 1 ? sizeof(float) * splits * QB * DH : 0;
  const int want = max((cap + STAGES / 2 - 1) / (STAGES / 2),
                       (int)((part + Ti::ROWB - 1) / Ti::ROWB));
  int chunk = (want + Ti::PPP - 1) / Ti::PPP * Ti::PPP;
  *slots = STAGES;
  *part_off = 0;
  size_t ring = (size_t)STAGES * chunk * Ti::ROWB;
  if (scores + ring > room) {
    if (scores + part >= room) return 0;
    chunk = (int)((room - scores - part) / ((size_t)STAGES * Ti::ROWB)) /
            Ti::PPP * Ti::PPP;
    ring = (size_t)STAGES * chunk * Ti::ROWB;
    *part_off = (int)(ring + scores);
    *smem = ring + scores + part;
    return chunk;
  }
  *smem = ring + scores;
  return chunk;
}

template <typename TQ, typename TKV, int DH, int QB>
int launch(const Args& a) {
  if (a.splits < 1 || a.splits > MAX_SPLITS || (a.splits & (a.splits - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attn_kernel<TQ, TKV, DH, QB>;
  // the dynamic shared memory a block may take: what its static arrays
  // leave, allowed once per instantiation
  static size_t room = 0;
  if (room == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_MAX - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for a later launch to report
      return static_cast<int>(err);
    }
    room = SMEM_MAX - attr.sharedSizeBytes;
  }
  const int cap = (a.t_len + a.splits - 1) / a.splits;
  int slots = 0, part_off = 0;
  size_t smem = 0;
  const int chunk =
      plan_chunk<TKV, DH, QB>(cap, a.splits, room, &slots, &smem, &part_off);
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  // strided K/V read whole: tensor maps [batch, head, row, dim] (dim
  // innermost), boxes of whole passes that divide a slot
  CUtensorMap maps[2];
  int box = 0, heads_inner = 0;
  if (!a.masked && (a.ks.t != DH || a.vs.t != DH)) {
    using Ti = Tiling<TKV, DH>;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    for (box = min(chunk, 256) / Ti::PPP * Ti::PPP; chunk % box;
         box -= Ti::PPP) {
    }
    const Strides* st[2] = {&a.ks, &a.vs};
    const void* base[2] = {a.k, a.v};
    for (int i = 0; i < 2; ++i) {
      const bool inner = st[i]->h < st[i]->t;
      heads_inner |= (int)inner << i;
      const cuuint64_t rows = (cuuint64_t)a.t_len, hs = (cuuint64_t)a.heads;
      const cuuint64_t dims[4] = {(cuuint64_t)DH, inner ? hs : rows,
                                  inner ? rows : hs, (cuuint64_t)a.batch};
      const cuuint64_t sr = st[i]->t * sizeof(TKV), sh = st[i]->h * sizeof(TKV);
      const cuuint64_t strides[3] = {inner ? sh : sr, inner ? sr : sh,
                                     st[i]->b * sizeof(TKV)};
      const cuuint32_t boxdim[4] = {(cuuint32_t)DH, inner ? 1u : (cuuint32_t)box,
                                    inner ? (cuuint32_t)box : 1u, 1};
      const cuuint32_t unit[4] = {1, 1, 1, 1};
      const CUresult r = encode(
          &maps[i],
          sizeof(TKV) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          4, const_cast<void*>(base[i]), dims, strides, boxdim, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    memset(maps, 0, sizeof(maps));
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.batch * a.heads, (a.tq + QB - 1) / QB);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q),
      static_cast<TKV*>(const_cast<void*>(a.k)),
      static_cast<TKV*>(const_cast<void*>(a.v)), static_cast<TQ*>(a.out),
      static_cast<const TQ*>(a.k_new), static_cast<const TQ*>(a.v_new),
      a.heads, a.tq, a.t_len, cap, chunk, slots, a.qs, a.ks, a.vs, a.os,
      a.kns, a.vns, a.pos_dev, a.pos_host, a.masked, a.scale, maps[0],
      maps[1], box, heads_inner, part_off);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int DH>
int by_rows(const Args& a) {
  return a.tq == 1 ? launch<TQ, TKV, DH, 1>(a) : launch<TQ, TKV, DH, 4>(a);
}

template <typename TQ, typename TKV>
int by_head_dim(int dh, const Args& a) {
  switch (dh) {
    case 32: return by_rows<TQ, TKV, 32>(a);
    case 48: return by_rows<TQ, TKV, 48>(a);
    case 64: return by_rows<TQ, TKV, 64>(a);
    case 128: return by_rows<TQ, TKV, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int by_kv(int kv_dtype, int dh, const Args& a) {
  if (kv_dtype == 0) return by_head_dim<TQ, float>(dh, a);
  if (kv_dtype == 1) return by_head_dim<TQ, __nv_bfloat16>(dh, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out: [batch, heads, tq, dh] through their strides (elements; the last
// axis of unit stride), q_dtype 0 = fp32, 1 = bf16, out in q's dtype; k, v:
// [batch, heads, t_len, dh] likewise, kv_dtype the same codes, 16-byte
// aligned with strides in whole 16-byte chunks; tq in [1, 16]; dh in {32, 48,
// 64, 128}. masked: key j is seen by row r iff j <= pos + r, pos read from
// pos_dev (an int64 on the device) or, if that is null, pos_host. k_new,
// v_new: null, or the new rows [batch, heads, tq, dh] in q's dtype through
// their strides (unit last stride), which the kernel rounds to kv_dtype and
// stores at slots pos .. pos + tq - 1 of k and v before attending (masked
// only; slots at or past t_len are neither read nor written). splits: a
// power of two in [1, 8] (the blocks of a cluster).
int decode_attn(const void* q, void* k, void* v, void* out,
                const void* k_new, const void* v_new, int batch, int heads,
                int tq, int t_len, int dh, int q_dtype, int kv_dtype,
                const long long* q_str, const long long* k_str,
                const long long* v_str, const long long* o_str,
                const long long* kn_str, const long long* vn_str,
                const void* pos_dev, long long pos_host, int masked,
                float scale, int splits, void* stream) {
  if (batch < 1 || heads < 1 || (long long)batch * heads > 65535 || tq < 1 ||
      tq > 16 || t_len < 1 || (masked && !pos_dev && pos_host < 0) ||
      (!k_new != !v_new) || (k_new && !masked))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = kv_dtype == 0 ? 4 : 8;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 3; ++i)
    if (k_str[i] % chunk || v_str[i] % chunk)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides none = {0, 0, 0};
  const Args a = {q, k, v, out, k_new, v_new, batch, heads, tq, t_len,
                  {q_str[0], q_str[1], q_str[2]},
                  {k_str[0], k_str[1], k_str[2]},
                  {v_str[0], v_str[1], v_str[2]},
                  {o_str[0], o_str[1], o_str[2]},
                  k_new ? Strides{kn_str[0], kn_str[1], kn_str[2]} : none,
                  v_new ? Strides{vn_str[0], vn_str[1], vn_str[2]} : none,
                  static_cast<const long long*>(pos_dev), pos_host, masked,
                  scale, splits, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_kv<float>(kv_dtype, dh, a);
  if (q_dtype == 1) return by_kv<__nv_bfloat16>(kv_dtype, dh, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
