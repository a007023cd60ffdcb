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
// This is exactly janus_tpu_torch/ops/attention.py attend with the caches'
// mask, the counterpart of janus_tpu/ops/attention.py:43 attend, which XLA
// compiles on the TPU at decode widths (no Pallas kernel). In PyTorch it is
// about a dozen launches, widening the whole of K and V to fp32 in memory on
// every call; here K and V are read once, in their own dtype, and widened in
// registers.
//
// Bound on the H100: bytes. At the large-v3 decode step's cross-attention
// (B 8, H 20, T 500, Dh 64, bf16) a launch must read 20.5 MB of K and V:
// ~6.1 us at 3.35 TB/s. Its self-attention over a cache of 25 positions
// reads ~1 MB, which launch latency outweighs.
//
// Design (K4's dense sibling, csrc/cross_attn_int8.cu):
//
// - Grid (splits, B*H, query-row chunks of QB = 1 or 4). T is cut into
//   tiles dealt round-robin to `splits` blocks (a power of two up to 4; the
//   wrapper asks for at most 2: chip_smoke.py's T 500 row took 0.0156 ms
//   with 4 splits and two exchanges, 0.0111 with 2 and one), which form a
//   thread-block cluster. A tile is 8 passes of the block's 128
//   threads; in a pass, G consecutive lanes (Dh / E rounded up to a power of
//   two; at Dh 48 the last lanes of a group idle) read one position's row in
//   16-byte chunks of E values, so a warp reads whole rows.
// - No online softmax: p is rounded only after the normalisation. Each block
//   writes its scores to shared memory and finds its row maxima m_s and its
//   sums l_s of exp(s - m_s); one exchange through distributed shared
//   memory gives every block the cluster's m = max_s m_s and
//   l = sum_s l_s exp(m_s - m) (in split order; l rounds otherwise than a
//   sum of exp(s - m), by an ulp or so, for one cluster barrier fewer); then
//   each block forms p = exp(s - m) / l, rounds it to v's dtype, and
//   multiplies its own tiles of V. Block 0 adds the blocks' PV partials in
//   split order: deterministic, no scratch in device memory, no atomics.
// - The first tile's K and V loads are requested before any is used; later
//   tiles (T over 4 tiles) load as they come.
// - The fill point is read on the device (pos_dev), so a captured step
//   replays with the position it finds there; keys at or past
//   min(T, pos + last row + 1) are never read, so stale slots of a reused
//   cache never enter (they are masked by index, not assumed zero).
// - Scores take QB x (the block's tiles x TILE) fp32 of dynamic shared
//   memory, under 48 KB at these widths, so no attribute is set at launch.
// - The output is written through its strides: the wrapper hands a
//   [B, tq, H, Dh] buffer, so merging the heads afterwards is a view.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int PASSES = 8;  // passes of the block over a tile
constexpr int MAX_SPLITS = 4;
constexpr int SMEM_LIMIT = 48 * 1024;

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

template <typename T>
struct Shape {
  static constexpr int E = 16 / sizeof(T);  // values in a 16-byte chunk
};

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <typename TKV, int DH>
struct Tiling {
  static constexpr int E = Shape<TKV>::E;
  static constexpr int NC = DH / E;                 // chunks of a row
  static constexpr int G = pow2_at_least(NC);       // lanes per position
  static constexpr int PPP = NT / G;                // positions per pass
  static constexpr int TILE = PPP * PASSES;
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

struct Strides {
  long long b, h, t;  // elements between batches, heads, rows
};

// grid (splits, B*H, ceil(tq / QB)), cluster (splits, 1, 1)
template <typename TQ, typename TKV, int DH, int QB>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, TQ* __restrict__ out, int heads,
                   int tq, int t_len, Strides qs, Strides ks, Strides vs,
                   Strides os, const long long* __restrict__ pos_dev,
                   long long pos_host, int masked, float scale) {
  using Ti = Tiling<TKV, DH>;
  constexpr int E = Ti::E, NC = Ti::NC, G = Ti::G, PPP = Ti::PPP,
                TILE = Ti::TILE;
  extern __shared__ float sc[];  // [QB][block tiles * TILE]
  __shared__ float wred[NWARPS][QB];
  __shared__ __align__(16) float red[NWARPS][QB][DH];
  // this block's row maxima, sums and PV partial, read by the cluster
  __shared__ float part_m[QB];
  __shared__ float part_l[QB];
  __shared__ float part_o[QB][DH];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % G;    // chunk of the row: values c*E .. c*E + E - 1
  const bool has_chunk = c < NC;  // lanes past the row's chunks idle
  const int pp = tid / G;   // position within a pass
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.z * QB;
  const int nq = min(QB, tq - q0);
  const int ntile = (t_len + TILE - 1) / TILE;
  const int nloc = ((ntile - split + nsplit - 1) / nsplit) * TILE;

  // keys j <= last[r] for row r; none at or past n_read are read
  long long base_pos = masked ? (pos_dev ? *pos_dev : pos_host) : t_len;
  long long last[QB];
#pragma unroll
  for (int r = 0; r < QB; ++r) last[r] = masked ? base_pos + q0 + r : t_len;
  const int n_read =
      (int)min((long long)t_len, masked ? base_pos + q0 + nq : t_len);

  // this lane's chunk of every query row, widened (rows past tq are zero)
  float qf[QB][E];
  const TQ* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.t + c * E;
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qf[r][e] = r < nq && has_chunk ? to_float(qb[r * qs.t + e]) : 0.f;

  const TKV* kb = k + b * ks.b + h * ks.h + c * E;
  const TKV* vb = v + b * vs.b + h * vs.h + c * E;
  uint4 vw[PASSES];  // the block's first tile of V, loaded with its K

  // scores: s * scale for keys a row sees, -inf for the keys it does not
  for (int i = 0, tile = split; tile < ntile; ++i, tile += nsplit) {
    const int t0 = tile * TILE;
    if (t0 >= n_read) break;
    uint4 kw[PASSES];
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      const int tau = t0 + j * PPP + pp;
      kw[j] = tau < n_read && has_chunk
                  ? __ldg(reinterpret_cast<const uint4*>(kb + tau * ks.t))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int tau = t0 + j * PPP + pp;
        vw[j] = tau < n_read && has_chunk
                    ? __ldg(reinterpret_cast<const uint4*>(vb + tau * vs.t))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      float kf[E];
      cvt(kw[j], kf, static_cast<const TKV*>(nullptr));
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
      const int tau = t0 + j * PPP + pp;
      if (c == 0 && tau < n_read) {
#pragma unroll
        for (int r = 0; r < QB; ++r)
          sc[r * nloc + i * TILE + j * PPP + pp] =
              tau <= last[r] ? dot[r] * scale : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the local index li of this block holds key tau(li), read iff < n_read
  auto tau_of = [&](int li) { return (split + (li / TILE) * nsplit) * TILE +
                                     li % TILE; };

  // this block's row maxima and its sums of exp(s - its max), exchanged
  // once; the cluster's max m, and the sum as sum_s l_s exp(m_s - m)
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float m = -INFINITY;
    for (int li = tid; li < nloc; li += NT)
      if (tau_of(li) < n_read) m = fmaxf(m, sc[r * nloc + li]);
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
      for (int li = tid; li < nloc; li += NT)
        if (tau_of(li) < n_read) l += expf(sc[r * nloc + li] - m_blk[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) wred[warp][r] = l;
  }
  __syncthreads();
  if (tid < QB) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) l += wred[w][tid];
    part_l[tid] = l;
    part_m[tid] = m_blk[tid];
  }
  cluster.sync();
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float m = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      m = fmaxf(m, cluster.map_shared_rank(part_m, s)[r]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ms = cluster.map_shared_rank(part_m, s)[r];
      if (ms > -INFINITY)
        l += cluster.map_shared_rank(part_l, s)[r] * expf(ms - m);
    }
    // p = exp(s - m) / l, then rounded to v's dtype
    for (int li = tid; li < nloc; li += NT)
      if (tau_of(li) < n_read)
        sc[r * nloc + li] = round_to(expf(sc[r * nloc + li] - m) / l,
                                     static_cast<const TKV*>(nullptr));
  }
  __syncthreads();

  // PV over this block's tiles, this lane's E columns
  float acc[QB][E];
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  for (int i = 0, tile = split; tile < ntile; ++i, tile += nsplit) {
    const int t0 = tile * TILE;
    if (t0 >= n_read) break;
    if (i > 0) {
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int tau = t0 + j * PPP + pp;
        vw[j] = tau < n_read && has_chunk
                    ? __ldg(reinterpret_cast<const uint4*>(vb + tau * vs.t))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      const int tau = t0 + j * PPP + pp;
      if (tau >= n_read) continue;
      float vf[E];
      cvt(vw[j], vf, static_cast<const TKV*>(nullptr));
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        const float p = sc[r * nloc + i * TILE + j * PPP + pp];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
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
  for (int idx = tid; idx < QB * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[w][r][d];
    part_o[r][d] = o;
  }
  cluster.sync();

  // block 0 adds the cluster's partials in split order
  if (split == 0) {
    TQ* ob = out + b * os.b + h * os.h + (long long)q0 * os.t;
    for (int idx = tid; idx < nq * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH;
      float o = 0.f;
      for (int s = 0; s < nsplit; ++s)
        o += cluster.map_shared_rank(&part_o[0][0], s)[r * DH + d];
      store(ob + r * os.t + d, o);
    }
  }
  // no block leaves while block 0 may still read its shared memory
  cluster.sync();
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int batch, heads, tq, t_len;
  Strides qs, ks, vs, os;
  const long long* pos_dev;
  long long pos_host;
  int masked;
  float scale;
  int splits;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int DH, int QB>
int launch(const Args& a) {
  using Ti = Tiling<TKV, DH>;
  const int ntile = (a.t_len + Ti::TILE - 1) / Ti::TILE;
  if (a.splits < 1 || a.splits > MAX_SPLITS || (a.splits & (a.splits - 1)) ||
      a.splits > ntile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nloc = ((ntile + a.splits - 1) / a.splits) * Ti::TILE;
  const size_t smem = sizeof(float) * QB * nloc;
  const size_t fixed = sizeof(float) * (NWARPS * QB + NWARPS * QB * DH +
                                        2 * QB + QB * DH);
  if (smem + fixed > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
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
      &cfg, decode_attn_kernel<TQ, TKV, DH, QB>, static_cast<const TQ*>(a.q),
      static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<TQ*>(a.out), a.heads, a.tq, a.t_len, a.qs, a.ks, a.vs, a.os,
      a.pos_dev, a.pos_host, a.masked, a.scale);
  if (err != cudaSuccess) return static_cast<int>(err);
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
// pos_dev (an int64 on the device) or, if that is null, pos_host; splits: a
// power of two in [1, 4], at most the number of tiles (see Tiling).
int decode_attn(const void* q, const void* k, const void* v, void* out,
                int batch, int heads, int tq, int t_len, int dh, int q_dtype,
                int kv_dtype, const long long* q_str, const long long* k_str,
                const long long* v_str, const long long* o_str,
                const void* pos_dev, long long pos_host, int masked,
                float scale, int splits, void* stream) {
  if (batch < 1 || heads < 1 || (long long)batch * heads > 65535 || tq < 1 ||
      tq > 16 || t_len < 1 || (masked && !pos_dev && pos_host < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = kv_dtype == 0 ? 4 : 8;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 3; ++i)
    if (k_str[i] % chunk || v_str[i] % chunk)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a = {q, k, v, out, batch, heads, tq, t_len,
                  {q_str[0], q_str[1], q_str[2]},
                  {k_str[0], k_str[1], k_str[2]},
                  {v_str[0], v_str[1], v_str[2]},
                  {o_str[0], o_str[1], o_str[2]},
                  static_cast<const long long*>(pos_dev), pos_host, masked,
                  scale, splits, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_kv<float>(kv_dtype, dh, a);
  if (q_dtype == 1) return by_kv<__nv_bfloat16>(kv_dtype, dh, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
