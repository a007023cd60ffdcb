// Decode cross-attention over int8 K/V with per-position scales (K4):
//
//   s[r, tau] = (sum_d q[r, d] * kq[d, tau]) * Dh^-1/2 * k_scale[tau]
//   p[r, tau] = exp(s[r, tau] - max_tau s[r, :]),  l[r] = sum_tau p[r, tau]
//   o[r, d]   = (sum_tau (p[r, tau] * v_scale[tau]) * vq[d, tau]) / max(l[r], 1e-30)
//
// per (batch, head), fp32 throughout, the output cast to q's dtype (fp32
// or bf16). K and V are int8, head-dim-major ([BH, Dh, rows of T], the
// layout of QuantKVT); their scales fold into the score columns (K) and the
// probability columns (V), so no dense dequantized copy exists anywhere.
//
// Replaces the Pallas kernel janus_tpu/ops/cross_attn.py:_kernel (entry
// point cross_attention_kv, via _cross_bh).
//
// Bound on the H100: bytes. At the large-v3 flagship decode step (B 8,
// H 20, Dh 64, T 500, one query row) a launch reads 10.24 MB of int8 K/V
// and 0.64 MB of fp32 scales for ~1.3 MFLOP: ~3.3 us at 3.35 TB/s. To come
// near it the card needs on the order of 2 MB in flight, and every SM busy.
//
// Design, for that bound:
//
// - Wide loads. A thread reads 16 positions of one d row at a time: one
//   16-byte load where the rows are 16-byte aligned (quantize_kv_t pads the
//   row stride to a multiple of 16 for that), else four 4-byte loads, else
//   sixteen bytes (the VEC template argument; any T works). A thread requests
//   all its K and all its V loads of a tile before it uses any of them:
//   128 bytes in flight a thread at Dh 64, 16 KB a block.
// - T split across blocks (flash-decoding). A (b, h) pair is cut into
//   tiles of 128 positions, dealt round-robin to `splits` blocks (a power
//   of two up to 8; the wrapper asks for at most 4): 640 blocks at the
//   flagship shape instead of 160. Each block keeps a running max, sum and
//   unnormalised output over its tiles.
// - A deterministic combine inside the launch. The blocks of one (b, h)
//   form a thread-block cluster; each leaves (m, l, o) in its own shared
//   memory, and after a cluster barrier block 0 reads the others' through
//   distributed shared memory and writes
//   o = sum_s e^(m_s - m) o_s / max(sum_s e^(m_s - m) l_s, 1e-30) in a fixed
//   order: no scratch in device memory, no second launch, no float atomics.
// - Within a tile, lane % 8 picks the group of 16 positions and tid / 8 the
//   slice of d rows (d = slice, slice + 16, ...), so eight lanes read 128
//   consecutive bytes of a row. Q K^T sums over d across the slices (two
//   shuffles, then the four warps through shared memory); P V sums over
//   positions across the eight groups (three shuffles).
// - int8 -> fp32 through a byte permute into the mantissa of 2^23 and one
//   subtraction (exact), which the fp32 pipes run at full rate; the
//   integer-to-float conversion unit runs at a quarter of it and would be
//   the limit, not the memory.
// - One query row per block (QB = 1) for the decode step, four (QB = 4)
//   for a prompt; more rows go to further blocks in grid z.
// - No dynamic shared memory, so no attribute to set at launch.
//
// Arithmetic as before: fp32 q times int8 accumulated in fp32, times
// Dh^-1/2 then times k_scale, a max-subtracted exp, p * v_scale against
// int8 V, / max(l, 1e-30), one rounding to q's dtype. The split changes
// only the order of the sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;             // threads per block
constexpr int NWARPS = NT / 32;
constexpr int GROUPS = 8;           // groups of 16 positions in a tile
constexpr int TILE = 16 * GROUPS;   // positions per tile
constexpr int SLICES = NT / GROUPS; // slices of d rows
constexpr int MAX_SPLITS = 8;       // the portable cluster size

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

// 16 int8 at p, of which the first n_valid (may be <= 0 or > 16) lie inside
// the row; what lies past them comes back as anything (the caller masks by
// position) but is never read past the row's storage
template <int VEC>
__device__ __forceinline__ uint4 load16(const int8_t* p, int n_valid) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (VEC == 16) {
    if (n_valid > 0) w = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (VEC == 4) {
    const uint32_t* p4 = reinterpret_cast<const uint32_t*>(p);
    if (n_valid > 0) w.x = __ldg(p4);
    if (n_valid > 4) w.y = __ldg(p4 + 1);
    if (n_valid > 8) w.z = __ldg(p4 + 2);
    if (n_valid > 12) w.w = __ldg(p4 + 3);
  } else {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n_valid)
        words[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                         << (8 * (i & 3));
    w = make_uint4(words[0], words[1], words[2], words[3]);
  }
  return w;
}

// four int8 of a word to fp32, exactly: the byte plus 128 lands in the
// mantissa of 2^23 (a byte permute), and 2^23 + 128 is subtracted
__device__ __forceinline__ void cvt4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ void cvt16(const uint4& w, float* f) {
  cvt4(w.x, f);
  cvt4(w.y, f + 4);
  cvt4(w.z, f + 8);
  cvt4(w.w, f + 12);
}

// grid (splits, B*H, ceil(tq / QB)), cluster (splits, 1, 1)
template <typename T, int DH, int QB, int VEC>
__global__ void __launch_bounds__(NT)
cross_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                       const float* __restrict__ ks,
                       const int8_t* __restrict__ vq,
                       const float* __restrict__ vs, T* __restrict__ out,
                       int tq, int t_len, long long k_row, long long v_row,
                       float scale) {
  static_assert(DH % SLICES == 0, "d rows dealt evenly to the slices");
  constexpr int DPT = DH / SLICES;   // d rows per thread
  __shared__ __align__(16) float red[NWARPS][QB][TILE];  // scores per warp
  __shared__ __align__(16) float pv[QB][TILE];           // p * v_scale
  __shared__ float wred[NWARPS][QB];
  // this block's partial result, read by block 0 of the cluster
  __shared__ float part_o[QB][DH];
  __shared__ float part_m[QB];
  __shared__ float part_l[QB];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane & (GROUPS - 1);   // group of 16 positions
  const int slice = tid / GROUPS;      // d rows slice, slice + 16, ...
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.z * QB;
  const int nq = min(QB, tq - q0);
  const int ntile = (t_len + TILE - 1) / TILE;

  // this thread's d rows of q, in registers (rows past tq are zero)
  const T* qb = q + ((size_t)bh * tq + q0) * DH;
  float qr[QB][DPT];
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      qr[r][i] = r < nq ? to_float(qb[r * DH + slice + SLICES * i]) : 0.f;

  const int8_t* kb = kq + (size_t)bh * DH * k_row;
  const int8_t* vb = vq + (size_t)bh * DH * v_row;
  const float* ksb = ks + (size_t)bh * t_len;
  const float* vsb = vs + (size_t)bh * t_len;

  float m_run[QB], l_thr[QB], o_run[QB][DPT];
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    m_run[r] = -INFINITY;
    l_thr[r] = 0.f;   // this thread's position of every tile
#pragma unroll
    for (int i = 0; i < DPT; ++i) o_run[r][i] = 0.f;
  }

  for (int tile = split; tile < ntile; tile += nsplit) {
    // every load of the tile is requested before any is used
    const int tau0 = tile * TILE + 16 * g;
    const int n_valid = t_len - tau0;
    uint4 kw[DPT], vw[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      kw[i] = load16<VEC>(kb + (size_t)(slice + SLICES * i) * k_row + tau0,
                          n_valid);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      vw[i] = load16<VEC>(vb + (size_t)(slice + SLICES * i) * v_row + tau0,
                          n_valid);
    const int tau = tile * TILE + tid;
    const bool tau_ok = tau < t_len;
    const float ksc = tau_ok ? __ldg(ksb + tau) : 0.f;
    const float vsc = tau_ok ? __ldg(vsb + tau) : 0.f;

    // q . k over this thread's d rows, 16 positions at once
    float acc[QB][16];
#pragma unroll
    for (int r = 0; r < QB; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float f[16];
      cvt16(kw[i], f);
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        const float qv = qr[r][i];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(qv, f[j], acc[r][j]);
      }
    }
    // over the warp's four slices, then the four warps through shared memory
#pragma unroll
    for (int r = 0; r < QB; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 8);
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
      }
    if (lane < GROUPS) {
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        float4* dst = reinterpret_cast<float4*>(&red[warp][r][16 * g]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = make_float4(acc[r][4 * j], acc[r][4 * j + 1],
                               acc[r][4 * j + 2], acc[r][4 * j + 3]);
      }
    }
    __syncthreads();

    // thread tid owns position tile * TILE + tid: score, running max, p
    float s[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      const float dot = (red[0][r][tid] + red[1][r][tid]) +
                        (red[2][r][tid] + red[3][r][tid]);
      s[r] = tau_ok ? dot * scale * ksc : -INFINITY;
      const float wm = warp_max(s[r]);
      if (lane == 0) wred[warp][r] = wm;
    }
    __syncthreads();
    float alpha[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      const float tm = fmaxf(fmaxf(wred[0][r], wred[1][r]),
                             fmaxf(wred[2][r], wred[3][r]));
      // a tile holds at least one position, so m_new is finite
      const float m_new = fmaxf(m_run[r], tm);
      alpha[r] = expf(m_run[r] - m_new);   // 0 on the first tile
      const float p = expf(s[r] - m_new);  // 0 past the end of the row
      l_thr[r] = l_thr[r] * alpha[r] + p;
      pv[r][tid] = p * vsc;
      m_run[r] = m_new;
    }
    __syncthreads();

    // (p * v_scale) . v over this thread's 16 positions, then the 8 groups
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float f[16];
      cvt16(vw[i], f);
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        const float4* pp = reinterpret_cast<const float4*>(&pv[r][16 * g]);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w = pp[j];
          part = fmaf(w.x, f[4 * j], part);
          part = fmaf(w.y, f[4 * j + 1], part);
          part = fmaf(w.z, f[4 * j + 2], part);
          part = fmaf(w.w, f[4 * j + 3], part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        o_run[r][i] = o_run[r][i] * alpha[r] + part;
      }
    }
  }

  // this block's (m, l, o) into its shared memory
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    const float wl = warp_sum(l_thr[r]);
    if (lane == 0) wred[warp][r] = wl;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    if (tid == r) {
      part_l[r] = (wred[0][r] + wred[1][r]) + (wred[2][r] + wred[3][r]);
      part_m[r] = m_run[r];
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        part_o[r][slice + SLICES * i] = o_run[r][i];
    }
  }
  cluster.sync();

  // block 0 combines the cluster's partials, in order of the splits
  if (split == 0) {
    T* ob = out + ((size_t)bh * tq + q0) * DH;
    for (int idx = tid; idx < nq * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH;
      float m = -INFINITY;
      for (int sp = 0; sp < nsplit; ++sp)
        m = fmaxf(m, cluster.map_shared_rank(part_m, sp)[r]);
      float num = 0.f, den = 0.f;
      for (int sp = 0; sp < nsplit; ++sp) {
        const float w = expf(cluster.map_shared_rank(part_m, sp)[r] - m);
        num = fmaf(w, cluster.map_shared_rank(&part_o[0][0], sp)[r * DH + d],
                   num);
        den = fmaf(w, cluster.map_shared_rank(part_l, sp)[r], den);
      }
      store(ob + (size_t)r * DH + d, num / fmaxf(den, 1e-30f));
    }
  }
  // no block leaves while block 0 may still read its shared memory
  cluster.sync();
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs;
  void* out;
  int bh, tq, t_len;
  long long k_row, v_row;
  float scale;
  int splits;
  cudaStream_t stream;
};

template <typename T, int DH, int QB, int VEC>
int launch(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.bh, (a.tq + QB - 1) / QB);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cross_attn_int8_kernel<T, DH, QB, VEC>,
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.kq),
      static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.vq),
      static_cast<const float*>(a.vs), static_cast<T*>(a.out), a.tq, a.t_len,
      a.k_row, a.v_row, a.scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH, int QB>
int by_vec(int vec, const Args& a) {
  switch (vec) {
    case 16: return launch<T, DH, QB, 16>(a);
    case 4: return launch<T, DH, QB, 4>(a);
    case 1: return launch<T, DH, QB, 1>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DH>
int by_rows(int vec, const Args& a) {
  return a.tq == 1 ? by_vec<T, DH, 1>(vec, a) : by_vec<T, DH, 4>(vec, a);
}

template <typename T>
int by_head_dim(int dh, int vec, const Args& a) {
  switch (dh) {
    case 32: return by_rows<T, 32>(vec, a);
    case 64: return by_rows<T, 64>(vec, a);
    case 128: return by_rows<T, 128>(vec, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out: [bh, tq, dh] (dtype 0 = fp32, 1 = bf16), dh in {32, 64, 128};
// kq, vq: int8 [bh, dh, t_len] with k_row / v_row bytes between d rows
// (>= t_len); ks, vs: fp32 [bh, t_len]; scale = dh^-1/2 as fp32; splits: a
// power of two in [1, 8], at most the number of 128-position tiles;
// vec: bytes per load (16, 4 or 1), which the K/V pointers and row strides
// must be multiples of.
int cross_attn_int8(const void* q, const void* kq, const void* ks,
                    const void* vq, const void* vs, void* out, int bh, int tq,
                    int t_len, int dh, int dtype, float scale,
                    long long k_row, long long v_row, int splits, int vec,
                    void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || (tq + 3) / 4 > 65535 || t_len < 1 ||
      k_row < t_len || v_row < t_len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) ||
      splits > (t_len + TILE - 1) / TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec != 16 && vec != 4 && vec != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(vq) |
       static_cast<uintptr_t>(k_row) | static_cast<uintptr_t>(v_row)) &
      static_cast<uintptr_t>(vec - 1))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a = {q, kq, ks, vq, vs, out, bh, tq, t_len, k_row, v_row, scale,
                  splits, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_head_dim<float>(dh, vec, a);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(dh, vec, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
