// YIN block sums: bs[b, blk, tau] = sum_{i<hop} x[b, blk*hop + i] *
// x[b, blk*hop + tau + i], fp32, summed over i in index order.
//
// Replaces the Pallas kernel janus_tpu/ops/yin_pallas.py:_kernel (entry
// point block_sums), the same sum as janus_tpu/ops/yin.py:_block_sums_xla.
//
// Bound on the H100: operations. At the 16 kHz serving geometry (hop 170,
// 402 lags) and the 8 x 10 s flagship batch: 8 x 945 x 402 x 170 MACs
// (~1.0 GFLOP) against ~5 MB of signal in and ~12 MB of sums out, so the
// fp32 FMA rate (67 TFLOP/s) bounds it before HBM does. There is no
// tensor-core form in fp32: the matrix of a row is built from the row
// itself, and TF32 would not hold the 2e-4 bar.
//
// Two entry points:
//
// yin_block_sums_tiled. An SM starts one warp-wide shared-memory load a
// clock against four warp-wide FMAs, so a loop with two loads per FMA (the
// simple kernel below) sits at 1/8 of the FMA rate. Here a thread owns
// TL = 8 consecutive lags of one row and keeps the lagged samples in a
// sliding register window of 12: four steps of i take one 16-byte load of
// the row's leading samples (the same address across a row's lanes: a
// broadcast), one 16-byte load of new window samples and 32 FMAs. Each
// output is still one fmaf chain over i in index order from 0, so the
// result is bit-identical to the simple kernel's; the eight chains of a
// thread give the instruction-level parallelism.
//   Rows: blk * hop is not a multiple of 4 for every row, so each row's
// span is staged at an aligned pitch of its own (neighbouring rows' overlap
// is copied again in shared memory, read once from HBM and otherwise from
// L2). Lanes of a warp load 16 bytes at a stride of 32 bytes; within a
// quarter-warp lanes g and g + 4 would hit the same banks. The staged rows
// are therefore kept twice, the second copy 4 words (4 banks) further, and
// every other run of four lag groups reads the second copy: the eight loads
// of a quarter-warp then cover all 32 banks (conflict-free by construction,
// not measured), and every address in the loop is a pointer plus a constant.
// A first version stored one copy under an XOR swizzle instead; its index
// arithmetic cost 17 instructions per 32 FMAs (SASS of the loop); this loop
// has 19 other instructions per 96 FMAs. The rows are staged with 4-byte
// cp.async copies, all in flight before the block waits once.
//   Work: a block takes `rows` consecutive rows and walks rows x ceil(
// n_lags / 8) items in a flat loop; the wrapper picks `rows` so that the
// item count sits just under a multiple of the block's 256 threads (5 rows
// x 51 groups = 255 at 402 lags) and the staged rows fit. Sums leave
// through shared memory (under an XOR swizzle, for the same reason) so that
// global stores are consecutive words across lanes, whatever the alignment
// of a row of sums.
//
// yin_block_sums_simple. One thread per (row, tau) output, two shared loads
// per FMA, 8 rows' contiguous span staged once. Kept as the yardstick the
// tiled kernel is timed against and held equal to, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per block, both kernels
constexpr int TL = 8;     // lags per thread (tiled)
constexpr int RB = 8;     // rows per block (simple)
constexpr int SMEM_LIMIT = 232448;   // bytes a block can use on the H100

__device__ __forceinline__ int swz(int j) { return j ^ ((j >> 3) & 4); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One word from global to shared memory without passing a register (zero
// where !ok): a block's copies are all in flight before it waits once.
__device__ __forceinline__ void stage4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Shared memory, in words: copy 0 of the staged rows [rows_per_block][pitch],
// 4 words of skew, copy 1 [rows_per_block][pitch], 4 words, then the sums
// [rows_per_block][lags_pad] under swz. pitch is a multiple of 32 and
// >= round4(hop) + lags_pad + 8; lags_pad = 8 * groups.
__global__ void __launch_bounds__(NT)
yin_tiled_kernel(const float* __restrict__ x, int t_len, int nblk, int hop,
                 int n_lags, int rows_per_block, int groups, int pitch,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int blk0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, nblk - blk0);
  const int lags_pad = TL * groups;
  const int skewed = rows_per_block * pitch + 4;   // copy 1 from copy 0
  float* sums = xs + 2 * skewed;
  const float* xb = x + (size_t)b * t_len;

  for (int r = 0; r < rows; ++r) {
    const int base = (blk0 + r) * hop;
    float* row = xs + r * pitch;
    for (int j = tid; j < pitch; j += NT) {
      const int g = base + j;
      const bool ok = g < t_len;
      const float* src = xb + (ok ? g : 0);
      stage4(row + j, src, ok);
      stage4(row + skewed + j, src, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int hop4 = hop & ~3;
  for (int item = tid; item < rows * groups; item += NT) {
    const int r = item / groups;
    const int group = item - r * groups;
    const float* row = xs + r * pitch;
    // lanes g and g + 4 of a quarter-warp are 32 words apart: one of them
    // reads the copy that sits 4 banks further
    const float* wp = row + TL * group + ((group >> 2) & 1) * skewed;
    float acc[TL];
#pragma unroll
    for (int l = 0; l < TL; ++l) acc[l] = 0.f;
    float w[TL + 4];   // row[tau0 + i .. tau0 + i + 11]
#pragma unroll
    for (int c = 0; c < TL + 4; c += 4) {
      const float4 v = ld4(wp + c);
      w[c] = v.x; w[c + 1] = v.y; w[c + 2] = v.z; w[c + 3] = v.w;
    }
    int i = 0;
#pragma unroll 3
    for (; i < hop4; i += 4) {
      const float4 nw = ld4(wp + i + TL + 4);
      const float4 a4 = ld4(row + i);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int l = 0; l < TL; ++l) acc[l] = fmaf(a[s], w[s + l], acc[l]);
#pragma unroll
      for (int c = 0; c < TL; ++c) w[c] = w[c + 4];
      w[TL] = nw.x; w[TL + 1] = nw.y; w[TL + 2] = nw.z; w[TL + 3] = nw.w;
    }
    for (int s = 0; s < hop - hop4; ++s) {   // hop % 4 trailing steps
      const float a = row[i + s];
#pragma unroll
      for (int l = 0; l < TL; ++l) {
        // w[s + l] with s < 4, resolved without dynamic register indexing
        const float ws = s == 0 ? w[l] : s == 1 ? w[l + 1]
                       : s == 2 ? w[l + 2] : w[l + 3];
        acc[l] = fmaf(a, ws, acc[l]);
      }
    }
    const int at = r * lags_pad + TL * group;   // a multiple of 8 words
    const int flip = (at >> 3) & 4;
    *reinterpret_cast<float4*>(sums + at + flip) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(sums + at + (4 ^ flip)) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();

  float* ob = out + ((size_t)b * nblk + blk0) * n_lags;
  for (int r = 0; r < rows; ++r)
    for (int tau = tid; tau < n_lags; tau += NT)
      ob[(size_t)r * n_lags + tau] = sums[swz(r * lags_pad + tau)];
}

__global__ void __launch_bounds__(NT)
yin_simple_kernel(const float* __restrict__ x, int t_len, int nblk, int hop,
                  int n_lags, float* __restrict__ out) {
  extern __shared__ float xs[];
  const int b = blockIdx.y;
  const int blk0 = blockIdx.x * RB;
  const int base = blk0 * hop;
  const int span = RB * hop + n_lags - 1;
  const float* xb = x + (size_t)b * t_len;
  for (int idx = threadIdx.x; idx < span; idx += NT) {
    const int g = base + idx;
    xs[idx] = g < t_len ? xb[g] : 0.f;
  }
  __syncthreads();

  const int rows = min(RB, nblk - blk0);
  float* ob = out + ((size_t)b * nblk + blk0) * n_lags;
  for (int o = threadIdx.x; o < rows * n_lags; o += NT) {
    const int r = o / n_lags, tau = o - r * n_lags;
    const float* a = xs + r * hop;
    float acc = 0.f;
    for (int i = 0; i < hop; ++i) acc = fmaf(a[i], a[tau + i], acc);
    ob[o] = acc;
  }
}

// raise a kernel's dynamic shared-memory cap only when a call needs more
// than was granted before (48 KB needs no grant)
template <typename K>
cudaError_t grant(K kernel, size_t smem, size_t* granted) {
  if (smem <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *granted = smem;
  return err;
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [n_signals, t_len] fp32 (the aubio slide-block stream layout);
// out: [n_signals, nblk, n_lags]. Samples past t_len read as zero.
// rows, groups, pitch: the wrapper's plan (see the kernel's note).
int yin_block_sums_tiled(const void* x, int n_signals, int t_len, int nblk,
                         int hop, int n_lags, int rows, int groups,
                         int pitch, void* out, void* stream) {
  if (n_signals < 1 || nblk < 1 || hop < 1 || n_lags < 1 ||
      n_signals > 65535 || rows < 1 || groups * TL < n_lags ||
      pitch % 32 != 0 || pitch < ((hop + 3) & ~3) + groups * TL + 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      ((size_t)rows * (2 * (size_t)pitch + (size_t)groups * TL) + 8);
  if (smem > (size_t)SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 48 * 1024;
  cudaError_t err = grant(yin_tiled_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nblk + rows - 1) / rows, n_signals);
  yin_tiled_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), t_len, nblk, hop, n_lags, rows, groups,
      pitch, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int yin_block_sums_simple(const void* x, int n_signals, int t_len, int nblk,
                          int hop, int n_lags, void* out, void* stream) {
  if (n_signals < 1 || nblk < 1 || hop < 1 || n_lags < 1 ||
      n_signals > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)RB * hop + n_lags - 1);
  if (smem > (size_t)SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 48 * 1024;
  cudaError_t err = grant(yin_simple_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nblk + RB - 1) / RB, n_signals);
  yin_simple_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), t_len, nblk, hop, n_lags,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
