// Fused log-mel frontend: Hann window -> real DFT -> power -> Slaney mel ->
// log10(max(mel, 1e-10)), fp32 throughout, nothing between the audio and
// the log-mel in device memory.
//
// Replaces the Pallas kernel janus_tpu/ops/mel_pallas.py:_kernel (entry
// point log_mel_spectrogram_fused). The per-signal (max - 8) floor and the
// (x + 4) / 4 scale need a cross-frame reduction and stay in PyTorch.
//
// Bound on the H100: bytes. The least work log-mel needs is a real FFT per
// frame, |X|^2 and the filterbank's nonzero taps: ~0.1 GFLOP at the 8 x 10 s
// flagship batch, under the ~9 MB of audio in and log-mel out at 3.35 TB/s
// (~0.003 ms). At that size a launch's own floor (a few microseconds) is
// above the bound, so the design aims at little work per frame and many
// independent warps, not at a memory pipeline.
//
// Two entry points:
//
// mel_log10_fft (n_fft 400, the send path's only value). One warp owns two
// consecutive frames a, b of one signal and carries them from staged audio
// to log-mel without a block-wide barrier:
//   1. z[n] = w[n] (x_a[n] + i x_b[n]): two real frames in one complex
//      transform of length 400 = 16 x 25, four-step form with n = 25 n1 + n2
//      and k = k1 + 16 k2. Lane n2 < 25 runs the 16-point DFT over n1 in
//      registers (radix 4 x 4), multiplies by the twiddle W400^(n2 k1) and
//      stores Y[k1][n2];
//   2. lane k1 < 16 runs the 25-point DFT over n2 in registers (radix 5 x 5)
//      and stores Z[k1 + 16 k2];
//   3. X_a[k] = (Z[k] + conj Z[400-k]) / 2, X_b[k] = (Z[k] - conj Z[400-k])
//      / 2i for k = 0..200; the two power spectra overwrite Z in place;
//   4. each lane sums the contiguous run of taps of its mels (a Slaney
//      triangle is nonzero on one run of bins; (first bin, count, offset)
//      per mel and the packed taps come from the wrapper), takes the log
//      and writes both frames' rows.
// The window, the twiddles and the banded filterbank arrive as one table
// designed in float64 by the wrapper; the 16th and 25th roots of unity
// arrive as a kernel parameter, so the unrolled butterflies read them as
// constant-bank operands. No sine or cosine is evaluated here.
// A block of 8 warps owns 16 consecutive frames of one signal and stages
// their contiguous span ((16 - 1) hop + 400 samples) once, with 16-byte
// loads where the signal's interior allows; the n_fft/2 reflect padding is
// an index reflection at load time, so no padded copy of the audio exists.
// Shared-memory layout: re and im of a transform are separate planes of
// 400 words. Step 1 reads and writes consecutive words across lanes; step 2
// reads at a stride of 25 words across lanes (odd, so 16 lanes hit 16
// banks) and writes consecutive words; step 3 reads k and 400 - k, both
// consecutive across lanes: all conflict-free by construction. Step 4 reads
// bins at data-dependent offsets (neighbouring mels start 0-8 bins apart):
// at most 2-way conflicts among the widest filters, not measured.
//
// mel_log10_dense (any other n_fft): the window-folded matmul DFT, two dense
// n_fft x n_freqs fp32 products per frame tiled over the frequency axis and
// a dense filterbank product, on a reflect-padded copy of the signal. At
// n_fft 400 it does ~40x the arithmetic of the FFT route and is kept as the
// yardstick the FFT route is timed against on the same tensors.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_MELS = 128;

// ---------------------------------------------------------------- FFT route

constexpr int NFFT = 400;
constexpr int N1 = 16, N2 = 25;
constexpr int PAIRS = 8;            // frame pairs (= warps) per block
constexpr int FBF = 2 * PAIRS;      // frames per block
constexpr int FNT = 32 * PAIRS;     // threads per block
constexpr int MAX_TAPS = 416;       // packed taps (a bin lies under <= 2 mels)

// the wrapper's table, in 4-byte words (the last three rows hold ints)
constexpr int T_WIN = 0;                      // Hann window [400]
constexpr int T_TWR = T_WIN + NFFT;           // Re W400^(n2 k1) at [k1*25+n2]
constexpr int T_TWI = T_TWR + NFFT;           // Im
constexpr int T_TAPS = T_TWI + NFFT;          // packed filterbank taps
constexpr int T_START = T_TAPS + MAX_TAPS;    // first bin of each mel
constexpr int T_COUNT = T_START + MAX_MELS;   // taps of each mel
constexpr int T_OFFSET = T_COUNT + MAX_MELS;  // where its taps start
constexpr int T_WORDS = T_OFFSET + MAX_MELS;  // 2000
static_assert(T_WORDS % 4 == 0, "the table is copied 16 bytes at a time");

struct Roots {            // exp(-2 pi i j / 16) and exp(-2 pi i j / 25)
  float w16r[N1], w16i[N1], w25r[N2], w25i[N2];
};

__device__ __forceinline__ void cmul(float& r, float& i, float wr, float wi) {
  const float t = r * wr - i * wi;
  i = fmaf(r, wi, i * wr);
  r = t;
}

// 4-point DFT in place (W4 = -i): slot k receives X[k]
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1,
                                     float& i1, float& r2, float& i2,
                                     float& r3, float& i3) {
  const float sr = r0 + r2, si = i0 + i2, dr = r0 - r2, di = i0 - i2;
  const float tr = r1 + r3, ti = i1 + i3, ur = r1 - r3, ui = i1 - i3;
  r0 = sr + tr; i0 = si + ti;
  r2 = sr - tr; i2 = si - ti;
  r1 = dr + ui; i1 = di - ur;
  r3 = dr - ui; i3 = di + ur;
}

// 5-point DFT in place, W5 = (c1, -s1), W5^2 = (c2, -s2)
__device__ __forceinline__ void dft5(float& r0, float& i0, float& r1,
                                     float& i1, float& r2, float& i2,
                                     float& r3, float& i3, float& r4,
                                     float& i4, float c1, float s1, float c2,
                                     float s2) {
  const float t1r = r1 + r4, t1i = i1 + i4, t2r = r2 + r3, t2i = i2 + i3;
  const float t3r = r1 - r4, t3i = i1 - i4, t4r = r2 - r3, t4i = i2 - i3;
  const float a1r = r0 + c1 * t1r + c2 * t2r, a1i = i0 + c1 * t1i + c2 * t2i;
  const float a2r = r0 + c2 * t1r + c1 * t2r, a2i = i0 + c2 * t1i + c1 * t2i;
  const float b1r = s1 * t3r + s2 * t4r, b1i = s1 * t3i + s2 * t4i;
  const float b2r = s2 * t3r - s1 * t4r, b2i = s2 * t3i - s1 * t4i;
  r0 = r0 + t1r + t2r; i0 = i0 + t1i + t2i;
  r1 = a1r + b1i; i1 = a1i - b1r;
  r4 = a1r - b1i; i4 = a1i + b1r;
  r2 = a2r + b2i; i2 = a2i - b2r;
  r3 = a2r - b2i; i3 = a2i + b2r;
}

// 16-point DFT of x[n], n = 4a + b; on return slot 4c + d holds X[c + 4d]
__device__ __forceinline__ void dft16(float (&r)[N1], float (&i)[N1],
                                      const Roots& w) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    dft4(r[b], i[b], r[4 + b], i[4 + b], r[8 + b], i[8 + b], r[12 + b],
         i[12 + b]);
#pragma unroll
  for (int c = 1; c < 4; ++c)
#pragma unroll
    for (int b = 1; b < 4; ++b)
      cmul(r[4 * c + b], i[4 * c + b], w.w16r[b * c], w.w16i[b * c]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dft4(r[4 * c], i[4 * c], r[4 * c + 1], i[4 * c + 1], r[4 * c + 2],
         i[4 * c + 2], r[4 * c + 3], i[4 * c + 3]);
}

// 25-point DFT of x[n], n = 5a + b; on return slot 5c + d holds X[c + 5d]
__device__ __forceinline__ void dft25(float (&r)[N2], float (&i)[N2],
                                      const Roots& w) {
  const float c1 = w.w25r[5], s1 = -w.w25i[5];
  const float c2 = w.w25r[10], s2 = -w.w25i[10];
#pragma unroll
  for (int b = 0; b < 5; ++b)
    dft5(r[b], i[b], r[5 + b], i[5 + b], r[10 + b], i[10 + b], r[15 + b],
         i[15 + b], r[20 + b], i[20 + b], c1, s1, c2, s2);
#pragma unroll
  for (int c = 1; c < 5; ++c)
#pragma unroll
    for (int b = 1; b < 5; ++b)
      cmul(r[5 * c + b], i[5 * c + b], w.w25r[b * c], w.w25i[b * c]);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    dft5(r[5 * c], i[5 * c], r[5 * c + 1], i[5 * c + 1], r[5 * c + 2],
         i[5 * c + 2], r[5 * c + 3], i[5 * c + 3], r[5 * c + 4],
         i[5 * c + 4], c1, s1, c2, s2);
}

// sample j of a signal of t_len samples under numpy-style reflect padding
// (edge not repeated); 0 where one reflection does not land in the signal
__device__ __forceinline__ float reflected(const float* __restrict__ sig,
                                           int j, int t_len) {
  if (j < 0) j = -j;
  if (j >= t_len) j = 2 * (t_len - 1) - j;
  return (j >= 0 && j < t_len) ? sig[j] : 0.f;
}

__global__ void __launch_bounds__(FNT, 4)
mel_fft_kernel(const float* __restrict__ audio, long long row_stride,
               int t_len, int n_frames, int hop, int blocks_per_signal,
               const float4* __restrict__ tables,
               const __grid_constant__ Roots roots, int n_mels, int vec_ok,
               float* __restrict__ out) {
  __shared__ __align__(16) float tab[T_WORDS];
  __shared__ __align__(16) float work[PAIRS][2 * NFFT];
  extern __shared__ __align__(16) float span[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / blocks_per_signal;
  const int t0 = (blockIdx.x - b * blocks_per_signal) * FBF;

  constexpr int TAB_ITERS = (T_WORDS / 4 + FNT - 1) / FNT;
#pragma unroll
  for (int k = 0; k < TAB_ITERS; ++k) {
    const int idx = tid + k * FNT;
    if (idx < T_WORDS / 4) reinterpret_cast<float4*>(tab)[idx] = tables[idx];
  }

  // span[off + s] is padded sample t0 * hop + s of signal b, i.e. signal
  // sample s0 + s; off makes 4-word groups of span 16-byte groups of audio
  const float* sig = audio + (size_t)b * row_stride;
  const int s0 = t0 * hop - NFFT / 2;
  const int off = (int)((((long long)b * row_stride + s0) % 4 + 4) % 4);
  const int groups = (off + (FBF - 1) * hop + NFFT + 3) / 4;
  for (int q = tid; q < groups; q += FNT) {
    const int j0 = s0 - off + 4 * q;
    float4 v;
    if (vec_ok && j0 >= 0 && j0 + 3 < t_len) {
      v = *reinterpret_cast<const float4*>(sig + j0);
    } else {
      v.x = reflected(sig, j0, t_len);
      v.y = reflected(sig, j0 + 1, t_len);
      v.z = reflected(sig, j0 + 2, t_len);
      v.w = reflected(sig, j0 + 3, t_len);
    }
    reinterpret_cast<float4*>(span)[q] = v;
  }
  __syncthreads();

  const int ta = t0 + 2 * warp;
  if (ta >= n_frames) return;
  const bool has_b = ta + 1 < n_frames;
  const float* fa = span + off + 2 * warp * hop;
  const float* fb = fa + hop;
  float* zr = work[warp];
  float* zi = zr + NFFT;

  // 1. windowed pair -> 16-point DFTs over n1, twiddle, Y[k1][n2]
  if (lane < N2) {
    float xr[N1], xi[N1];
#pragma unroll
    for (int n1 = 0; n1 < N1; ++n1) {
      const int n = N2 * n1 + lane;
      const float w = tab[T_WIN + n];
      xr[n1] = w * fa[n];
      xi[n1] = has_b ? w * fb[n] : 0.f;
    }
    dft16(xr, xi, roots);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int at = (c + 4 * d) * N2 + lane;
        float yr = xr[4 * c + d], yi = xi[4 * c + d];
        cmul(yr, yi, tab[T_TWR + at], tab[T_TWI + at]);
        zr[at] = yr;
        zi[at] = yi;
      }
  }
  __syncwarp();

  // 2. 25-point DFTs over n2 -> Z[k1 + 16 k2], in place
  {
    float yr[N2], yi[N2];
    if (lane < N1) {
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) {
        yr[n2] = zr[lane * N2 + n2];
        yi[n2] = zi[lane * N2 + n2];
      }
    }
    __syncwarp();
    if (lane < N1) {
      dft25(yr, yi, roots);
#pragma unroll
      for (int c = 0; c < 5; ++c)
#pragma unroll
        for (int d = 0; d < 5; ++d) {
          zr[lane + N1 * (c + 5 * d)] = yr[5 * c + d];
          zi[lane + N1 * (c + 5 * d)] = yi[5 * c + d];
        }
    }
  }
  __syncwarp();

  // 3. separate the two frames; |X_a|^2 -> zr[k], |X_b|^2 -> zi[k]. Bin k
  // and its mirror are read and written by this lane only.
#pragma unroll
  for (int j = 0; j < (NFFT / 2 + 32) / 32; ++j) {
    const int k = lane + 32 * j;
    if (k <= NFFT / 2) {
      const int km = k == 0 ? 0 : NFFT - k;
      const float ar = zr[k], ai = zi[k], br = zr[km], bi = zi[km];
      const float pr = ar + br, pi = ai - bi, qr = ai + bi, qi = ar - br;
      zr[k] = 0.25f * (pr * pr + pi * pi);
      zi[k] = 0.25f * (qr * qr + qi * qi);
    }
  }
  __syncwarp();

  // 4. banded filterbank, log
  const int* start = reinterpret_cast<const int*>(tab + T_START);
  const int* count = reinterpret_cast<const int*>(tab + T_COUNT);
  const int* offset = reinterpret_cast<const int*>(tab + T_OFFSET);
  float* oa = out + ((size_t)b * n_frames + ta) * n_mels;
  for (int m = lane; m < n_mels; m += 32) {
    const int s = start[m], n = count[m];
    const float* taps = tab + T_TAPS + offset[m];
    float ma = 0.f, mb = 0.f;
    for (int i = 0; i < n; ++i) {
      ma = fmaf(zr[s + i], taps[i], ma);
      mb = fmaf(zi[s + i], taps[i], mb);
    }
    oa[m] = log10f(fmaxf(ma, 1e-10f));
    if (has_b) oa[n_mels + m] = log10f(fmaxf(mb, 1e-10f));
  }
}

// -------------------------------------------------------------- dense route

constexpr int BF = 32;         // frames per block
constexpr int FT = 16;         // frequencies per tile
constexpr int NT = 256;        // threads per block
constexpr int MPT = BF * MAX_MELS / NT;   // mel outputs per thread (max)

__global__ void __launch_bounds__(NT)
mel_dense_kernel(const float* __restrict__ audio, int n_frames, int lp,
                 int hop, int n_fft, const float* __restrict__ cosb,
                 const float* __restrict__ sinb, int n_freqs,
                 const float* __restrict__ fbt, int n_mels, int n_rows,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* fr = smem;                    // [BF][n_fft]
  float* cs = fr + BF * n_fft;         // [n_fft][FT]
  float* sn = cs + n_fft * FT;         // [n_fft][FT]
  float* pw = sn + n_fft * FT;         // [BF][FT + 1]
  float* fb = pw + BF * (FT + 1);      // [FT][n_mels]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BF;

  for (int idx = tid; idx < BF * n_fft; idx += NT) {
    const int r = idx / n_fft, n = idx - r * n_fft;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < n_rows) {
      const int b = gr / n_frames, t = gr - b * n_frames;
      v = audio[(size_t)b * lp + (size_t)t * hop + n];
    }
    fr[idx] = v;
  }

  float acc[MPT];
#pragma unroll
  for (int k = 0; k < MPT; ++k) acc[k] = 0.f;

  const int n_out = BF * n_mels;
  const int fj = tid % FT;       // frequency within the tile
  const int ff = tid / FT;       // frames ff and ff + NT / FT
  constexpr int FSTEP = NT / FT;

  for (int f0 = 0; f0 < n_freqs; f0 += FT) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < n_fft * FT; idx += NT) {
      const int n = idx / FT, j = idx - n * FT;
      const int f = f0 + j;
      const bool ok = f < n_freqs;
      cs[idx] = ok ? cosb[(size_t)n * n_freqs + f] : 0.f;
      sn[idx] = ok ? sinb[(size_t)n * n_freqs + f] : 0.f;
    }
    for (int idx = tid; idx < FT * n_mels; idx += NT) {
      const int j = idx / n_mels, m = idx - j * n_mels;
      const int f = f0 + j;
      fb[idx] = f < n_freqs ? fbt[(size_t)f * n_mels + m] : 0.f;
    }
    __syncthreads();

    float re0 = 0.f, im0 = 0.f, re1 = 0.f, im1 = 0.f;
    const float* a0 = fr + ff * n_fft;
    const float* a1 = fr + (ff + FSTEP) * n_fft;
    for (int n = 0; n < n_fft; ++n) {
      const float c = cs[n * FT + fj], s = sn[n * FT + fj];
      const float x0 = a0[n], x1 = a1[n];
      re0 = fmaf(x0, c, re0);
      im0 = fmaf(x0, s, im0);
      re1 = fmaf(x1, c, re1);
      im1 = fmaf(x1, s, im1);
    }
    pw[ff * (FT + 1) + fj] = re0 * re0 + im0 * im0;
    pw[(ff + FSTEP) * (FT + 1) + fj] = re1 * re1 + im1 * im1;
    __syncthreads();

#pragma unroll
    for (int k = 0; k < MPT; ++k) {
      const int o = tid + k * NT;
      if (o < n_out) {
        const int r = o / n_mels, m = o - r * n_mels;
        float s = acc[k];
#pragma unroll
        for (int j = 0; j < FT; ++j)
          s = fmaf(pw[r * (FT + 1) + j], fb[j * n_mels + m], s);
        acc[k] = s;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < MPT; ++k) {
    const int o = tid + k * NT;
    if (o < n_out) {
      const int r = o / n_mels, m = o - r * n_mels;
      const int gr = row0 + r;
      if (gr < n_rows)
        out[(size_t)gr * n_mels + m] = log10f(fmaxf(acc[k], 1e-10f));
    }
  }
}

constexpr int SMEM_LIMIT = 232448;   // bytes a block can use on the H100

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// audio: [n_signals] rows of t_len fp32 samples, row_stride samples apart,
// not padded; out: [n_signals * n_frames, n_mels]. Frame t of a signal
// starts at padded sample t * hop. tables: T_WORDS device words; roots:
// sizeof(Roots) host bytes.
int mel_log10_fft(const void* audio, int n_signals, long long row_stride,
                  int t_len, int n_frames, int hop, const void* tables,
                  const void* roots, int n_mels, void* out, void* stream) {
  if (n_mels < 1 || n_mels > MAX_MELS || n_frames < 1 || n_signals < 1 ||
      hop < 1 || t_len <= NFFT / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  static int max_dynamic = -1;   // set once: the kernel's dynamic smem cap
  if (max_dynamic < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, mel_fft_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int cap = SMEM_LIMIT - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(
        mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_dynamic = cap;
  }
  const long long span_words = (long long)(FBF - 1) * hop + NFFT + 6;
  if (4 * span_words > max_dynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  Roots w;
  std::memcpy(&w, roots, sizeof(Roots));
  const int blocks_per_signal = (n_frames + FBF - 1) / FBF;
  const int vec_ok =
      reinterpret_cast<uintptr_t>(audio) % 16 == 0 ? 1 : 0;
  const dim3 grid((unsigned)(n_signals * blocks_per_signal));
  mel_fft_kernel<<<grid, FNT, (size_t)(4 * span_words),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), row_stride, t_len, n_frames, hop,
      blocks_per_signal, static_cast<const float4*>(tables), w, n_mels,
      vec_ok, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// audio: [n_signals, lp] reflect-padded fp32; out: [n_signals * n_frames,
// n_mels]. Frame t of a signal starts at t * hop; n_frames excludes the
// final (dropped) frame.
int mel_log10_dense(const void* audio, int n_signals, int lp, int n_frames,
                    int hop, int n_fft, const void* cosb, const void* sinb,
                    int n_freqs, const void* fbt, int n_mels, void* out,
                    void* stream) {
  if (n_mels < 1 || n_mels > MAX_MELS || n_fft < 1 || n_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = n_signals * n_frames;
  const size_t smem = sizeof(float) *
      ((size_t)BF * n_fft + 2 * (size_t)n_fft * FT + BF * (FT + 1) +
       (size_t)FT * n_mels);
  if (smem > (size_t)SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 48 * 1024;   // raised only when a call needs more
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        mel_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const dim3 grid((n_rows + BF - 1) / BF);
  mel_dense_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), n_frames, lp, hop, n_fft,
      static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      n_freqs, static_cast<const float*>(fbt), n_mels, n_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
