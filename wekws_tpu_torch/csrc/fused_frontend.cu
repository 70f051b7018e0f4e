// Fused fbank / MFCC frontend for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel wekws_tpu/ops/fused_frontend.py
// `_fbank_kernel` (via `fused_fbank`).
//
// Per frame (frame_length samples of the wave at stride frame_shift):
//   f    = frame + dither * N(0, 1)              (optional, per sample)
//   re   = f @ A[:, :nbin],  im = f @ A[:, nbin:]
//          (A folds DC removal, preemphasis, window and the real DFT)
//   p    = re^2 + im^2        (sqrt of it when use_power is false)
//   mel  = p @ mel_t          (nbin -> M)
//   mel  = log(max(mel, eps)) (when use_log)
//   out  = mel @ dct          (M -> C, MFCC only; lifter folded in)
//
// Bound on an H100 at the training shape (512 waves of 32,000 samples ->
// 101,376 frames of 400, nbin 257, M 40): 2 x 101,376 x (400 x 514 + 257
// x 40) = 43.8 GFLOP, 0.65 ms at 67 TFLOP/s fp32, against 65.5 MB of wave
// read and 16.2 MB written (0.024 ms at 3.35 TB/s): bound by operations.
//
// Design.  The TPU kernel takes frames already cut by XLA; here a block
// reads its 32 overlapping frames straight from the (B, S) wave, so the
// (B, T, frame_length) frames buffer, the noise, the spectrum and the
// power never exist in device memory: that is what the kernel is for.
// The three operators (863 KB at these sizes) do not fit in shared
// memory: they stay in device memory (L2-resident) and each thread reads
// its own column, consecutive threads consecutive bins.  Shared memory
// holds the 32 x frame_length frame tile, the 32 x nbin power tile and
// the 32 x M log-mel tile (about 94 KB: two blocks per SM).
//   DFT: thread b of 256 owns bin b for all 32 rows (64 accumulators),
//   reading the frame tile as float4 broadcasts: 256 FMAs per 8 operator
//   loads.  Bins past the last multiple of 256 (one, the Nyquist bin, at
//   nbin 257) are split over depth instead: 8 lanes per row, a shuffle
//   reduction.
//   Mel, log and DCT run from the shared tiles, one output per thread at
//   a time.  Rows are independent: no sum crosses blocks.
// Plain fp32 FMAs give at least the relative error (about 1e-5) the TPU
// kernel reaches with its three-pass bf16 split, so no split is needed.
// Dither: Philox4x32-10 keyed by the caller's seed (read from a
// one-element device tensor, so the host never waits for it), counter =
// the global quad index of (row, sample), Box-Muller.  The noise of a
// sample depends only on the seed and on its (utterance, frame, sample)
// position in the call, not on the grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;          // frames per block
constexpr int kSplit = kThreads / kRows;  // lanes per row for tail bins
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const unsigned hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Two N(0, 1) samples from two 32-bit words (Box-Muller, 24-bit uniforms,
// u1 in (0, 1] so the log is finite).
__device__ __forceinline__ float2 box_muller(unsigned a, unsigned b) {
  const float u1 = (static_cast<float>(a >> 8) + 1.0f) * (1.0f / 16777216.0f);
  const float u2 = static_cast<float>(b >> 8) * (1.0f / 16777216.0f);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * u2, &s, &c);
  return make_float2(r * c, r * s);
}

__global__ void __launch_bounds__(kThreads, 2)
fused_fbank_kernel(const float* __restrict__ waves,
                   const float* __restrict__ A,
                   const float* __restrict__ mel_t,
                   const float* __restrict__ dct,
                   const long long* __restrict__ seed,
                   float* __restrict__ out, int S, int T, long long rows,
                   int FL, int shift, int nbin, int M, int D, float dither,
                   int use_power, int use_log, float eps) {
  extern __shared__ float4 smem4[];
  const int flp = round4(FL);
  float* frames = reinterpret_cast<float*>(smem4);  // (kRows, flp)
  float* power = frames + kRows * flp;               // (kRows, nbin)
  float* melbuf = power + round4(kRows * nbin);      // (kRows, M)

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int live = static_cast<int>(
      rows - row0 < kRows ? rows - row0 : static_cast<long long>(kRows));
  const int W = 2 * nbin;  // row stride of A: [re | im]

  // the block's frames, cut from the wave; dead rows and the pad are 0
  for (int i = tid; i < kRows * flp; i += kThreads) {
    const int r = i / flp;
    const int k = i - r * flp;
    float v = 0.f;
    if (r < live && k < FL) {
      const long long row = row0 + r;
      const long long b = row / T;
      const int t = static_cast<int>(row - b * T);
      v = waves[b * S + static_cast<long long>(t) * shift + k];
    }
    frames[i] = v;
  }
  __syncthreads();

  if (dither > 0.f) {
    const uint2 key = make_uint2(static_cast<unsigned>(seed[0]),
                                 static_cast<unsigned>(seed[0] >> 32));
    const int n = live * FL;
    // row0 is a multiple of 32, so the tile starts on a quad of the
    // global (row, sample) index
    const unsigned long long q0 =
        static_cast<unsigned long long>(row0) * FL / 4;
    for (int q = tid; 4 * q < n; q += kThreads) {
      const unsigned long long gq = q0 + q;
      const uint4 bits = philox4x32_10(
          make_uint4(static_cast<unsigned>(gq),
                     static_cast<unsigned>(gq >> 32), 0u, 0u), key);
      const float2 n01 = box_muller(bits.x, bits.y);
      const float2 n23 = box_muller(bits.z, bits.w);
      const float noise[4] = {n01.x, n01.y, n23.x, n23.y};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * q + u;
        if (e < n) {
          const int r = e / FL;
          frames[r * flp + (e - r * FL)] += dither * noise[u];
        }
      }
    }
    __syncthreads();
  }

  // DFT and power: full chunks of 256 bins, one bin per thread
  const int fl4 = FL & ~3;
  const int full = nbin / kThreads * kThreads;
  for (int b0 = 0; b0 < full; b0 += kThreads) {
    const float* a_re = A + b0 + tid;
    const float* a_im = a_re + nbin;
    float re[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) re[r] = im[r] = 0.f;
    for (int k = 0; k < fl4; k += 4) {
      const float r0 = a_re[static_cast<size_t>(k) * W];
      const float r1 = a_re[static_cast<size_t>(k + 1) * W];
      const float r2 = a_re[static_cast<size_t>(k + 2) * W];
      const float r3 = a_re[static_cast<size_t>(k + 3) * W];
      const float i0 = a_im[static_cast<size_t>(k) * W];
      const float i1 = a_im[static_cast<size_t>(k + 1) * W];
      const float i2 = a_im[static_cast<size_t>(k + 2) * W];
      const float i3 = a_im[static_cast<size_t>(k + 3) * W];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 f =
            *reinterpret_cast<const float4*>(&frames[r * flp + k]);
        re[r] = fmaf(f.x, r0, re[r]);
        re[r] = fmaf(f.y, r1, re[r]);
        re[r] = fmaf(f.z, r2, re[r]);
        re[r] = fmaf(f.w, r3, re[r]);
        im[r] = fmaf(f.x, i0, im[r]);
        im[r] = fmaf(f.y, i1, im[r]);
        im[r] = fmaf(f.z, i2, im[r]);
        im[r] = fmaf(f.w, i3, im[r]);
      }
    }
    for (int k = fl4; k < FL; ++k) {
      const float rr = a_re[static_cast<size_t>(k) * W];
      const float ii = a_im[static_cast<size_t>(k) * W];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float f = frames[r * flp + k];
        re[r] = fmaf(f, rr, re[r]);
        im[r] = fmaf(f, ii, im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float p = re[r] * re[r] + im[r] * im[r];
      if (!use_power) p = sqrtf(p);
      power[r * nbin + b0 + tid] = p;
    }
  }
  // the remaining bins, split over depth: kSplit lanes per row
  {
    const int r = tid / kSplit;
    const int part = tid % kSplit;
    for (int bin = full; bin < nbin; ++bin) {
      float re = 0.f, im = 0.f;
      for (int k = part; k < FL; k += kSplit) {
        const float f = frames[r * flp + k];
        re = fmaf(f, A[static_cast<size_t>(k) * W + bin], re);
        im = fmaf(f, A[static_cast<size_t>(k) * W + nbin + bin], im);
      }
#pragma unroll
      for (int off = kSplit / 2; off > 0; off >>= 1) {
        re += __shfl_xor_sync(0xffffffffu, re, off);
        im += __shfl_xor_sync(0xffffffffu, im, off);
      }
      if (part == 0) {
        float p = re * re + im * im;
        if (!use_power) p = sqrtf(p);
        power[r * nbin + bin] = p;
      }
    }
  }
  __syncthreads();

  // mel (+ log); rows past `live` are computed on zeros and not stored
  const bool has_dct = dct != nullptr;
  for (int i = tid; i < kRows * M; i += kThreads) {
    const int r = i / M;
    const int m = i - r * M;
    const float* p = power + r * nbin;
    float acc = 0.f;
    for (int b = 0; b < nbin; ++b) {
      acc = fmaf(p[b], mel_t[static_cast<size_t>(b) * M + m], acc);
    }
    if (use_log) acc = logf(fmaxf(acc, eps));
    if (has_dct) {
      melbuf[i] = acc;
    } else if (r < live) {
      out[(row0 + r) * D + m] = acc;
    }
  }
  if (has_dct) {
    __syncthreads();
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      if (r >= live) continue;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) {
        acc = fmaf(melbuf[r * M + m], dct[static_cast<size_t>(m) * D + c],
                   acc);
      }
      out[(row0 + r) * D + c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success).  waves (B, S); A
// (FL, 2 * nbin); mel_t (nbin, M); dct (M, D) or null (then D == M);
// seed: one int64 on the device, read only when dither > 0; out
// (B, T, D) with T = 1 + (S - FL) / shift.
int fused_fbank_launch(const void* waves, const void* A, const void* mel_t,
                       const void* dct, const void* seed, void* out, int B,
                       int S, int T, int FL, int shift, int nbin, int M, int D,
                       float dither, int use_power, int use_log, float eps,
                       void* stream) {
  static_assert(kRows * kSplit == kThreads && (kSplit & (kSplit - 1)) == 0 &&
                    kSplit <= 32,
                "tail bins: a power-of-two lane group per row inside a warp");
  if (B < 1 || T < 1 || FL < 1 || shift < 1 || nbin < 1 || M < 1 || D < 1 ||
      S < FL + (T - 1) * shift || (dct == nullptr && D != M) ||
      (dither > 0.f && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (static_cast<size_t>(kRows) * round4(FL) +
                                       round4(kRows * nbin) +
                                       static_cast<size_t>(kRows) * M);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * T;
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  fused_fbank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(waves), static_cast<const float*>(A),
      static_cast<const float*>(mel_t), static_cast<const float*>(dct),
      static_cast<const long long*>(seed), static_cast<float*>(out), S, T,
      rows, FL, shift, nbin, M, D, dither, use_power, use_log, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_fbank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
