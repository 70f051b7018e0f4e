// Fused fbank / MFCC frontend for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel wekws_tpu/ops/fused_frontend.py
// `_fbank_kernel` (via `fused_fbank`).
//
// Per frame (frame_length FL samples of the wave at stride frame_shift):
//   f    = frame + dither * N(0, 1)              (optional, per sample)
//   X    = rfft(window * preemph(f - mean(f)), n_fft)
//   p    = |X|^2          (|X| when use_power is false), nbin = n_fft/2 + 1
//   mel  = p @ mel_t      (nbin -> M)
//   mel  = log(max(mel, eps)) (when use_log)
//   out  = mel @ dct      (M -> C, MFCC only; lifter folded in)
//
// Two plans of one function, chosen by the wrapper from n_fft before the
// launch (ops/fused_frontend.py `fbank_plan`):
//
// FFT plan (`fused_fbank_kernel<LOG2N>`, n_fft a power of two from 128
// to 2048: every shipped recipe; 25 ms at 16 kHz pads to 512).
//   Bound on an H100 at the training shape (512 waves of 32,000 samples
//   -> 101,376 frames of 400, n_fft 512, M 40): per frame about 1,600
//   flops of pre-chain, 2.5 n log2 n = 11,520 of real FFT, 771 of power,
//   1,000 of mel over the filters' nonzero bins, 40 logs: 1.5 GFLOP,
//   0.023 ms at 67 TFLOP/s fp32, against 65.5 MB of wave read and 16.2 MB
//   written (0.024 ms at 3.35 TB/s): bound by bytes, about evenly.  The
//   16 low bins below (25,600 flops a frame more) are this design's cost,
//   not the function's, and stay out of the bound.
//   Design: F frames a block (F = 16384 / n_fft: 32 at 512, two blocks an
//   SM), cut from the (B, S) wave into shared memory; the dither (below);
//   then in shared memory, one warp a frame: DC removal (the frame's
//   mean, a warp reduction), Kaldi preemphasis x[i] -= c x[i-1],
//   x[0] -= c x[0], the window, zero padding to n_fft.  The real FFT of
//   n_fft points is a complex FFT of N = n_fft / 2 points over the
//   packed pairs z[n] = x[2n] + i x[2n+1] (Stockham, in place, radix-16
//   stages then one of radix N / 16^s; each thread holds 16 points in
//   registers a stage, G = N / 16 threads a frame, a warp or block
//   barrier between stages), then the split pass
//     X[k]   = E + W^k O,  X[N-k] = conj(E - W^k O),
//     E = (Z[k] + conj Z[N-k]) / 2,  O = (Z[k] - conj Z[N-k]) / 2i,
//   which writes the power over the frame's own spectrum.  The lowest
//   16 bins come instead from the folded operator's columns (`low`, the
//   wrapper's copy of them), a dot product of the raw frame with each,
//   as the dense plan does: the
//   preemphasis leaves a quiet band near DC whose narrow filters (80
//   bins) a float32 FFT rounds relative to the frame's loudest bin, a few
//   times 1e-3 of a log-mel on a loud 500 Hz tone in noise, where the
//   folded operator agrees with the three-matmul extractor to 1e-5
//   (16 x 2 x 400 multiply-adds a frame more).  Twiddles
//   W^m = exp(-2 pi i m / n_fft) come from a table the wrapper built in
//   float64.  Complex index i sits at i + i / 16 (one pad every 16) so
//   the first stage's stride-16 stores do not hit one bank.  Mel runs
//   over each filter's nonzero bins only (`bands`: [lo, hi) and the
//   offset of its weights, packed into shared memory from mel_t at the
//   start; the wrapper computes the ranges once from mel_t).
// Dense plan (`fused_fbank_dense_kernel`, any other padded size, e.g.
//   `round_to_power_of_two: false`): the folded analysis operator A
//   (FL, 2 nbin) = DC removal, preemphasis, window and the real DFT in
//   one matrix, as the TPU kernel runs it: 2 x 101,376 x 400 x 514 MACs
//   = 43.8 GFLOP at the training shape.  Thread b of 256 owns bin b for
//   32 rows (64 accumulators), reading the frame tile as float4
//   broadcasts and its column of A from L2; the bins past the last
//   multiple of 256 are split over depth (8 lanes a row, a shuffle
//   reduction).
// In both plans rows are independent: no sum crosses blocks.
// Dither: Philox4x32-10 keyed by the caller's seed (read from a
// one-element device tensor, so the host never waits for it), counter =
// the global quad index of (row, sample), Box-Muller; one function
// (`add_dither`) for both plans, so a seed gives bitwise the same noise
// in each.  The noise of a sample depends only on the seed and on its
// (utterance, frame, sample) position in the call, not on the grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;
// dense plan
constexpr int kRows = 32;          // frames per block
constexpr int kSplit = kThreads / kRows;  // lanes per row for tail bins
// FFT plan: frames a block times n_fft (so F x n_fft floats of frames)
constexpr int kFftFloats = 16384;
__host__ __device__ constexpr int fft_frames(int log2n) {
  return kFftFloats >> log2n;
}
constexpr int kMinLog2 = 7, kMaxLog2 = 11;  // n_fft 128 .. 2048
// bins below this take the folded operator's columns, not the FFT
constexpr int kLowBins = 16;

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

// Adds dither * N(0, 1) to the first `live` frames of a block whose first
// row is row0 (a multiple of 4); sample k of frame r sits at
// frames[at(r, k)].  Element e = (row0 + r) FL + k takes word e % 4 of
// Philox at counter e / 4.
template <typename At>
__device__ __forceinline__ void add_dither(float* frames, At at,
                                           const long long* seed,
                                           long long row0, int live, int FL,
                                           float dither) {
  const uint2 key = make_uint2(static_cast<unsigned>(seed[0]),
                               static_cast<unsigned>(seed[0] >> 32));
  const int n = live * FL;
  // row0 is a multiple of 4, so the tile starts on a quad of the global
  // (row, sample) index
  const unsigned long long q0 = static_cast<unsigned long long>(row0) * FL / 4;
  for (int q = threadIdx.x; 4 * q < n; q += kThreads) {
    const unsigned long long gq = q0 + q;
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<unsigned>(gq), static_cast<unsigned>(gq >> 32),
                   0u, 0u), key);
    const float2 n01 = box_muller(bits.x, bits.y);
    const float2 n23 = box_muller(bits.z, bits.w);
    const float noise[4] = {n01.x, n01.y, n23.x, n23.y};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * q + u;
      if (e < n) {
        const int r = e / FL;
        frames[at(r, e - r * FL)] += dither * noise[u];
      }
    }
  }
}

// the frame of flattened row `row` starts at this sample of the wave
__device__ __forceinline__ long long frame_start(long long row, int S, int T,
                                                 int shift) {
  const long long b = row / T;
  const int t = static_cast<int>(row - b * T);
  return b * S + static_cast<long long>(t) * shift;
}

// ---------------------------------------------------------------------------
// Dense plan: the folded analysis operator
// ---------------------------------------------------------------------------

struct DenseAt {
  int flp;
  __device__ int operator()(int r, int k) const { return r * flp + k; }
};

__global__ void __launch_bounds__(kThreads, 2)
fused_fbank_dense_kernel(const float* __restrict__ waves,
                         const float* __restrict__ A,
                         const float* __restrict__ mel_t,
                         const float* __restrict__ dct,
                         const long long* __restrict__ seed,
                         float* __restrict__ out, int S, int T, long long rows,
                         int FL, int shift, int nbin, int M, int D,
                         float dither, int use_power, int use_log, float eps) {
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
      v = waves[frame_start(row0 + r, S, T, shift) + k];
    }
    frames[i] = v;
  }
  __syncthreads();

  if (dither > 0.f) {
    add_dither(frames, DenseAt{flp}, seed, row0, live, FL, dither);
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

// ---------------------------------------------------------------------------
// FFT plan
// ---------------------------------------------------------------------------

// 4, 8 or 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// complex index i of a frame's spectrum sits at i + i / 16
__host__ __device__ constexpr int zpad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// DFTs of 2, 4, 8 and 16 points in registers, natural order in and out,
// written out so that every index and twiddle is a constant: the points
// stay in registers, none in local memory
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// -i z
__device__ __forceinline__ float2 cmi(float2 z) { return make_float2(z.y, -z.x); }

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = cmi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

constexpr float kC1 = 0.92387953251128674f;  // cos(pi / 8)
constexpr float kS1 = 0.38268343236508977f;  // sin(pi / 8)
constexpr float kH = 0.70710678118654752f;   // sqrt(1/2)

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  dft4(v[0], v[1], v[2], v[3]);
}

// 8 = 4 x 2: X[k + 4 j] = Y0[k] +- W8^k Y1[k], Y_m = DFT4 of a[2 n + m]
template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = cmul(o1, make_float2(kH, -kH));
  o2 = cmi(o2);
  o3 = cmul(o3, make_float2(-kH, -kH));
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// 16 = 4 x 4: Y_m = DFT4 of a[4 n + m], Y_m[k] *= W16^(m k), then
// X[k + 4 j] = DFT4 over m of Y_m[k]
template <>
__device__ __forceinline__ void dft<16>(float2 (&v)[16]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) dft4(v[m], v[4 + m], v[8 + m], v[12 + m]);
  // v[4 k + m] now holds Y_m[k]
  v[5] = cmul(v[5], make_float2(kC1, -kS1));    // m 1, k 1: W^1
  v[9] = cmul(v[9], make_float2(kH, -kH));      // m 1, k 2: W^2
  v[13] = cmul(v[13], make_float2(kS1, -kC1));  // m 1, k 3: W^3
  v[6] = cmul(v[6], make_float2(kH, -kH));      // m 2, k 1: W^2
  v[10] = cmi(v[10]);                           // m 2, k 2: W^4
  v[14] = cmul(v[14], make_float2(-kH, -kH));   // m 2, k 3: W^6
  v[7] = cmul(v[7], make_float2(kS1, -kC1));    // m 3, k 1: W^3
  v[11] = cmul(v[11], make_float2(-kH, -kH));   // m 3, k 2: W^6
  v[15] = cmul(v[15], make_float2(-kC1, kS1));  // m 3, k 3: W^9
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dft4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
  // v[4 k + j] now holds X[k + 4 j]: transpose the 4 x 4
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = k + 1; j < 4; ++j) {
      const float2 t = v[4 * k + j];
      v[4 * k + j] = v[4 * j + k];
      v[4 * j + k] = t;
    }
  }
}

// the threads of a frame's group meet: a warp holds whole groups up to
// 32 threads; a larger group (n_fft 2048) is two warps, and every thread
// of the block runs the same stages, so a block barrier serves
template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One Stockham stage of radix RS over N points in place: sub-transforms
// of NS points done so far; thread t of the group does 16 / RS of the N /
// RS butterflies.  Every read lands in registers before any write.
// tw[m] = W_{2N}^m.
template <int N, int RS, int NS, int G>
__device__ __forceinline__ void fft_stage(float2* z, const float2* tw, int t) {
  constexpr int kItems = 16 / RS;
  float2 v[kItems][RS];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + G * i;
#pragma unroll
    for (int r = 0; r < RS; ++r) v[i][r] = z[zpad(j + r * (N / RS))];
  }
  group_sync<G>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + G * i;
    const int k = j % NS;
    if constexpr (NS > 1) {
      const int step = 2 * k * (N / (NS * RS));
#pragma unroll
      for (int r = 1; r < RS; ++r) v[i][r] = cmul(v[i][r], tw[r * step]);
    }
    dft<RS>(v[i]);
    const int base = (j / NS) * NS * RS + k;
#pragma unroll
    for (int r = 0; r < RS; ++r) z[zpad(base + r * NS)] = v[i][r];
  }
  group_sync<G>();
}

// radix-16 stages while 16 points or more remain, then the rest
template <int N, int NS, int G>
__device__ __forceinline__ void fft_stages(float2* z, const float2* tw,
                                           int t) {
  if constexpr (NS < N) {
    constexpr int RS = N / NS >= 16 ? 16 : N / NS;
    fft_stage<N, RS, NS, G>(z, tw, t);
    fft_stages<N, NS * RS, G>(z, tw, t);
  }
}

// floats a frame of the FFT plan takes: N + N / 16 complex points (one
// pad every 16), and two floats more so that frame r + 1 starts two banks
// after frame r (the mel step reads one bin of 32 frames at once)
__host__ __device__ constexpr int frame_floats(int n_fft) {
  return 2 * zpad(n_fft / 2) + 2;
}

// floats of shared memory of the FFT plan: twiddles, frames, window, mel
// band weights, the bands, the log-mel tile, the low bins' power, two
// chunks of 32 rows of the low bins' operator
__host__ __device__ inline int fft_smem_floats(int n_fft, int F, int FL,
                                               int n_band, int M) {
  return 2 * n_fft + F * frame_floats(n_fft) + round4(FL) + round4(n_band) +
         round4(3 * M) + F * M + F * kLowBins + 2 * 32 * 2 * kLowBins;
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads, 2)
fused_fbank_kernel(const float* __restrict__ waves,
                   const float* __restrict__ window,
                   const float2* __restrict__ twiddles,
                   const float* __restrict__ low,
                   const float* __restrict__ mel_t,
                   const int* __restrict__ bands,
                   const float* __restrict__ dct,
                   const long long* __restrict__ seed,
                   float* __restrict__ out, int S, int T, long long rows,
                   int FL, int shift, int M, int D, int n_band, float dither,
                   float preemph, int remove_dc, int use_power, int use_log,
                   float eps, int pairs) {
  constexpr int NFFT = 1 << LOG2N;
  constexpr int F = fft_frames(LOG2N);  // frames a block
  constexpr int N = NFFT / 2;          // complex points
  constexpr int G = N / 16;            // threads a frame
  constexpr int FS = frame_floats(NFFT);
  constexpr int kBatch = kThreads / G;  // frames in flight
  static_assert(F % kBatch == 0 && F % 4 == 0, "whole rounds of frames");
  static_assert(N % 16 == 0 && (N / 2) % G == 0, "16 points a thread");
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);            // (NFFT,)
  float* frames = reinterpret_cast<float*>(tw + NFFT);      // (F, FS)
  float* win = frames + F * FS;                             // (FL,)
  float* melw = win + round4(FL);                           // (n_band,)
  int* bnd = reinterpret_cast<int*>(melw + round4(n_band));  // (M, 3)
  float* melbuf = reinterpret_cast<float*>(bnd + round4(3 * M));  // (F, M)
  float* lowp = melbuf + F * M;                        // (F, kLowBins)
  float* lowbuf = lowp + F * kLowBins;  // (2, 32, 2 kLowBins) rows of low

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * F;
  const int live = static_cast<int>(
      rows - row0 < F ? rows - row0 : static_cast<long long>(F));

  // everything from device memory by cp.async, all in flight at once:
  // the block's frames first (dead rows and the pad are zero; sample
  // pairs as 8-byte copies where every frame starts on an even sample),
  // then twiddles, window, bands and the filters' weights
  auto at = [=](int r, int k) { return r * FS + 2 * zpad(k >> 1) + (k & 1); };
  {
    long long b = row0 / T;  // the frame of row row0 + r: (b, t)
    int t = static_cast<int>(row0 - b * T);
    for (int r = 0; r < F; ++r) {
      const float* src = waves + b * S + static_cast<long long>(t) * shift;
      float2* fr = reinterpret_cast<float2*>(frames + r * FS);
      for (int i = tid; i < N; i += kThreads) {
        const int k = 2 * i;
        float2* dst = fr + zpad(i);
        if (r >= live || k >= FL) {
          *dst = make_float2(0.f, 0.f);
        } else if (k + 1 == FL) {  // an odd frame's last sample
          dst->y = 0.f;
          cp_async4(&dst->x, src + k);
        } else if (pairs) {
          cp_async8(dst, reinterpret_cast<const float2*>(src + k));
        } else {
          cp_async4(&dst->x, src + k);
          cp_async4(&dst->y, src + k + 1);
        }
      }
      if (++t == T) {
        t = 0;
        ++b;
      }
    }
  }
  for (int i = tid; i < NFFT; i += kThreads) cp_async8(tw + i, twiddles + i);
  for (int i = tid; i < FL; i += kThreads) cp_async4(win + i, window + i);
  for (int i = tid; i < 3 * M; i += kThreads) cp_async4(bnd + i, bands + i);
  {
    // a warp's filters: their ranges read before any copy is issued
    constexpr int kWarps = kThreads / 32;
    for (int m0 = 0; m0 < M; m0 += 4 * kWarps) {
      int lo[4], hi[4], off[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + warp + u * kWarps;
        lo[u] = hi[u] = off[u] = 0;
        if (m < M) {
          lo[u] = bands[3 * m];
          hi[u] = bands[3 * m + 1];
          off[u] = bands[3 * m + 2];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + warp + u * kWarps;
        for (int b = lo[u] + lane; b < hi[u]; b += 32) {
          cp_async4(melw + off[u] + b - lo[u],
                    mel_t + static_cast<size_t>(b) * M + m);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (dither > 0.f) {
    add_dither(frames, at, seed, row0, live, FL, dither);
    __syncthreads();
  }

  // the lowest kLowBins bins by the folded operator, from the raw
  // (dithered) frames before the pre-chain rewrites them: lane l takes
  // frames l, l + 32, ..., warp w bins 2w and 2w + 1, each a dot product
  // in sample order (the three-matmul extractor's order: near DC the sum
  // cancels, and its rounding is the extractor's).  `low` holds the
  // operator's columns of those bins as [re, im] pairs, rows zero-padded
  // to a multiple of 32; 32 rows at a time are staged into shared memory
  // by `cp.async` (one 16-byte copy a thread, the next 32 while these
  // are used), and a warp reads its 16 bytes of a row, the same for all
  // its lanes
  {
    constexpr int FPL = F >= 32 ? F / 32 : 1;  // frames a lane
    constexpr int kRow = 2 * kLowBins;         // floats a row of `low`
    static_assert(2 * (kThreads / 32) == kLowBins, "two bins a warp");
    static_assert(32 * kRow == 4 * kThreads, "a chunk: a copy a thread");
    const int chunks = (FL + 31) / 32;
    float4 acc[FPL];
#pragma unroll
    for (int fi = 0; fi < FPL; ++fi) acc[fi] = make_float4(0.f, 0.f, 0.f, 0.f);
    cp_async16(reinterpret_cast<float4*>(lowbuf) + tid,
               reinterpret_cast<const float4*>(low) + tid);
    cp_async_commit();
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) {
        cp_async16(reinterpret_cast<float4*>(lowbuf + ((ch + 1) & 1) * 32 *
                                                          kRow) + tid,
                   reinterpret_cast<const float4*>(low + (ch + 1) * 32 * kRow) +
                       tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk ch has landed (every thread's copy)
      const float4* a4 =
          reinterpret_cast<const float4*>(lowbuf + (ch & 1) * 32 * kRow) + warp;
#pragma unroll
      for (int fi = 0; fi < FPL; ++fi) {
        const int r = lane + 32 * fi;
        if (r < F) {
          const float2* x2 = reinterpret_cast<const float2*>(
              frames + r * FS + 2 * zpad(16 * ch));
          float4 v = acc[fi];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 x = x2[j];
            const float4 a0 = a4[(2 * j) * (kRow / 4)];
            const float4 a1 = a4[(2 * j + 1) * (kRow / 4)];
            v.x = fmaf(x.y, a1.x, fmaf(x.x, a0.x, v.x));
            v.y = fmaf(x.y, a1.y, fmaf(x.x, a0.y, v.y));
            v.z = fmaf(x.y, a1.z, fmaf(x.x, a0.z, v.z));
            v.w = fmaf(x.y, a1.w, fmaf(x.x, a0.w, v.w));
          }
          acc[fi] = v;
        }
      }
      __syncthreads();  // every read of this chunk's buffer is done
    }
#pragma unroll
    for (int fi = 0; fi < FPL; ++fi) {
      const int r = lane + 32 * fi;
      if (r < F) {
        float p0 = acc[fi].x * acc[fi].x + acc[fi].y * acc[fi].y;
        float p1 = acc[fi].z * acc[fi].z + acc[fi].w * acc[fi].w;
        if (!use_power) {
          p0 = sqrtf(p0);
          p1 = sqrtf(p1);
        }
        lowp[r * kLowBins + 2 * warp] = p0;
        lowp[r * kLowBins + 2 * warp + 1] = p1;
      }
    }
  }
  __syncthreads();  // every read of the raw frames is done

  // pre-chain, one warp for FW frames at once: x - mean, preemphasis,
  // window; lane l takes samples l, l + 32, ...; the sample before a
  // chunk's first is the last chunk's lane 31, carried in a register, so
  // every chunk is read before it is written and no sample is read after
  // its write
  {
    constexpr int kWarps = kThreads / 32;
    constexpr int FW = F >= kWarps ? F / kWarps : 1;
    float mean[FW], carry[FW];
#pragma unroll
    for (int f = 0; f < FW; ++f) mean[f] = carry[f] = 0.f;
    if (remove_dc) {
      for (int k = lane; k < FL; k += 32) {
#pragma unroll
        for (int f = 0; f < FW; ++f) {
          const int r = warp + kWarps * f;
          if (r < F) mean[f] += frames[at(r, k)];
        }
      }
#pragma unroll
      for (int f = 0; f < FW; ++f) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mean[f] += __shfl_xor_sync(0xffffffffu, mean[f], off);
        }
        mean[f] /= static_cast<float>(FL);
      }
    }
    for (int c0 = 0; c0 < FL; c0 += 32) {
      const int k = c0 + lane;
      const float wk = k < FL ? win[k] : 0.f;
#pragma unroll
      for (int f = 0; f < FW; ++f) {
        const int r = warp + kWarps * f;
        const float v = k < FL && r < F ? frames[at(r, k)] : 0.f;
        float pv = __shfl_up_sync(0xffffffffu, v, 1);
        if (lane == 0) pv = c0 == 0 ? v : carry[f];  // x[0] -= c x[0]
        carry[f] = __shfl_sync(0xffffffffu, v, 31);
        if (k < FL && r < live) {
          // v - c pv rounded once, then the mean's share: the error stays
          // relative to the preemphasized value, not to the raw samples
          // (a loud low tone would otherwise drown the quiet low bins)
          frames[at(r, k)] =
              wk * (fmaf(-preemph, pv, v) - (1.f - preemph) * mean[f]);
        }
      }
    }
  }
  __syncthreads();

  // complex FFT of the packed pairs, then the split pass into the power,
  // written over the frame's own spectrum (p[b] at float b of the frame)
  {
    const int t = tid % G;
    constexpr int kPairs = (N / 2) / G + 1;  // k = t + G i, k <= N / 2
    for (int f0 = 0; f0 < F; f0 += kBatch) {
      const int r = f0 + tid / G;
      float* fr = frames + r * FS;
      float2* z = reinterpret_cast<float2*>(fr);
      fft_stages<N, 1, G>(z, tw, t);
      float pk[kPairs], pn[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int k = t + G * i;
        pk[i] = pn[i] = 0.f;
        if (k <= N / 2) {
          const float2 a = z[zpad(k)];
          const float2 b = z[zpad(k == 0 ? 0 : N - k)];
          const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
          const float2 o = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
          const float2 wo = cmul(tw[k], o);
          const float xr = e.x + wo.x, xi = e.y + wo.y;
          const float yr = e.x - wo.x, yi = e.y - wo.y;
          pk[i] = xr * xr + xi * xi;
          pn[i] = yr * yr + yi * yi;
          if (!use_power) {
            pk[i] = sqrtf(pk[i]);
            pn[i] = sqrtf(pn[i]);
          }
        }
      }
      group_sync<G>();
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int k = t + G * i;
        if (k <= N / 2) {
          fr[k] = k < kLowBins ? lowp[r * kLowBins + k] : pk[i];
          if (k < N / 2) fr[N - k] = pn[i];  // k = N/2: its own mirror
        }
      }
      group_sync<G>();
    }
  }
  __syncthreads();

  // mel over each filter's bins (+ log) into the log-mel tile: the 32
  // lanes of a warp take one filter of 32 frames (one trip count)
  for (int i = tid; i < F * M; i += kThreads) {
    const int m = i / F;
    const int r = i - m * F;
    const int lo = bnd[3 * m], hi = bnd[3 * m + 1];
    const float* p = frames + r * FS;
    const float* w = melw + bnd[3 * m + 2] - lo;
    float acc = 0.f;
    for (int b = lo; b < hi; ++b) acc = fmaf(p[b], w[b], acc);
    if (use_log) acc = logf(fmaxf(acc, eps));
    melbuf[r * M + m] = acc;
  }
  __syncthreads();
  // the block's live rows of the output, coalesced
  if (dct != nullptr) {
    for (int i = tid; i < live * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) {
        acc = fmaf(melbuf[r * M + m], dct[static_cast<size_t>(m) * D + c],
                   acc);
      }
      out[row0 * D + i] = acc;
    }
  } else {
    for (int i = tid; i < live * M; i += kThreads) out[row0 * M + i] = melbuf[i];
  }
}

template <int LOG2N>
int launch_fft(const float* waves, const float* window, const float2* tw,
               const float* low, const float* mel_t, const int* bands,
               const float* dct,
               const long long* seed, float* out, int S, int T, long long rows,
               int FL, int shift, int M, int D, int n_band, float dither,
               float preemph, int remove_dc, int use_power, int use_log,
               float eps, int pairs, size_t smem, cudaStream_t stream) {
  constexpr int F = fft_frames(LOG2N);
  auto kern = fused_fbank_kernel<LOG2N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((rows + F - 1) / F);
  kern<<<grid, kThreads, smem, stream>>>(
      waves, window, tw, low, mel_t, bands, dct, seed, out, S, T, rows, FL,
      shift, M, D, n_band, dither, preemph, remove_dc, use_power, use_log,
      eps, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Frames a block of the FFT plan takes at this n_fft (the frames fill
// 16,384 floats: two blocks an SM at n_fft 512), or 0 when n_fft is not
// a power of two from 128 to 2048.
int fused_fbank_fft_frames(int n_fft) {
  for (int l = kMinLog2; l <= kMaxLog2; ++l) {
    if (n_fft == (1 << l)) return fft_frames(l);
  }
  return 0;
}

// Bytes of shared memory a block of the FFT plan takes (the wrapper's
// mirror: ops/fused_frontend.py `fft_smem_bytes`).
int fused_fbank_fft_smem_bytes(int n_fft, int FL, int n_band, int M) {
  return static_cast<int>(sizeof(float)) *
         fft_smem_floats(n_fft, fused_fbank_fft_frames(n_fft), FL, n_band,
                         M);
}

// FFT plan.  Returns a cudaError_t code (0 on success).  waves (B, S);
// window (FL,); twiddles (n_fft, 2) = exp(-2 pi i m / n_fft); low
// (round_up(FL, 32), 32) the folded operator's columns of bins 0 .. 15 as
// [re, im] pairs, zero rows past FL; mel_t
// (nbin, M), nbin = n_fft / 2 + 1; bands (M, 3) int32 = [lo, hi) of
// filter m's bins and the offset of its weights in a packed array of
// n_band; dct (M, D) or null (then D == M); seed: one int64 on the
// device, read only when dither > 0; out (B, T, D) with T = 1 + (S - FL)
// / shift.
int fused_fbank_fft_launch(const void* waves, const void* window,
                           const void* twiddles, const void* low,
                           const void* mel_t,
                           const void* bands, const void* dct,
                           const void* seed, void* out, int B, int S, int T,
                           int FL, int shift, int n_fft, int M, int D,
                           int n_band, float dither,
                           float preemph, int remove_dc, int use_power,
                           int use_log, float eps, void* stream) {
  if (fused_fbank_fft_frames(n_fft) == 0 || B < 1 || T < 1 || FL < 1 || FL > n_fft || shift < 1 ||
      M < 1 || D < 1 || n_band < 1 || S < FL + (T - 1) * shift ||
      (dct == nullptr && D != M) || (dither > 0.f && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(
      fused_fbank_fft_smem_bytes(n_fft, FL, n_band, M));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * T;
  // every frame starts on an even sample of an 8-byte aligned wave
  const int pairs = S % 2 == 0 && shift % 2 == 0 &&
                    reinterpret_cast<size_t>(waves) % 8 == 0;
#define WEKWS_FFT(L)                                                         \
  return launch_fft<L>(                                                      \
      static_cast<const float*>(waves), static_cast<const float*>(window),   \
      static_cast<const float2*>(twiddles), static_cast<const float*>(low),  \
      static_cast<const float*>(mel_t), static_cast<const int*>(bands),      \
      static_cast<const float*>(dct), static_cast<const long long*>(seed),   \
      static_cast<float*>(out), S, T, rows, FL, shift, M, D, n_band, dither, \
      preemph, remove_dc, use_power, use_log, eps, pairs, smem,              \
      static_cast<cudaStream_t>(stream))
  switch (n_fft) {
    case 128: WEKWS_FFT(7);
    case 256: WEKWS_FFT(8);
    case 512: WEKWS_FFT(9);
    case 1024: WEKWS_FFT(10);
    default: WEKWS_FFT(11);
  }
#undef WEKWS_FFT
}

// Dense plan.  Returns a cudaError_t code (0 on success).  waves (B, S);
// A (FL, 2 * nbin); mel_t (nbin, M); dct (M, D) or null (then D == M);
// seed: one int64 on the device, read only when dither > 0; out (B, T, D)
// with T = 1 + (S - FL) / shift.
int fused_fbank_dense_launch(const void* waves, const void* A,
                             const void* mel_t, const void* dct,
                             const void* seed, void* out, int B, int S, int T,
                             int FL, int shift, int nbin, int M, int D,
                             float dither, int use_power, int use_log,
                             float eps, void* stream) {
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
      fused_fbank_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * T;
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  fused_fbank_dense_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
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
