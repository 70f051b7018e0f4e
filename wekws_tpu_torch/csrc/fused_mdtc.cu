// Whole-backbone BN-folded MDTC forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels wekws_tpu/ops/fused_mdtc.py `_kernel`
// (whole utterance, via `fused_mdtc_forward`) and `_kernel_stream`
// (carried left context, via `fused_mdtc_stream`).  One source serves
// both: `cache_in`/`cache_out` are null for the whole-utterance entry.
//
// Per layer l (dilation d_l, K taps, C channels, BN already folded):
//   a = sum_j act[t - (K-1-j) d_l] * dw_w[l, j] + dw_b[l]   (causal depthwise)
//   b = relu(a @ pw1_w[l] + pw1_b[l])
//   y = relu(b @ pw2_w[l] + pw2_b[l] + act[t])              (residual)
// and the output of every layer l > 0 with l % stack_size == 0 is summed
// into `out` (multi-scale aggregation).  In streaming mode the left
// margin of layer l is cache_in[l] and cache_out[l] receives the last
// pad_max rows of [cache_in[l] | layer-l input]; all pad_max rows are
// carried although only the last (K-1) d_l are read.
//
// Bound on an H100: at B=64, T=198 the work is ~3.7 GFLOP of fp32 FMA
// against ~7 MB of compulsory traffic, so it is bound by operations on
// the CUDA cores (67 TFLOP/s fp32).  At the serving step (B=16, T=8) it
// is bound by bytes: the 17 layers' folded weights (~0.6 MB) and the
// (L, B, pad_max, C) cache in and out (~4.5 MB) against ~40 MFLOP.  In
// practice this design is bound by latency inside one SM per row: 17
// layers in sequence, each a weight load and two barriers per tile.
//
// Design: one thread block per batch row walks all layers in order, so
// no state crosses blocks.  The TPU kernel keeps the whole
// (pad_max + T, C) window in VMEM; a Hopper block has 227 KB of shared
// memory, which T = 2048 frames would overflow, so the activations live
// in a per-row global ping-pong buffer (`act`, 2 x (pad_max + T) x C,
// L2-resident at these sizes) and shared memory holds the layer's folded
// weights and one time tile of 64 rows.  Each thread owns one channel
// and a strided set of the tile's rows; the two C x C products are plain
// fp32 FMA loops from shared memory (the activation row is read as
// float4 broadcasts).  Layer l reads buffer l%2 and writes buffer
// (l+1)%2, so no tile overwrites context another tile still reads.  A
// tile with fewer than 64 live rows (a streaming chunk, the last tile)
// computes only those.  Tensor cores (wgmma), more warps and more than
// one block per row are left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;
constexpr int kMaxLayers = 64;

struct LayerDilations {
  int d[kMaxLayers];
};

// One time tile of one layer: rows t0 .. t0 + 63 (those below T).
// Thread (g, c) owns channel c of tile rows g + j * kGroups.  kFull
// tiles (64 live rows) run the loops without row guards; a partial tile
// (a short streaming chunk, the last tile) stops at jmax, the first j
// whose rows are all past T, so it pays only for the rows it has.
template <int C, bool kFull>
__device__ __forceinline__ void mdtc_tile(
    const float* __restrict__ cur, float* __restrict__ nxt,
    float* __restrict__ outr, const float* __restrict__ w1,
    const float* __restrict__ w2, float* __restrict__ a_tile,
    float* __restrict__ b_tile, const float* __restrict__ bias,
    const float* __restrict__ dw, int t0, int T, int K, int d, int pad_max,
    bool accumulate, int g, int c) {
  constexpr int kGroups = kThreads / C;
  constexpr int kRows = kTileRows / kGroups;  // tile rows per thread
  const int jmax = kFull ? kRows : (T - t0 + kGroups - 1) / kGroups;

  // causal dilated depthwise conv + bias -> a_tile
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!kFull && j >= jmax) break;
    const int r = g + j * kGroups;
    const int t = t0 + r;
    float v = 0.f;
    if (kFull || t < T) {
      const float* src = cur + static_cast<size_t>(pad_max + t) * C + c;
      for (int tap = 0; tap < K; ++tap) {
        v = fmaf(src[-(K - 1 - tap) * d * C], dw[tap * C + c], v);
      }
      v += bias[c];
    }
    a_tile[r * C + c] = v;
  }
  __syncthreads();

  // b = relu(a @ W1 + b1)
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  for (int k = 0; k < C; k += 4) {
    const float wa = w1[k * C + c];
    const float wb = w1[(k + 1) * C + c];
    const float wc = w1[(k + 2) * C + c];
    const float wd = w1[(k + 3) * C + c];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!kFull && j >= jmax) break;
      const float4 av = *reinterpret_cast<const float4*>(&a_tile[(g + j * kGroups) * C + k]);
      acc[j] = fmaf(av.x, wa, acc[j]);
      acc[j] = fmaf(av.y, wb, acc[j]);
      acc[j] = fmaf(av.z, wc, acc[j]);
      acc[j] = fmaf(av.w, wd, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!kFull && j >= jmax) break;
    b_tile[(g + j * kGroups) * C + c] = fmaxf(acc[j] + bias[C + c], 0.f);
  }
  __syncthreads();

  // y = relu(b @ W2 + b2 + x_in); stack outputs summed into out
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  for (int k = 0; k < C; k += 4) {
    const float wa = w2[k * C + c];
    const float wb = w2[(k + 1) * C + c];
    const float wc = w2[(k + 2) * C + c];
    const float wd = w2[(k + 3) * C + c];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!kFull && j >= jmax) break;
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[(g + j * kGroups) * C + k]);
      acc[j] = fmaf(bv.x, wa, acc[j]);
      acc[j] = fmaf(bv.y, wb, acc[j]);
      acc[j] = fmaf(bv.z, wc, acc[j]);
      acc[j] = fmaf(bv.w, wd, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!kFull && j >= jmax) break;
    const int t = t0 + g + j * kGroups;
    if (kFull || t < T) {
      const size_t at = static_cast<size_t>(pad_max + t) * C + c;
      const float y = fmaxf(acc[j] + bias[2 * C + c] + cur[at], 0.f);
      nxt[at] = y;
      if (accumulate) outr[static_cast<size_t>(t) * C + c] += y;
    }
  }
  // the next tile's depthwise writes a_tile only after every thread has
  // passed this tile's second barrier, and its first barrier orders its
  // b_tile writes after these reads
}

template <int C>
__global__ void __launch_bounds__(kThreads)
fused_mdtc_kernel(const float* __restrict__ x,
                  const float* __restrict__ cache_in,
                  const float* __restrict__ dw_w,
                  const float* __restrict__ dw_b,
                  const float* __restrict__ pw1_w,
                  const float* __restrict__ pw1_b,
                  const float* __restrict__ pw2_w,
                  const float* __restrict__ pw2_b,
                  float* __restrict__ out,
                  float* __restrict__ cache_out,
                  float* __restrict__ act,
                  int batch, int T, int L, int K, int stack_size, int pad_max,
                  LayerDilations dil) {
  extern __shared__ float4 smem4[];
  float* w1 = reinterpret_cast<float*>(smem4);  // (C, C) [in][out]
  float* w2 = w1 + C * C;
  float* a_tile = w2 + C * C;                    // (kTileRows, C)
  float* b_tile = a_tile + kTileRows * C;
  float* bias = b_tile + kTileRows * C;          // dw_b | pw1_b | pw2_b
  float* dw = bias + 3 * C;                      // (K, C)

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const size_t span = static_cast<size_t>(pad_max + T) * C;
  float* bufs[2] = {act + 2 * row * span, act + (2 * row + 1) * span};
  const float* xr = x + static_cast<size_t>(row) * T * C;
  float* outr = out + static_cast<size_t>(row) * T * C;

  for (int i = tid; i < T * C; i += kThreads) {
    bufs[0][pad_max * C + i] = xr[i];
    outr[i] = 0.f;
  }
  if (cache_in == nullptr) {
    for (int i = tid; i < pad_max * C; i += kThreads) {
      bufs[0][i] = 0.f;
      bufs[1][i] = 0.f;
    }
  }

  for (int l = 0; l < L; ++l) {
    float* cur = bufs[l & 1];
    float* nxt = bufs[(l + 1) & 1];
    const int d = dil.d[l];

    // everything the previous layer wrote (and read) is settled
    __syncthreads();
    const float4* w1g = reinterpret_cast<const float4*>(pw1_w + static_cast<size_t>(l) * C * C);
    const float4* w2g = reinterpret_cast<const float4*>(pw2_w + static_cast<size_t>(l) * C * C);
    for (int i = tid; i < C * C / 4; i += kThreads) {
      reinterpret_cast<float4*>(w1)[i] = w1g[i];
      reinterpret_cast<float4*>(w2)[i] = w2g[i];
    }
    for (int i = tid; i < K * C; i += kThreads) dw[i] = dw_w[static_cast<size_t>(l) * K * C + i];
    for (int i = tid; i < C; i += kThreads) {
      bias[i] = dw_b[l * C + i];
      bias[C + i] = pw1_b[l * C + i];
      bias[2 * C + i] = pw2_b[l * C + i];
    }
    if (cache_in != nullptr) {
      const float* ci = cache_in + (static_cast<size_t>(l) * batch + row) * pad_max * C;
      for (int i = tid; i < pad_max * C; i += kThreads) cur[i] = ci[i];
    }
    __syncthreads();
    if (cache_out != nullptr) {
      // last pad_max rows of [margin | layer input], read before any write
      float* co = cache_out + (static_cast<size_t>(l) * batch + row) * pad_max * C;
      for (int i = tid; i < pad_max * C; i += kThreads) co[i] = cur[T * C + i];
    }
    const bool accumulate = l > 0 && (l % stack_size) == 0;

    for (int t0 = 0; t0 < T; t0 += kTileRows) {
      if (T - t0 >= kTileRows) {
        mdtc_tile<C, true>(cur, nxt, outr, w1, w2, a_tile, b_tile, bias, dw,
                           t0, T, K, d, pad_max, accumulate, g, c);
      } else {
        mdtc_tile<C, false>(cur, nxt, outr, w1, w2, a_tile, b_tile, bias,
                            dw, t0, T, K, d, pad_max, accumulate, g, c);
      }
    }
  }
}

template <int C>
int launch(const float* x, const float* cache_in, const float* dw_w,
           const float* dw_b, const float* pw1_w, const float* pw1_b,
           const float* pw2_w, const float* pw2_b, float* out,
           float* cache_out, float* act, int batch, int T, int L, int K,
           int stack_size, int pad_max, const LayerDilations& dil,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * C * C + 2 * kTileRows * C + 3 * C + K * C);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mdtc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mdtc_kernel<C><<<batch, kThreads, smem, stream>>>(
      x, cache_in, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b, out, cache_out,
      act, batch, T, L, K, stack_size, pad_max, dil);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success).  `act` is scratch of
// batch * 2 * (pad_max + T) * C floats; cache pointers are both null
// (whole utterance, zero left context) or both set (streaming).
int fused_mdtc_launch(const void* x, const void* cache_in, const void* dw_w,
                      const void* dw_b, const void* pw1_w, const void* pw1_b,
                      const void* pw2_w, const void* pw2_b, void* out,
                      void* cache_out, void* act, int batch, int T, int C,
                      int L, int K, int stack_size, int pad_max,
                      const int* dilations, void* stream) {
  if (L < 1 || L > kMaxLayers || batch < 1 || T < 1 || K < 1 ||
      stack_size < 1 || (cache_in == nullptr) != (cache_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayerDilations dil;
  for (int l = 0; l < L; ++l) dil.d[l] = dilations[l];
  const auto s = static_cast<cudaStream_t>(stream);
#define WEKWS_LAUNCH(CH)                                                   \
  launch<CH>(static_cast<const float*>(x),                                 \
             static_cast<const float*>(cache_in),                          \
             static_cast<const float*>(dw_w),                              \
             static_cast<const float*>(dw_b),                              \
             static_cast<const float*>(pw1_w),                             \
             static_cast<const float*>(pw1_b),                             \
             static_cast<const float*>(pw2_w),                             \
             static_cast<const float*>(pw2_b), static_cast<float*>(out),   \
             static_cast<float*>(cache_out), static_cast<float*>(act),     \
             batch, T, L, K, stack_size, pad_max, dil, s)
  switch (C) {
    case 32: return WEKWS_LAUNCH(32);
    case 64: return WEKWS_LAUNCH(64);
    case 128: return WEKWS_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WEKWS_LAUNCH
}

const char* fused_mdtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
