// Whole-backbone BN-folded DS-TCN forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel wekws_tpu/ops/fused_tcn.py `_kernel`
// (via `fused_ds_tcn`).
//
// Per layer l (dilation d_l, K taps, C channels, BN already folded):
//   a = sum_j in[t - (K-1-j) d_l] * dw_w[l, j] + dw_b[l]   (causal depthwise)
//   h = relu(a)
//   p = h @ pw_w[l] + pw_b[l]
//   y = relu(p) + in[t]                  (residual AFTER the second ReLU)
// and the output is the last layer's y.  The left margin of layer l is
// cache_in[l]; cache_out[l] receives the last pad_max rows of
// [cache_in[l] | layer-l input].  All pad_max rows are carried although
// only the last (K-1) d_l are read.
//
// Bound on an H100 (C=64, K=8, 4 layers): at B=16, T=198 (offline
// scoring) the work is 4 layers x 3,168 frames x (2KC + 2C^2 + 4C) =
// 0.12 GFLOP (1.8 us at 67 TFLOP/s fp32) against 3.5 MB of compulsory
// traffic (x, out, the (L, B, pad_max, C) cache in and out; 1.1 us at
// 3.35 TB/s): bound by operations.  The streaming step B=16, T=8 is
// bound by bytes: 2.0 MB, nearly all of it cache, against 5 MFLOP.  In
// practice this design is bound by latency inside one SM per batch row:
// the layers run in sequence, each a weight load and two barriers per
// tile.
//
// Design: that of csrc/fused_mdtc.cu with the DS-TCN's arithmetic.  One
// thread block per batch row walks all layers in order, so no state
// crosses blocks.  The TPU kernel keeps the (pad_max + T, C) window in
// VMEM and updates it in place; with time tiles an in-place update would
// overwrite left context a later tile still reads, so the activations
// live in a per-row global ping-pong buffer (`act`, 2 x (pad_max + T) x
// C, L2-resident at these sizes): layer l reads buffer l%2 and writes
// buffer (l+1)%2.  Shared memory holds the layer's folded weights and one
// time tile of 64 rows.  Each thread owns one channel and a strided set
// of the tile's rows; the C x C product is a plain fp32 FMA loop from
// shared memory (the activation row is read as float4 broadcasts).
// cache_out[l] is read from the window after cache_in[l] is copied in
// and before anything is written; the wrapper allocates it fresh, so it
// never aliases cache_in (they overlap in time when T < pad_max).  A tile
// with fewer than 64 live rows (a streaming chunk, the last tile)
// computes only those.  Takes C in {32, 64, 128}, K <= 8, L <= 64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;
constexpr int kMaxLayers = 64;
constexpr int kMaxTaps = 8;

struct LayerDilations {
  int d[kMaxLayers];
};

// One time tile of one layer: rows t0 .. t0 + 63 (those below T).
// Thread (g, c) owns channel c of tile rows g + j * kGroups.  kFull tiles
// run the loops without row guards; a partial tile stops at jmax, the
// first j whose rows are all past T.
template <int C, bool kFull>
__device__ __forceinline__ void tcn_tile(
    const float* __restrict__ cur, float* __restrict__ nxt,
    float* __restrict__ outr, const float* __restrict__ w,
    float* __restrict__ h_tile, const float* __restrict__ bias,
    const float* __restrict__ dw, int t0, int T, int K, int d, int pad_max,
    int g, int c) {
  constexpr int kGroups = kThreads / C;
  constexpr int kRows = kTileRows / kGroups;  // tile rows per thread
  const int jmax = kFull ? kRows : (T - t0 + kGroups - 1) / kGroups;

  // h = relu(causal dilated depthwise conv + bias)
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
      v = fmaxf(v + bias[c], 0.f);
    }
    h_tile[r * C + c] = v;
  }
  __syncthreads();

  // y = relu(h @ W + b) + x_in
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  for (int k = 0; k < C; k += 4) {
    const float wa = w[k * C + c];
    const float wb = w[(k + 1) * C + c];
    const float wc = w[(k + 2) * C + c];
    const float wd = w[(k + 3) * C + c];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!kFull && j >= jmax) break;
      const float4 hv = *reinterpret_cast<const float4*>(
          &h_tile[(g + j * kGroups) * C + k]);
      acc[j] = fmaf(hv.x, wa, acc[j]);
      acc[j] = fmaf(hv.y, wb, acc[j]);
      acc[j] = fmaf(hv.z, wc, acc[j]);
      acc[j] = fmaf(hv.w, wd, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!kFull && j >= jmax) break;
    const int t = t0 + g + j * kGroups;
    if (kFull || t < T) {
      const size_t at = static_cast<size_t>(pad_max + t) * C + c;
      const float y = fmaxf(acc[j] + bias[C + c], 0.f) + cur[at];
      nxt[at] = y;
      if (outr != nullptr) outr[static_cast<size_t>(t) * C + c] = y;
    }
  }
  // the next tile writes h_tile only after this barrier
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(kThreads)
fused_tcn_kernel(const float* __restrict__ x,
                 const float* __restrict__ cache_in,
                 const float* __restrict__ dw_w,
                 const float* __restrict__ dw_b,
                 const float* __restrict__ pw_w,
                 const float* __restrict__ pw_b,
                 float* __restrict__ out,
                 float* __restrict__ cache_out,
                 float* __restrict__ act,
                 int batch, int T, int L, int K, int pad_max,
                 LayerDilations dil) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);  // (C, C) [in][out]
  float* h_tile = w + C * C;                    // (kTileRows, C)
  float* bias = h_tile + kTileRows * C;         // dw_b | pw_b
  float* dw = bias + 2 * C;                     // (K, C)

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const size_t span = static_cast<size_t>(pad_max + T) * C;
  float* bufs[2] = {act + 2 * row * span, act + (2 * row + 1) * span};
  const float* xr = x + static_cast<size_t>(row) * T * C;
  float* outr = out + static_cast<size_t>(row) * T * C;

  for (int i = tid; i < T * C; i += kThreads) bufs[0][pad_max * C + i] = xr[i];

  for (int l = 0; l < L; ++l) {
    float* cur = bufs[l & 1];
    float* nxt = bufs[(l + 1) & 1];
    const int d = dil.d[l];

    // everything the previous layer wrote (and read) is settled
    __syncthreads();
    const float4* wg =
        reinterpret_cast<const float4*>(pw_w + static_cast<size_t>(l) * C * C);
    for (int i = tid; i < C * C / 4; i += kThreads) {
      reinterpret_cast<float4*>(w)[i] = wg[i];
    }
    for (int i = tid; i < K * C; i += kThreads) {
      dw[i] = dw_w[static_cast<size_t>(l) * K * C + i];
    }
    for (int i = tid; i < C; i += kThreads) {
      bias[i] = dw_b[l * C + i];
      bias[C + i] = pw_b[l * C + i];
    }
    const float* ci =
        cache_in + (static_cast<size_t>(l) * batch + row) * pad_max * C;
    for (int i = tid; i < pad_max * C; i += kThreads) cur[i] = ci[i];
    __syncthreads();
    // last pad_max rows of [margin | layer input], read before any write
    float* co = cache_out + (static_cast<size_t>(l) * batch + row) * pad_max * C;
    for (int i = tid; i < pad_max * C; i += kThreads) co[i] = cur[T * C + i];
    float* dst = (l == L - 1) ? outr : nullptr;

    for (int t0 = 0; t0 < T; t0 += kTileRows) {
      if (T - t0 >= kTileRows) {
        tcn_tile<C, true>(cur, nxt, dst, w, h_tile, bias, dw, t0, T, K, d,
                          pad_max, g, c);
      } else {
        tcn_tile<C, false>(cur, nxt, dst, w, h_tile, bias, dw, t0, T, K, d,
                           pad_max, g, c);
      }
    }
  }
}

template <int C>
int launch(const float* x, const float* cache_in, const float* dw_w,
           const float* dw_b, const float* pw_w, const float* pw_b,
           float* out, float* cache_out, float* act, int batch, int T, int L,
           int K, int pad_max, const LayerDilations& dil,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (C * C + kTileRows * C + 2 * C + K * C);
  cudaError_t err = cudaFuncSetAttribute(
      fused_tcn_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_tcn_kernel<C><<<batch, kThreads, smem, stream>>>(
      x, cache_in, dw_w, dw_b, pw_w, pw_b, out, cache_out, act, batch, T, L,
      K, pad_max, dil);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success).  `act` is scratch of
// batch * 2 * (pad_max + T) * C floats.
int fused_tcn_launch(const void* x, const void* cache_in, const void* dw_w,
                     const void* dw_b, const void* pw_w, const void* pw_b,
                     void* out, void* cache_out, void* act, int batch, int T,
                     int C, int L, int K, int pad_max, const int* dilations,
                     void* stream) {
  if (L < 1 || L > kMaxLayers || batch < 1 || T < 1 || K < 1 ||
      K > kMaxTaps || cache_in == nullptr || cache_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayerDilations dil;
  for (int l = 0; l < L; ++l) {
    if ((K - 1) * dilations[l] > pad_max) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    dil.d[l] = dilations[l];
  }
  const auto s = static_cast<cudaStream_t>(stream);
#define WEKWS_LAUNCH(CH)                                                   \
  launch<CH>(static_cast<const float*>(x),                                 \
             static_cast<const float*>(cache_in),                          \
             static_cast<const float*>(dw_w),                              \
             static_cast<const float*>(dw_b),                              \
             static_cast<const float*>(pw_w),                              \
             static_cast<const float*>(pw_b), static_cast<float*>(out),    \
             static_cast<float*>(cache_out), static_cast<float*>(act),     \
             batch, T, L, K, pad_max, dil, s)
  switch (C) {
    case 32: return WEKWS_LAUNCH(32);
    case 64: return WEKWS_LAUNCH(64);
    case 128: return WEKWS_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WEKWS_LAUNCH
}

const char* fused_tcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
