// Whole-backbone fused FSMN layer chain for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel wekws_tpu/ops/fused_fsmn.py `_kernel`
// (via `fused_fsmn_layers`).
//
// Per layer l, on cur (T, LD) (the previous layer's output, x for l = 0):
//   p   = cur @ proj_w[l]                         (LD -> PD, no bias)
//   ext = [cache_in[l] (P rows); p]               P = (lo-1) ls + ro rs
//   o[t] = ext[start + t]                         start = (lo-1) ls
//        + sum_{j<lo} ext[t + j ls] * wl[l, j]
//        + sum_{j<ro} ext[start + rs + t + j rs] * wr[l, j]
//   cur = relu(o @ aff_w[l] + aff_b[l])           (PD -> LD)
//   cache_out[l] = last P rows of ext
// Output frame t belongs to input frame t - ro rs, so in this delayed
// frame every tap looks back: rows t .. t + P of ext.
//
// Bound on an H100 (LD=250, PD=128, 4 layers, lo=10, ro=2): at
// B=16, T=66 the two products are 4 x 1,056 frames x 4 x 250 x 128 =
// 0.54 GFLOP (8.2 us at 67 TFLOP/s fp32) against 3.8 MB (x, out, the
// weights, the cache; 1.1 us at 3.35 TB/s): bound by operations.  The
// single-stream step B=1, T=10 is bound by bytes: the four layers'
// weights (1.05 MB) against 5 MFLOP.  In practice B=1 is one block on one
// SM walking a chain of dependent stages per layer (two stagings of
// 128,000 bytes, two products, the gathers through L2), bound by their
// latencies, not by either roofline.
//
// Design: one thread block per batch row walks the layers in order, so
// no state crosses blocks.  The widths are not powers of two (250, 128,
// P = 11): every loop masks its ragged edge, nothing is padded in device
// memory.  proj_w and aff_w (128,000 bytes each at the recipe's widths)
// do not fit in shared memory together, so each layer runs two passes
// over 32-row time tiles with ONE matrix staged at a time:
//   pass 1: stage proj_w; per tile load cur rows, p = cur @ proj_w,
//           write p into the row's ext buffer in device memory
//           ((P + T) x PD, L2-resident) behind the copied cache rows;
//   then    cache_out[l] = ext rows T .. T + P (after every p row is
//           written and before anything else changes: with T < P the
//           new cache mixes old cache rows and new frames);
//   pass 2: stage aff_w; per tile gather the memory taps from ext into
//           shared memory, y = relu(o @ aff_w + b), written to `out`,
//           which doubles as the cur buffer of the next layer (pass 1 of
//           a layer has consumed every row before pass 2 overwrites it).
// In a product each thread owns one output column and a strided set of
// the tile's rows; the input row is read from shared memory as float4
// broadcasts and the weights as conflict-free columns; reduction depth is
// zero-padded to a multiple of 4 in shared memory only.  A partial tile
// (a streaming chunk of ~10 frames, the last tile) computes only its live
// rows.  Takes LD and PD up to 256 within 227 KB of shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Stage one layer's (n floats) matrix into shared memory and zero its
// padding up to n_pad; 16 bytes a thread where the source allows it (one
// block moves 128,000 bytes per matrix, and at B = 1 that is most of the
// layer's time).
__device__ __forceinline__ void stage_matrix(float* __restrict__ wbuf,
                                             const float* __restrict__ src,
                                             int n, int n_pad) {
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(wbuf);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) dst4[i] = src4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) wbuf[i] = src[i];
  }
  for (int i = n + threadIdx.x; i < n_pad; i += kThreads) wbuf[i] = 0.f;
}

// acc[j] = sum_k tile[g + j G][k] * w[k][c] for this thread's column c
// and rows g + j G.  `kp` (a multiple of 4) rows of w are valid (zero
// padded), `ks` is the tile's row stride.
template <int CL, bool kFull>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ tile, int ks, int kp,
    const float* __restrict__ w, int n, int live, int g, int c,
    float (&acc)[kTile / (kThreads / CL)]) {
  constexpr int G = kThreads / CL;
  constexpr int R = kTile / G;
  const int jmax = kFull ? R : (live + G - 1 - g) / G;
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  if (c >= n) return;
  for (int k = 0; k < kp; k += 4) {
    const float wa = w[k * n + c];
    const float wb = w[(k + 1) * n + c];
    const float wc = w[(k + 2) * n + c];
    const float wd = w[(k + 3) * n + c];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!kFull && j >= jmax) break;
      const float4 v =
          *reinterpret_cast<const float4*>(&tile[(g + j * G) * ks + k]);
      acc[j] = fmaf(v.x, wa, acc[j]);
      acc[j] = fmaf(v.y, wb, acc[j]);
      acc[j] = fmaf(v.z, wc, acc[j]);
      acc[j] = fmaf(v.w, wd, acc[j]);
    }
  }
}

// Pass 1 of one tile: p = cur @ proj_w, stored behind the cache rows.
template <int CL, bool kFull>
__device__ __forceinline__ void proj_tile(
    const float* __restrict__ in, float* __restrict__ extr,
    float* __restrict__ tile, const float* __restrict__ w, int t0, int live,
    int LD, int PD, int P) {
  constexpr int G = kThreads / CL;
  constexpr int R = kTile / G;
  const int ldp = round4(LD);
  // `in` is x or the previous layer's rows of `out`; nothing here writes
  // them, so the loads of several iterations may be in flight together
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * ldp; i += kThreads) {
    const int r = i / ldp;
    const int k = i - r * ldp;
    tile[i] = (r < live && k < LD)
                  ? in[static_cast<size_t>(t0 + r) * LD + k] : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % CL;
  const int g = threadIdx.x / CL;
  float acc[R];
  tile_product<CL, kFull>(tile, ldp, ldp, w, PD, live, g, c, acc);
  if (c < PD) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = g + j * G;
      if (kFull || r < live) {
        extr[static_cast<size_t>(P + t0 + r) * PD + c] = acc[j];
      }
    }
  }
  __syncthreads();  // the next tile's load overwrites `tile`
}

// Pass 2 of one tile: memory taps from ext, then relu(o @ aff_w + b).
template <int CL, bool kFull>
__device__ __forceinline__ void affine_tile(
    const float* __restrict__ extr, float* __restrict__ outr,
    float* __restrict__ tile, const float* __restrict__ w,
    const float* __restrict__ taps_l, const float* __restrict__ taps_r,
    const float* __restrict__ bias, int t0, int live, int LD, int PD,
    int lorder, int rorder, int lstride, int rstride) {
  constexpr int G = kThreads / CL;
  constexpr int R = kTile / G;
  const int pdp = round4(PD);
  const int start = (lorder - 1) * lstride;
#pragma unroll 2
  for (int i = threadIdx.x; i < kTile * pdp; i += kThreads) {
    const int r = i / pdp;
    const int c = i - r * pdp;
    float v = 0.f;
    if (r < live && c < PD) {
      const float* e = extr + static_cast<size_t>(t0 + r) * PD + c;
      v = e[static_cast<size_t>(start) * PD];  // identity path
      for (int j = 0; j < lorder; ++j) {
        v = fmaf(e[static_cast<size_t>(j * lstride) * PD],
                 taps_l[j * PD + c], v);
      }
      for (int j = 0; j < rorder; ++j) {
        v = fmaf(e[static_cast<size_t>(start + rstride + j * rstride) * PD],
                 taps_r[j * PD + c], v);
      }
    }
    tile[i] = v;
  }
  __syncthreads();
  const int c = threadIdx.x % CL;
  const int g = threadIdx.x / CL;
  float acc[R];
  tile_product<CL, kFull>(tile, pdp, pdp, w, LD, live, g, c, acc);
  if (c < LD) {
    const float b = bias[c];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = g + j * G;
      if (kFull || r < live) {
        outr[static_cast<size_t>(t0 + r) * LD + c] = fmaxf(acc[j] + b, 0.f);
      }
    }
  }
  __syncthreads();
}

// CLP / CLL: thread lanes over the columns of the two products, the
// smallest of 64, 128, 256 that holds PD / LD.
template <int CLP, int CLL>
__global__ void __launch_bounds__(kThreads)
fused_fsmn_kernel(const float* x, const float* __restrict__ cache_in,
                  const float* __restrict__ proj_w,
                  const float* __restrict__ wl, const float* __restrict__ wr,
                  const float* __restrict__ aff_w,
                  const float* __restrict__ aff_b, float* out,
                  float* __restrict__ cache_out, float* ext, int batch, int T,
                  int L, int LD, int PD, int lorder, int rorder, int lstride,
                  int rstride) {
  extern __shared__ float4 smem4[];
  const int ldp = round4(LD);
  const int pdp = round4(PD);
  const int wn = imax(ldp * PD, pdp * LD);
  float* wbuf = reinterpret_cast<float*>(smem4);  // one staged matrix
  float* tile = wbuf + wn;                         // (kTile, max(ldp, pdp))
  float* taps_l = tile + kTile * imax(ldp, pdp);   // (lorder, PD)
  float* taps_r = taps_l + lorder * PD;            // (rorder, PD)
  float* bias = taps_r + rorder * PD;              // (LD)

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = (lorder - 1) * lstride + rorder * rstride;
  const int wr_rows = rorder > 0 ? rorder : 1;
  float* extr = ext + static_cast<size_t>(row) * (P + T) * PD;
  float* outr = out + static_cast<size_t>(row) * T * LD;
  const float* xr = x + static_cast<size_t>(row) * T * LD;

  for (int l = 0; l < L; ++l) {
    const float* in = (l == 0) ? xr : outr;
    __syncthreads();  // the previous layer is settled
    stage_matrix(wbuf, proj_w + static_cast<size_t>(l) * LD * PD, LD * PD,
                 ldp * PD);
    for (int i = tid; i < lorder * PD; i += kThreads) {
      taps_l[i] = wl[static_cast<size_t>(l) * lorder * PD + i];
    }
    for (int i = tid; i < rorder * PD; i += kThreads) {
      taps_r[i] = wr[static_cast<size_t>(l) * wr_rows * PD + i];
    }
    for (int i = tid; i < LD; i += kThreads) bias[i] = aff_b[l * LD + i];
    const float* ci =
        cache_in + (static_cast<size_t>(l) * batch + row) * P * PD;
    for (int i = tid; i < P * PD; i += kThreads) extr[i] = ci[i];
    __syncthreads();

    for (int t0 = 0; t0 < T; t0 += kTile) {
      if (T - t0 >= kTile) {
        proj_tile<CLP, true>(in, extr, tile, wbuf, t0, kTile, LD, PD, P);
      } else {
        proj_tile<CLP, false>(in, extr, tile, wbuf, t0, T - t0, LD, PD, P);
      }
    }
    // every p row is in ext (the tiles end on a barrier)
    float* co = cache_out + (static_cast<size_t>(l) * batch + row) * P * PD;
    for (int i = tid; i < P * PD; i += kThreads) {
      co[i] = extr[static_cast<size_t>(T) * PD + i];
    }
    stage_matrix(wbuf, aff_w + static_cast<size_t>(l) * PD * LD, PD * LD,
                 pdp * LD);
    __syncthreads();

    for (int t0 = 0; t0 < T; t0 += kTile) {
      if (T - t0 >= kTile) {
        affine_tile<CLL, true>(extr, outr, tile, wbuf, taps_l, taps_r, bias,
                               t0, kTile, LD, PD, lorder, rorder, lstride,
                               rstride);
      } else {
        affine_tile<CLL, false>(extr, outr, tile, wbuf, taps_l, taps_r, bias,
                                t0, T - t0, LD, PD, lorder, rorder, lstride,
                                rstride);
      }
    }
  }
}

size_t smem_bytes(int LD, int PD, int lorder, int rorder) {
  const int ldp = round4(LD);
  const int pdp = round4(PD);
  const size_t wn = static_cast<size_t>(imax(ldp * PD, pdp * LD));
  return sizeof(float) * (wn + static_cast<size_t>(kTile) * imax(ldp, pdp) +
                          static_cast<size_t>(lorder + rorder) * PD + LD);
}

template <int CLP, int CLL>
int launch(const float* x, const float* cache_in, const float* proj_w,
           const float* wl, const float* wr, const float* aff_w,
           const float* aff_b, float* out, float* cache_out, float* ext,
           int batch, int T, int L, int LD, int PD, int lorder, int rorder,
           int lstride, int rstride, cudaStream_t stream) {
  const size_t smem = smem_bytes(LD, PD, lorder, rorder);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fsmn_kernel<CLP, CLL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_fsmn_kernel<CLP, CLL><<<batch, kThreads, smem, stream>>>(
      x, cache_in, proj_w, wl, wr, aff_w, aff_b, out, cache_out, ext, batch,
      T, L, LD, PD, lorder, rorder, lstride, rstride);
  return static_cast<int>(cudaGetLastError());
}

int lanes(int n) { return n <= 64 ? 64 : (n <= 128 ? 128 : 256); }

}  // namespace

extern "C" {

// Shared memory one block needs at these widths, for the wrapper's check.
int fused_fsmn_smem_bytes(int LD, int PD, int lorder, int rorder) {
  return static_cast<int>(smem_bytes(LD, PD, lorder, rorder));
}

// Returns a cudaError_t code (0 on success).  `ext` is scratch of
// batch * (P + T) * PD floats; `out` (batch, T, LD) is also the
// inter-layer buffer.
int fused_fsmn_launch(const void* x, const void* cache_in, const void* proj_w,
                      const void* wl, const void* wr, const void* aff_w,
                      const void* aff_b, void* out, void* cache_out, void* ext,
                      int batch, int T, int L, int LD, int PD, int lorder,
                      int rorder, int lstride, int rstride, void* stream) {
  if (batch < 1 || T < 1 || L < 1 || LD < 1 || LD > 256 || PD < 1 ||
      PD > 256 || lorder < 1 || rorder < 0 || lstride < 1 || rstride < 1 ||
      smem_bytes(LD, PD, lorder, rorder) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
#define WEKWS_LAUNCH(A, B)                                                  \
  launch<A, B>(static_cast<const float*>(x),                                \
               static_cast<const float*>(cache_in),                         \
               static_cast<const float*>(proj_w),                           \
               static_cast<const float*>(wl), static_cast<const float*>(wr), \
               static_cast<const float*>(aff_w),                            \
               static_cast<const float*>(aff_b), static_cast<float*>(out),  \
               static_cast<float*>(cache_out), static_cast<float*>(ext),    \
               batch, T, L, LD, PD, lorder, rorder, lstride, rstride, s)
#define WEKWS_LANES_L(A)                          \
  switch (lanes(LD)) {                            \
    case 64: return WEKWS_LAUNCH(A, 64);          \
    case 128: return WEKWS_LAUNCH(A, 128);        \
    default: return WEKWS_LAUNCH(A, 256);         \
  }
  switch (lanes(PD)) {
    case 64: WEKWS_LANES_L(64)
    case 128: WEKWS_LANES_L(128)
    default: WEKWS_LANES_L(256)
  }
  return static_cast<int>(cudaErrorInvalidValue);  // not reached
#undef WEKWS_LANES_L
#undef WEKWS_LAUNCH
}

const char* fused_fsmn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
