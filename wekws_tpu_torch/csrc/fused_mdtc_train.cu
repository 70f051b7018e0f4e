// Fused TCNBlock training step with exact BatchNorm, for Hopper
// (sm_90a), fp32.
//
// Replaces the eight Pallas TPU kernels of
// wekws_tpu/ops/fused_mdtc_train.py: `_f1_kernel` .. `_f4_kernel`
// (forward) and `_b1_kernel` .. `_b4_kernel` (backward).  One block
// (dilation d, K taps, C channels):
//   u = dwconv_d(x) + dw_b; s0 = a0 u + c0; v = s0 W1 + b1;
//   r = relu(a1 v + c1);   w = r W2 + b2;   y = relu(a2 w + c2 + x)
// with a*, c* the BN scales folded from this batch's statistics, which
// the host computes between passes from the sums these kernels return.
//
//   F1  x            -> Σu, Σu²                        (2C)
//   F2  x            -> Σv, Σv²                        (2C)
//   F3  x            -> r, w; Σw, Σw²                  (2C)
//   F4  w, x         -> y                              (elementwise)
//   B1  dy, w, x     -> Σg2, Σg2·ŵ                     (2C)
//   B2  dy, w, x, r  -> dW2 = rᵀ·dwg, db2, Σds1, Σds1·v̂ (C² + 3C)
//   B3  dy, w, x, r  -> dW1 = s0ᵀ·dv, db1, Σds0, Σds0·û (C² + 3C)
//   B4  dy, w, x, r  -> dx, dWd, dbd                   (KC + C)
// with g2 = dy·[a2 w + c2 + x > 0], dwg the exact-BN backward of bn2,
// ds1 = (dwg W2ᵀ)·[r > 0], dv the exact-BN backward of bn1, ds0 = dv W1ᵀ,
// du the exact-BN backward of bn0 and dx = g2 + Σ_tap du[t + (K-1-tap) d]
// w_tap.
//
// Bound on an H100 at B=512, T=198, C=64: F1, F4 and B1 stream
// (B, T, C) tensors and are bound by bytes (3.35 TB/s); F2, F3 and B3
// do 2-8 C² FMAs per frame and are bound by fp32 operations (67
// TFLOP/s, no tensor cores); B2 and B4 sit between.
//
// Design.  The TPU kernels walk the batch in order on one core and
// carry their sums in VMEM scratch.  Here the work unit is a tile of
// 64 consecutive frames of ONE utterance (so a causal halo never reads
// another utterance; frames before t = 0 are zero), and a persistent
// grid of about two blocks per SM walks the tiles with a grid stride.
// Each thread owns one channel and a strided set of the tile's rows;
// it keeps its per-channel sums and its share of a C x C weight
// gradient in registers, the block reduces them over its row groups in
// a fixed order and writes ONE partial per block, and a second small
// kernel sums the partials over the blocks in block order.  No float
// atomics: a result is bitwise the same from run to run.  The two C x C
// products of a tile are fp32 FMA loops from shared memory, as in
// fused_mdtc.cu; weights are kept with a row stride of C + 1 floats, so
// both W and Wᵀ are read without bank conflicts.  Rows past T are
// zeroed in the shared tiles and left out of every sum.  B4's dx needs
// du at later frames that another tile computes, so B4 writes du and
// dx = g2, and a third kernel adds the transposed depthwise taps.
// Tensor cores (wgmma), TMA and smaller working sets are left to later
// changes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxTaps = 8;

enum Pass { kF1 = 1, kF2, kF3, kF4, kB1, kB2, kB3, kB4 };

// rows of the packed per-channel vector (ops/fused_mdtc_train.py VEC_KEYS)
enum Vec {
  V_DWB, V_A0, V_C0, V_MU0, V_INV0, V_B1, V_A1, V_C1, V_MU1, V_INV1,
  V_COEF1, V_B2, V_A2, V_C2, V_MU2, V_INV2, V_COEF2, V_SG, V_SGW, V_SDS1,
  V_SDS1V, V_BETA1, V_GAMMA1, V_COEF0, V_SDS0, V_SDS0U, kNumVec
};

struct Args {
  const float* x;    // (B, T, C)
  const float* dy;   // (B, T, C)
  const float* w;    // (B, T, C), F3's output
  const float* r;    // (B, T, C), F3's output
  const float* dw;   // (K, C)
  const float* pw1;  // (C, C) [in][out]
  const float* pw2;  // (C, C) [in][out]
  const float* vec;  // (kNumVec, C)
  float* out_r;
  float* out_w;
  float* out_y;
  float* dx;
  float* du;
  float* partials;   // (gridDim.x, width)
  int B, T, K, d;
  float n;           // B * T
};

__device__ __forceinline__ float vc(const Args& a, int row, int C, int c) {
  return __ldg(a.vec + row * C + c);
}

// (C, C) row-major -> shared, row stride C + 1
template <int C>
__device__ __forceinline__ void load_padded(const float* __restrict__ g,
                                            float* s) {
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    s[(i / C) * (C + 1) + i % C] = g[i];
  }
}

// u at frame t of utterance xb for channel c (zero left context)
__device__ __forceinline__ float dwconv(const float* __restrict__ xb,
                                        const float* __restrict__ dw,
                                        float bias, int t, int K, int d,
                                        int C, int c) {
  float u = bias;
  for (int tap = 0; tap < K; ++tap) {
    const int ts = t - (K - 1 - tap) * d;
    if (ts >= 0) u = fmaf(__ldg(xb + static_cast<size_t>(ts) * C + c),
                          __ldg(dw + tap * C + c), u);
  }
  return u;
}

// acc[j] = Σ_k tile[row_j][k] * W[k][c]   (W padded, [in][out])
template <int C, int R, int G>
__device__ __forceinline__ void matmul_rows(const float* __restrict__ tile,
                                            const float* __restrict__ wp,
                                            int g, int c, float* acc) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  for (int k = 0; k < C; k += 4) {
    const float w0 = wp[(k + 0) * (C + 1) + c];
    const float w1 = wp[(k + 1) * (C + 1) + c];
    const float w2 = wp[(k + 2) * (C + 1) + c];
    const float w3 = wp[(k + 3) * (C + 1) + c];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 t4 =
          *reinterpret_cast<const float4*>(&tile[(g + j * G) * C + k]);
      acc[j] = fmaf(t4.x, w0, acc[j]);
      acc[j] = fmaf(t4.y, w1, acc[j]);
      acc[j] = fmaf(t4.z, w2, acc[j]);
      acc[j] = fmaf(t4.w, w3, acc[j]);
    }
  }
}

// acc[j] = Σ_o tile[row_j][o] * W[c][o]   (W padded: the product with Wᵀ)
template <int C, int R, int G>
__device__ __forceinline__ void matmul_rows_t(const float* __restrict__ tile,
                                              const float* __restrict__ wp,
                                              int g, int c, float* acc) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  const float* wr = wp + c * (C + 1);
  for (int o = 0; o < C; o += 4) {
    const float w0 = wr[o];
    const float w1 = wr[o + 1];
    const float w2 = wr[o + 2];
    const float w3 = wr[o + 3];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 t4 =
          *reinterpret_cast<const float4*>(&tile[(g + j * G) * C + o]);
      acc[j] = fmaf(t4.x, w0, acc[j]);
      acc[j] = fmaf(t4.y, w1, acc[j]);
      acc[j] = fmaf(t4.z, w2, acc[j]);
      acc[j] = fmaf(t4.w, w3, acc[j]);
    }
  }
}

// accw[m] += Σ_rows A[row][g + m G] * Gt[row][c]: this thread's entries
// (g + m G, c) of a C x C weight gradient Aᵀ·Gt
template <int C, int G>
__device__ __forceinline__ void outer_rows(const float* __restrict__ a_tile,
                                           const float* __restrict__ g_tile,
                                           int g, int c, float* accw) {
  constexpr int M = C / G;
  for (int row = 0; row < kTile; ++row) {
    const float gv = g_tile[row * C + c];
    const float* ar = a_tile + row * C + g;
#pragma unroll
    for (int m = 0; m < M; ++m) accw[m] = fmaf(ar[m * G], gv, accw[m]);
  }
}

// Reduce NS per-thread channel sums over the G row groups in a fixed
// order and write them as this block's partial (NS x C floats at
// `out`).  `red` holds G * NS * C floats.
template <int C, int NS>
__device__ __forceinline__ void block_sums(float* red, const float* s,
                                           float* out, int g, int c) {
  constexpr int G = kThreads / C;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS; ++i) red[(g * NS + i) * C + c] = s[i];
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float acc = 0.f;
      for (int gg = 0; gg < G; ++gg) acc += red[(gg * NS + i) * C + c];
      out[i * C + c] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: F1, F2, F3 share the prefix dw -> bn0 -> pw1 -> bn1 -> relu -> pw2
// ---------------------------------------------------------------------------

template <int C, int S>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  constexpr int G = kThreads / C;  // row groups
  constexpr int R = kTile / G;     // tile rows per thread
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w1 = sm;                                      // C x (C+1)
  float* w2 = w1 + (S >= kF2 ? C * (C + 1) : 0);       // C x (C+1)
  float* tile_a = w2 + (S == kF3 ? C * (C + 1) : 0);   // kTile x C
  float* tile_b = tile_a + kTile * C;                  // kTile x C
  float* red = tile_b + kTile * C;                     // G x 2 x C

  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  if (S >= kF2) load_padded<C>(a.pw1, w1);
  if (S == kF3) load_padded<C>(a.pw2, w2);
  const float dwb = vc(a, V_DWB, C, c);
  const float a0 = vc(a, V_A0, C, c), c0 = vc(a, V_C0, C, c);
  const float b1 = vc(a, V_B1, C, c);
  const float a1 = vc(a, V_A1, C, c), c1 = vc(a, V_C1, C, c);
  const float b2 = vc(a, V_B2, C, c);

  float sums[2] = {0.f, 0.f};
  const int tiles_per_utt = (a.T + kTile - 1) / kTile;
  const int n_tiles = a.B * tiles_per_utt;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_utt;
    const int t0 = (tile % tiles_per_utt) * kTile;
    const size_t base = static_cast<size_t>(b) * a.T * C;
    const float* xb = a.x + base;
    __syncthreads();  // the previous tile's shared reads are done
    float u[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      u[j] = t < a.T ? dwconv(xb, a.dw, dwb, t, a.K, a.d, C, c) : 0.f;
    }
    if (S == kF1) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (t0 + g + j * G < a.T) {
          sums[0] += u[j];
          sums[1] += u[j] * u[j];
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      tile_a[(g + j * G) * C + c] = t < a.T ? fmaf(u[j], a0, c0) : 0.f;
    }
    __syncthreads();
    float acc[R];
    matmul_rows<C, R, G>(tile_a, w1, g, c, acc);
    if (S == kF2) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (t0 + g + j * G < a.T) {
          const float v = acc[j] + b1;
          sums[0] += v;
          sums[1] += v * v;
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      const float rr = t < a.T ? fmaxf(fmaf(acc[j] + b1, a1, c1), 0.f) : 0.f;
      tile_b[(g + j * G) * C + c] = rr;
      if (t < a.T) a.out_r[base + static_cast<size_t>(t) * C + c] = rr;
    }
    __syncthreads();
    matmul_rows<C, R, G>(tile_b, w2, g, c, acc);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      if (t < a.T) {
        const float ww = acc[j] + b2;
        a.out_w[base + static_cast<size_t>(t) * C + c] = ww;
        sums[0] += ww;
        sums[1] += ww * ww;
      }
    }
  }
  block_sums<C, 2>(red, sums, a.partials + static_cast<size_t>(blockIdx.x) * 2 * C,
                   g, c);
}

// F4: y = relu(a2 w + c2 + x), elementwise
template <int C>
__global__ void __launch_bounds__(kThreads) f4_kernel(Args a, size_t total) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % C);
    const float s2 = a.w[i] * vc(a, V_A2, C, c) + vc(a, V_C2, C, c);
    a.out_y[i] = fmaxf(s2 + a.x[i], 0.f);
  }
}

// ---------------------------------------------------------------------------
// backward: B2, B3, B4 share the prefix g2 -> dwg -> dr -> ds1 (then
// recompute u, s0, v); B1 is its first reduction
// ---------------------------------------------------------------------------

template <int C, int S>
__global__ void __launch_bounds__(kThreads) bwd_kernel(Args a) {
  constexpr int G = kThreads / C;
  constexpr int R = kTile / G;
  constexpr int M = C / G;  // weight-gradient rows per thread
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w2 = sm;                                        // C x (C+1)
  float* w1 = w2 + (S >= kB2 ? C * (C + 1) : 0);         // C x (C+1)
  float* tile_a = w1 + (S >= kB3 ? C * (C + 1) : 0);     // kTile x C
  float* tile_b = tile_a + kTile * C;                    // kTile x C
  float* red = tile_b + kTile * C;                       // G x (kMaxTaps+1) x C

  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  if (S >= kB2) load_padded<C>(a.pw2, w2);
  if (S >= kB3) load_padded<C>(a.pw1, w1);
  const float n = a.n;
  const float a2 = vc(a, V_A2, C, c), c2 = vc(a, V_C2, C, c);
  const float mu2 = vc(a, V_MU2, C, c), inv2 = vc(a, V_INV2, C, c);
  const float coef2 = vc(a, V_COEF2, C, c);
  const float sg = vc(a, V_SG, C, c), sgw = vc(a, V_SGW, C, c);
  const float beta1 = vc(a, V_BETA1, C, c), gamma1 = vc(a, V_GAMMA1, C, c);
  const float dwb = vc(a, V_DWB, C, c);
  const float a0 = vc(a, V_A0, C, c), c0 = vc(a, V_C0, C, c);
  const float mu0 = vc(a, V_MU0, C, c), inv0 = vc(a, V_INV0, C, c);
  const float b1 = vc(a, V_B1, C, c);
  const float mu1 = vc(a, V_MU1, C, c), inv1 = vc(a, V_INV1, C, c);
  const float coef1 = vc(a, V_COEF1, C, c);
  const float sds1 = vc(a, V_SDS1, C, c), sds1v = vc(a, V_SDS1V, C, c);
  const float coef0 = vc(a, V_COEF0, C, c);
  const float sds0 = vc(a, V_SDS0, C, c), sds0u = vc(a, V_SDS0U, C, c);

  float sums[kMaxTaps + 1];
#pragma unroll
  for (int i = 0; i <= kMaxTaps; ++i) sums[i] = 0.f;
  float accw[M];
#pragma unroll
  for (int m = 0; m < M; ++m) accw[m] = 0.f;

  const int tiles_per_utt = (a.T + kTile - 1) / kTile;
  const int n_tiles = a.B * tiles_per_utt;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_utt;
    const int t0 = (tile % tiles_per_utt) * kTile;
    const size_t base = static_cast<size_t>(b) * a.T * C;
    const float* xb = a.x + base;
    __syncthreads();
    float g2[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = g + j * G;
      const int t = t0 + row;
      float dwg = 0.f;
      g2[j] = 0.f;
      if (t < a.T) {
        const size_t at = base + static_cast<size_t>(t) * C + c;
        const float wv = a.w[at];
        const float pre = wv * a2 + c2 + a.x[at];
        g2[j] = pre > 0.f ? a.dy[at] : 0.f;
        const float what = (wv - mu2) * inv2;
        if (S == kB1) {
          sums[0] += g2[j];
          sums[1] += g2[j] * what;
        } else {
          dwg = coef2 / n * (n * g2[j] - sg - what * sgw);
        }
        if (S == kB2) tile_b[row * C + c] = a.r[at];
      } else if (S == kB2) {
        tile_b[row * C + c] = 0.f;
      }
      if (S != kB1) tile_a[row * C + c] = dwg;
    }
    if (S == kB1) continue;
    __syncthreads();
    if (S == kB2) {
      outer_rows<C, G>(tile_b, tile_a, g, c, accw);  // dW2 += rᵀ·dwg
#pragma unroll
      for (int j = 0; j < R; ++j) sums[0] += tile_a[(g + j * G) * C + c];
    }
    float ds1[R];
    matmul_rows_t<C, R, G>(tile_a, w2, g, c, ds1);  // dr = dwg W2ᵀ
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      const float rv = t < a.T
          ? a.r[base + static_cast<size_t>(t) * C + c] : 0.f;
      ds1[j] = rv > 0.f ? ds1[j] : 0.f;
      if (S == kB2 && t < a.T) {
        sums[1] += ds1[j];
        sums[2] += ds1[j] * ((rv - beta1) / gamma1);
      }
    }
    if (S == kB2) continue;

    // B3, B4: recompute u, s0, v from x
    float uhat[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = g + j * G;
      const int t = t0 + row;
      float s0 = 0.f;
      uhat[j] = 0.f;
      if (t < a.T) {
        const float u = dwconv(xb, a.dw, dwb, t, a.K, a.d, C, c);
        s0 = fmaf(u, a0, c0);
        uhat[j] = (u - mu0) * inv0;
      }
      tile_b[row * C + c] = s0;
    }
    __syncthreads();  // s0 tile written; every dwg read is done
    float acc[R];
    matmul_rows<C, R, G>(tile_b, w1, g, c, acc);  // v = s0 W1 (+ b1)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = g + j * G;
      float dv = 0.f;
      if (t0 + row < a.T) {
        const float vhat = (acc[j] + b1 - mu1) * inv1;
        dv = coef1 / n * (n * ds1[j] - sds1 - vhat * sds1v);
      }
      tile_a[row * C + c] = dv;
    }
    __syncthreads();
    if (S == kB3) {
      outer_rows<C, G>(tile_b, tile_a, g, c, accw);  // dW1 += s0ᵀ·dv
#pragma unroll
      for (int j = 0; j < R; ++j) sums[0] += tile_a[(g + j * G) * C + c];
    }
    matmul_rows_t<C, R, G>(tile_a, w1, g, c, acc);  // ds0 = dv W1ᵀ
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      if (t >= a.T) continue;
      if (S == kB3) {
        sums[1] += acc[j];
        sums[2] += acc[j] * uhat[j];
      } else {  // B4
        const float du = coef0 / n * (n * acc[j] - sds0 - uhat[j] * sds0u);
        const size_t at = base + static_cast<size_t>(t) * C + c;
        a.du[at] = du;
        a.dx[at] = g2[j];
        sums[kMaxTaps] += du;
#pragma unroll
        for (int tap = 0; tap < kMaxTaps; ++tap) {
          if (tap < a.K) {
            const int ts = t - (a.K - 1 - tap) * a.d;
            if (ts >= 0) {
              sums[tap] = fmaf(du, xb[static_cast<size_t>(ts) * C + c],
                               sums[tap]);
            }
          }
        }
      }
    }
  }

  float* part = a.partials;
  if (S == kB1) {
    block_sums<C, 2>(red, sums, part + static_cast<size_t>(blockIdx.x) * 2 * C,
                     g, c);
  } else if (S == kB2 || S == kB3) {
    // this block's C x C gradient: entry (g + m G, c) belongs to this
    // thread alone, then the three channel sums
    float* out = part + static_cast<size_t>(blockIdx.x) * (C * C + 3 * C);
#pragma unroll
    for (int m = 0; m < M; ++m) out[(g + m * G) * C + c] = accw[m];
    block_sums<C, 3>(red, sums, out + C * C, g, c);
  } else {  // B4: dWd (K x C) then dbd, from K + 1 sums
    const int width = a.K * C + C;
    float* out = part + static_cast<size_t>(blockIdx.x) * width;
    __syncthreads();
#pragma unroll
    for (int i = 0; i <= kMaxTaps; ++i) {
      red[(g * (kMaxTaps + 1) + i) * C + c] = sums[i];
    }
    __syncthreads();
    if (g == 0) {
      for (int i = 0; i < a.K; ++i) {
        float acc = 0.f;
        for (int gg = 0; gg < G; ++gg) acc += red[(gg * (kMaxTaps + 1) + i) * C + c];
        out[i * C + c] = acc;
      }
      float acc = 0.f;
      for (int gg = 0; gg < G; ++gg) {
        acc += red[(gg * (kMaxTaps + 1) + kMaxTaps) * C + c];
      }
      out[a.K * C + c] = acc;
    }
  }
}

// dx[t] += Σ_tap du[t + (K-1-tap) d] w_tap  (the transpose of the
// causal depthwise conv; dx holds g2)
template <int C>
__global__ void __launch_bounds__(kThreads) dx_kernel(Args a, size_t total) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % C);
    const int t = static_cast<int>((i / C) % a.T);
    float acc = a.dx[i];
    for (int tap = 0; tap < a.K; ++tap) {
      const int s = (a.K - 1 - tap) * a.d;
      if (t + s < a.T) {
        acc = fmaf(a.du[i + static_cast<size_t>(s) * C], __ldg(a.dw + tap * C + c), acc);
      }
    }
    a.dx[i] = acc;
  }
}

// out[j] = Σ_b partials[b][j], blocks in order.  S, the pass whose
// partials these are, only names the kernel, so that a profile shows
// each pass's reduction apart.
template <int S>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partials, int n_blocks, int width,
              float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= width) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) {
    acc += partials[static_cast<size_t>(b) * width + j];
  }
  out[j] = acc;
}

template <typename Kern>
int launch_tiles(Kern kern, const Args& a, size_t smem, int n_blocks,
                 cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_reduce(const float* partials, int n_blocks, int width,
                  float* out, cudaStream_t s) {
  reduce_kernel<S><<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partials, n_blocks, width, out);
  return static_cast<int>(cudaGetLastError());
}

int elementwise_blocks(size_t total) {
  const size_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < 4096 ? want : 4096);
}

template <int C>
int run(int pass, const Args& a, int n_blocks, float* reduced,
        cudaStream_t s) {
  constexpr int G = kThreads / C;
  const size_t wsz = sizeof(float) * C * (C + 1);
  const size_t tiles = sizeof(float) * 2 * kTile * C;
  const size_t total = static_cast<size_t>(a.B) * a.T * C;
  int width = 0;
  int err = 0;
  switch (pass) {
    case kF1:
      err = launch_tiles(fwd_kernel<C, kF1>, a,
                         tiles + sizeof(float) * G * 2 * C, n_blocks, s);
      width = 2 * C;
      break;
    case kF2:
      err = launch_tiles(fwd_kernel<C, kF2>, a,
                         wsz + tiles + sizeof(float) * G * 2 * C, n_blocks, s);
      width = 2 * C;
      break;
    case kF3:
      err = launch_tiles(fwd_kernel<C, kF3>, a,
                         2 * wsz + tiles + sizeof(float) * G * 2 * C,
                         n_blocks, s);
      width = 2 * C;
      break;
    case kF4:
      f4_kernel<C><<<elementwise_blocks(total), kThreads, 0, s>>>(a, total);
      return static_cast<int>(cudaGetLastError());
    default: {
      const size_t red = sizeof(float) * G * (kMaxTaps + 1) * C;
      if (pass == kB1) {
        err = launch_tiles(bwd_kernel<C, kB1>, a, tiles + red, n_blocks, s);
        width = 2 * C;
      } else if (pass == kB2) {
        err = launch_tiles(bwd_kernel<C, kB2>, a, wsz + tiles + red,
                           n_blocks, s);
        width = C * C + 3 * C;
      } else if (pass == kB3) {
        err = launch_tiles(bwd_kernel<C, kB3>, a, 2 * wsz + tiles + red,
                           n_blocks, s);
        width = C * C + 3 * C;
      } else if (pass == kB4) {
        err = launch_tiles(bwd_kernel<C, kB4>, a, 2 * wsz + tiles + red,
                           n_blocks, s);
        width = a.K * C + C;
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  if (err != 0) return err;
  switch (pass) {
    case kF1: err = launch_reduce<kF1>(a.partials, n_blocks, width, reduced, s); break;
    case kF2: err = launch_reduce<kF2>(a.partials, n_blocks, width, reduced, s); break;
    case kF3: err = launch_reduce<kF3>(a.partials, n_blocks, width, reduced, s); break;
    case kB1: err = launch_reduce<kB1>(a.partials, n_blocks, width, reduced, s); break;
    case kB2: err = launch_reduce<kB2>(a.partials, n_blocks, width, reduced, s); break;
    case kB3: err = launch_reduce<kB3>(a.partials, n_blocks, width, reduced, s); break;
    default: err = launch_reduce<kB4>(a.partials, n_blocks, width, reduced, s); break;
  }
  if (err != 0 || pass != kB4) return err;
  dx_kernel<C><<<elementwise_blocks(total), kThreads, 0, s>>>(a, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One pass of the fused training block.  `ptrs` lists, in order: x, dy,
// w, r, dw (K, C), pw1, pw2, vec (kNumVec, C), out_r, out_w, out_y, dx,
// du (B, T, C scratch), partials (n_blocks, width), reduced (width);
// unused slots are null.  `dims` = {C, B, T, K, dilation, n_blocks}.
// Returns a cudaError_t code (0 on success).
int fused_train_launch(int pass, void* const* ptrs, const int* dims,
                       float n, void* stream) {
  const int C = dims[0];
  Args a;
  a.x = static_cast<const float*>(ptrs[0]);
  a.dy = static_cast<const float*>(ptrs[1]);
  a.w = static_cast<const float*>(ptrs[2]);
  a.r = static_cast<const float*>(ptrs[3]);
  a.dw = static_cast<const float*>(ptrs[4]);
  a.pw1 = static_cast<const float*>(ptrs[5]);
  a.pw2 = static_cast<const float*>(ptrs[6]);
  a.vec = static_cast<const float*>(ptrs[7]);
  a.out_r = static_cast<float*>(ptrs[8]);
  a.out_w = static_cast<float*>(ptrs[9]);
  a.out_y = static_cast<float*>(ptrs[10]);
  a.dx = static_cast<float*>(ptrs[11]);
  a.du = static_cast<float*>(ptrs[12]);
  a.partials = static_cast<float*>(ptrs[13]);
  float* reduced = static_cast<float*>(ptrs[14]);
  a.B = dims[1];
  a.T = dims[2];
  a.K = dims[3];
  a.d = dims[4];
  a.n = n;
  const int n_blocks = dims[5];
  if (a.B < 1 || a.T < 1 || a.K < 1 || a.K > kMaxTaps || a.d < 1 ||
      n_blocks < 1 || pass < kF1 || pass > kB4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return run<32>(pass, a, n_blocks, reduced, s);
    case 64: return run<64>(pass, a, n_blocks, reduced, s);
    case 128: return run<128>(pass, a, n_blocks, reduced, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
