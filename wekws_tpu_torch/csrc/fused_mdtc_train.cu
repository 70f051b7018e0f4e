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
//   F1  x             -> Σu, Σu²                        (2C)
//   F2  x             -> Σv, Σv²                        (2C)
//   F3  x             -> r, w; Σw, Σw²                  (2C)
//   F4  w, x          -> y                              (elementwise)
//   B1  dy, w, x      -> Σg2, Σg2·ŵ                     (2C)
//   B2  dy, w, x, r   -> dW2 = rᵀ·dwg, db2, Σds1, Σds1·v̂ (C² + 3C)
//   B3  dy, w, x, r   -> dW1 = s0ᵀ·dv, db1, Σds0, Σds0·û (C² + 3C); ds0
//   B4  dy, w, x, ds0 -> dx, dWd, dbd                   (KC + C)
// with g2 = dy·[a2 w + c2 + x > 0], dwg the exact-BN backward of bn2,
// ds1 = (dwg W2ᵀ)·[r > 0], dv the exact-BN backward of bn1, ds0 = dv W1ᵀ,
// du the exact-BN backward of bn0 and dx = g2 + Σ_tap du[t + (K-1-tap) d]
// w_tap.
//
// Bound on an H100 at B=512, T=198, C=64: F1, F4, B1, B2, B3 and B4
// stream (B, T, C) tensors and are bound by bytes (3.35 TB/s); F2 and
// F3 do 2-4 C² FMAs per frame in fp32 (67 TFLOP/s) and are bound by
// operations; B3 runs its products on the tensor cores.
//
// Design.  The TPU kernels walk the batch in order on one core and
// carry their sums in VMEM scratch.  Here a persistent grid of at most
// two blocks per SM walks tiles with a grid stride; each block keeps
// its sums (and its share of a C x C weight gradient) in registers,
// reduces them over its threads in a fixed order and writes ONE
// partial, and a second small kernel sums the partials over the blocks
// in block order.  No float atomics: a result is bitwise the same from
// run to run.  Rows past the end are left out of every sum and output,
// and zeroed in the tiles that a weight gradient sums over.
//
// F1, F2, B1: a tile is 64 consecutive frames of ONE utterance (so a
// causal halo never reads another utterance; frames before t = 0 are
// zero).  Each thread owns one channel and a strided set of the tile's
// rows; F2's product is an fp32 FMA loop from shared memory, with the
// weights at a row stride of C + 1 floats.
//
// F3 and B2 take B3's tiles (below) over the flattened frames and its
// float4 elementwise steps, with fp32 products: a thread forms the four
// channels of its own R rows of a product in registers (float4 loads of
// a row of the input tile and of four rows of W, 64 FMAs per eight
// 16-byte shared loads at C = 64), so the product's output never goes
// through shared memory and the elementwise step that follows reads it
// where it is.  F3: conv and s0 into a tile, v = s0 W1 -> r, written and
// into the second tile, w = r W2 written, Σw and Σw².  B2: dwg and r
// into two tiles (r read once, kept in registers for the mask and v̂),
// dr = dwg W2ᵀ (W2 stored transposed) -> ds1 and its sums, and dW2 +=
// rᵀ dwg with each thread's (C / G) x 4 block of dW2 in registers across
// a block's tiles.  While a tile's products run, 16-byte `cp.async`
// copies bring the next tile's inputs into shared memory: F3's window
// of x (the tile's rows and the causal halo (K-1) d before them, zero
// before frame 0; where it does not fit beside the rest, a halo over
// 538 frames at C = 64 or 58 at C = 128, the taps are read from device
// memory), B2's rows of w, x and dy (r is read directly: a fourth
// staged input would leave one block per SM).  B3's three TF32 passes
// on the tensor cores were slower here (F3) or as fast with ten times
// the error (B2).

// B3 and B4 are cut for this card, not as the TPU kernels are.  There
// B4 recomputes all of B3 (three C x C products per frame) to save one
// tensor of device-memory traffic; here B3 writes ds0, which it holds
// anyway, and B4 reads it: 26 MB more each way at the main shape, under
// 0.02 ms, against 2.5 GFLOP.  g2 is not handed over: B4 recomputes it
// from dy, w and x, which moves the same bytes as reading it.
//
// B3: 64-row tiles (32 at C = 128, where two padded weight matrices
// leave room for no more) over the FLATTENED B x T frames, so no tile
// is ragged but the last; only the depthwise conv looks at where an
// utterance starts.  Its four products (dr = dwg W2ᵀ, v = s0 W1,
// dW1 += s0ᵀ dv, ds0 = dv W1ᵀ) run on the tensor cores: `nvcuda::wmma`
// m16n16k8 TF32 fragments, each operand split in registers into
// hi = a cut to TF32 and lo = tf32(a - hi) (integer operations: the
// conversion instruction is too slow) and each product taken as
// lo·hi + hi·lo + hi·hi in fp32 accumulators, which keeps the error at
// the fp32 level (one TF32 pass keeps three digits and would break the
// 1e-4 bound on ds0).  `row_major` / `col_major` fragments read Wᵀ and
// s0ᵀ in place.  A warp owns the output fragments of one column block,
// so one fragment of W serves them all.  A product's result goes to a
// shared tile, and the elementwise steps that need per-channel constants
// (g2 and dwg, the conv, the ReLU mask, v̂, dv, the sums) run on the
// tiles with a thread owning four neighbouring channels of a strided
// set of rows: 16-byte loads, stores and shared traffic, the constants
// and the taps waiting in shared memory.  (With one channel a thread,
// as in F1, F2 and B1, these steps alone took longer than the four
// products: the pass is bound by instruction count, at 16 warps an
// SM.)  The dW1 accumulator fragments stay in registers across a
// block's tiles.  Tiles and weights have a row stride of C + 4 floats:
// wmma needs a multiple of 4, and with C + 4 the row-major A and
// col-major B fragment loads (lane -> 4 row + col) touch 32 different
// banks; the col-major A load of s0ᵀ and the row-major B loads (W1 in
// v, dv in dW1) are two-way conflicted.  The products wait for their
// operands (four 4-byte loads and twelve operations of the split a
// fragment), not for the tensor cores, so wgmma and TMA are not used;
// B3's four products leave no shared memory for operands split once
// where they are written, at two blocks per SM.
//
// B4 has no product.  du is elementwise in (ds0, û), so the later
// frames' du that dx needs are recomputed from a halo instead of read
// from another tile's output (the former du tensor and third kernel
// are gone).  An utterance is cut into equal tiles of at most 64 rows
// (T = 198: 50, 50, 50, 48).  A block stages x rows [t0 - H, t0 + rows
// + H), ds0 rows [t0, t0 + rows + H), H = (K-1) d, and the tile's dy
// and w rows in shared memory with 16-byte `cp.async` copies (zero
// fill before frame 0 and past frame T-1), in two groups so that dy
// and w arrive while u, û and du are formed for the rows plus the
// forward halo (du overwrites ds0 in place; dWd and dbd sum the tile's
// own rows only); then it writes dx once.  A thread owns four
// neighbouring channels of a strided set of rows.  The second block of
// an SM loads while the first computes.

#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

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
  float* ds0;        // (B, T, C): B3 writes it, B4 reads it
  float* partials;   // (gridDim.x, width)
  int B, T, K, d;
  float n;           // B * T
};

__device__ __forceinline__ float vc(const Args& a, int row, int C, int c) {
  return __ldg(a.vec + row * C + c);
}

// (C, C) row-major -> shared, row stride LD
template <int C, int LD = C + 1>
__device__ __forceinline__ void load_padded(const float* __restrict__ g,
                                            float* s) {
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    s[(i / C) * LD + i % C] = g[i];
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
// forward: F1 and F2 share the prefix dw -> bn0 -> pw1 (F3: f3_kernel)
// ---------------------------------------------------------------------------

template <int C, int S>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  constexpr int G = kThreads / C;  // row groups
  constexpr int R = kTile / G;     // tile rows per thread
  extern __shared__ __align__(128) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w1 = sm;                                      // C x (C+1)
  float* tile_a = w1 + (S == kF2 ? C * (C + 1) : 0);   // kTile x C
  float* red = tile_a + kTile * C;                     // G x 2 x C

  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  if (S == kF2) load_padded<C>(a.pw1, w1);
  const float dwb = vc(a, V_DWB, C, c);
  const float a0 = vc(a, V_A0, C, c), c0 = vc(a, V_C0, C, c);
  const float b1 = vc(a, V_B1, C, c);

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
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (t0 + g + j * G < a.T) {
        const float v = acc[j] + b1;
        sums[0] += v;
        sums[1] += v * v;
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
// backward: B1, the bn2 gradient sums of g2 (B2: b2_kernel)
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads) b1_kernel(Args a) {
  constexpr int G = kThreads / C;
  constexpr int R = kTile / G;
  extern __shared__ __align__(128) float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // G x 2 x C

  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  const float a2 = vc(a, V_A2, C, c), c2 = vc(a, V_C2, C, c);
  const float mu2 = vc(a, V_MU2, C, c), inv2 = vc(a, V_INV2, C, c);

  float sums[2] = {0.f, 0.f};
  const int tiles_per_utt = (a.T + kTile - 1) / kTile;
  const int n_tiles = a.B * tiles_per_utt;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_utt;
    const int t0 = (tile % tiles_per_utt) * kTile;
    const size_t base = static_cast<size_t>(b) * a.T * C;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + g + j * G;
      if (t < a.T) {
        const size_t at = base + static_cast<size_t>(t) * C + c;
        const float wv = a.w[at];
        const float pre = wv * a2 + c2 + a.x[at];
        const float g2 = pre > 0.f ? a.dy[at] : 0.f;
        sums[0] += g2;
        sums[1] += g2 * ((wv - mu2) * inv2);
      }
    }
  }
  block_sums<C, 2>(red, sums,
                   a.partials + static_cast<size_t>(blockIdx.x) * 2 * C, g, c);
}

// ---------------------------------------------------------------------------
// B3 on the tensor cores: TF32 fragments, each product in three passes
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;

constexpr int kWarps = kThreads / 32;
using FragAcc = wm::fragment<wm::accumulator, 16, 16, 8, float>;
template <typename Layout>
using FragA = wm::fragment<wm::matrix_a, 16, 16, 8, wm::precision::tf32, Layout>;
template <typename Layout>
using FragB = wm::fragment<wm::matrix_b, 16, 16, 8, wm::precision::tf32, Layout>;

// hi holds fp32 values on entry.  hi = a cut to TF32's 10 mantissa bits
// (the tensor cores read only those of an operand), lo = a - hi, exact
// in fp32, rounded to TF32 by adding half an ulp before the hardware
// cuts it: a - hi - lo is under 2^-21 |a|.  Integer operations, because
// the conversion instruction runs at a fraction of their rate.
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float v = hi.x[i];
    const float h = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
    hi.x[i] = h;
    lo.x[i] = __uint_as_float(__float_as_uint(v - h) + 0x1000u);
  }
}

// acc += a · b as lo·hi + hi·lo + hi·hi: the small terms first
template <typename FA, typename FB>
__device__ __forceinline__ void mma_3x(FragAcc& acc, const FA& ah,
                                       const FA& al, const FB& bh,
                                       const FB& bl) {
  wm::mma_sync(acc, al, bh, acc);
  wm::mma_sync(acc, ah, bl, acc);
  wm::mma_sync(acc, ah, bh, acc);
}

// out (ROWS x C) = in (ROWS x C) · W (TRANS = false) or · Wᵀ (TRANS =
// true), W as [in][out]; all three in shared memory at row stride C + 4.
// A warp owns the 16 x 16 output fragments of one column block, so one
// fragment of W, loaded and split once, serves all of them, and their
// accumulators are independent chains for the tensor cores.
template <int C, int ROWS, bool TRANS>
__device__ __forceinline__ void tile_product(const float* in, const float* w,
                                             float* out, int warp) {
  constexpr int LD = C + 4;
  constexpr int NF = C / 16;
  constexpr int PER = (ROWS / 16) * NF / kWarps;  // fragments of a warp
  constexpr int M_STEP = (kWarps / NF) * 16;      // rows between them
  static_assert((ROWS / 16) * NF % kWarps == 0 && kWarps % NF == 0,
                "the output fragments do not deal out evenly");
  using LB = typename std::conditional<TRANS, wm::col_major,
                                       wm::row_major>::type;
  const int n0 = (warp % NF) * 16;
  const float* a = in + (warp / NF) * 16 * LD;
  // Wᵀ: element (k, n) is W[n][k], a col-major fragment of W
  const float* b = TRANS ? w + n0 * LD : w + n0;
  FragAcc acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) wm::fill_fragment(acc[j], 0.f);
#pragma unroll 2
  for (int k = 0; k < C; k += 8) {
    FragB<LB> bh, bl;
    wm::load_matrix_sync(bh, b + (TRANS ? k : k * LD), LD);
    split_tf32(bh, bl);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      FragA<wm::row_major> ah, al;
      wm::load_matrix_sync(ah, a + j * M_STEP * LD + k, LD);
      split_tf32(ah, al);
      mma_3x(acc[j], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    wm::store_matrix_sync(out + ((warp / NF) * 16 + j * M_STEP) * LD + n0,
                          acc[j], LD, wm::mem_row_major);
  }
}

// tiles over the flattened B x T frames (F3, B2, B3)
template <int C>
struct TileShape {
  static constexpr int kRows = C == 128 ? 32 : 64;  // rows of a tile
  static constexpr int kLd = C + 4;
  static constexpr int kFrags = (C / 16) * (C / 16);  // of B3's dW1
  // per warp: fragment j of warp w is number w + j kWarps; at C = 32
  // there are four fragments and warps 4-7 own none
  static constexpr int kOwn = (kFrags + kWarps - 1) / kWarps;
  static constexpr int kQuads = C / 4;                // float4s of a row
  static constexpr int kGroups = kThreads / kQuads;   // row groups
};

// the per-channel vector and the taps, two padded weight matrices, four
// tiles (the block's reduction reuses the first two)
template <int C>
constexpr size_t b3_smem_bytes() {
  using S = TileShape<C>;
  return sizeof(float) * ((kNumVec + kMaxTaps) * C + 2 * C * S::kLd +
                          4 * S::kRows * S::kLd);
}

// the per-channel vector and the taps, W1 and W2, two tiles
template <int C>
constexpr size_t f3_smem_bytes() {
  using S = TileShape<C>;
  return sizeof(float) * ((kNumVec + kMaxTaps) * C + 2 * C * S::kLd +
                          2 * S::kRows * S::kLd);
}

// the per-channel vector, W2ᵀ, two tiles, then the next tile's w, x and
// dy rows, staged
template <int C>
constexpr size_t b2_smem_bytes() {
  using S = TileShape<C>;
  return sizeof(float) * (kNumVec * C + C * S::kLd + 2 * S::kRows * S::kLd +
                          3 * S::kRows * C);
}

// The packed per-channel vector into shared memory, with k = coef / n
// in the two coef rows and 1 / gamma1 in the gamma1 row; then, where
// the pass has the conv, the taps (zero past K).
template <int C, bool TAPS>
__device__ __forceinline__ void load_consts(const Args& a, float* cv) {
  for (int i = threadIdx.x; i < kNumVec * C; i += kThreads) {
    const float v = __ldg(a.vec + i);
    const int row = i / C;
    cv[i] = row == V_COEF1 || row == V_COEF2 ? v / a.n
          : row == V_GAMMA1                  ? 1.f / v
                                             : v;
  }
  if (TAPS) {
    for (int i = threadIdx.x; i < kMaxTaps * C; i += kThreads) {
      cv[kNumVec * C + i] = i < a.K * C ? __ldg(a.dw + i) : 0.f;
    }
  }
}

// NS channel sums, a float4 of four channels in each thread of row group
// g, added over the row groups in order through `red` (G x NS x C
// floats) and written to `out` (NS x C)
template <int C, int NS>
__device__ __forceinline__ void block_sums4(float* red, const float4* sums,
                                            float* out, int g, int q) {
  constexpr int Q = C / 4;
  constexpr int G = kThreads / Q;
  float4* red4 = reinterpret_cast<float4*>(red);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS; ++i) red4[(g * NS + i) * Q + q] = sums[i];
  __syncthreads();
  for (int o = threadIdx.x; o < NS * C; o += kThreads) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += red[(gg * NS + o / C) * C + o % C];
    out[o] = acc;
  }
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

// exact-BN backward of one layer: k (n g - sg - hat sgh), k = coef / n
__device__ __forceinline__ float bn_back(float k, float n, float g, float sg,
                                         float hat, float sgh) {
  return k * (n * g - sg - hat * sgh);
}

__device__ __forceinline__ float4 bn_back4(float4 k, float n, float4 g,
                                           float4 sg, float4 hat,
                                           float4 sgh) {
  return make_float4(bn_back(k.x, n, g.x, sg.x, hat.x, sgh.x),
                     bn_back(k.y, n, g.y, sg.y, hat.y, sgh.y),
                     bn_back(k.z, n, g.z, sg.z, hat.z, sgh.z),
                     bn_back(k.w, n, g.w, sg.w, hat.w, sgh.w));
}

// (v - mu) inv
__device__ __forceinline__ float4 hat4(float4 v, float4 mu, float4 inv) {
  return make_float4((v.x - mu.x) * inv.x, (v.y - mu.y) * inv.y,
                     (v.z - mu.z) * inv.z, (v.w - mu.w) * inv.w);
}

// g where gate > 0, else 0
__device__ __forceinline__ float4 gate4(float4 gate, float4 g) {
  return make_float4(gate.x > 0.f ? g.x : 0.f, gate.y > 0.f ? g.y : 0.f,
                     gate.z > 0.f ? g.z : 0.f, gate.w > 0.f ? g.w : 0.f);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
b3_kernel(Args a) {
  using S = TileShape<C>;
  constexpr int ROWS = S::kRows;
  constexpr int LD = S::kLd;
  constexpr int LQ = LD / 4;  // float4s of a tile row
  constexpr int Q = S::kQuads;
  constexpr int G = S::kGroups;
  constexpr int R = ROWS / G;  // rows of a thread: 2 or 4
  constexpr int NF = C / 16;
  static_assert(ROWS % G == 0 && LD % 4 == 0, "float4 rows");
  extern __shared__ __align__(128) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cv = sm;                        // kNumVec x C, then kMaxTaps x C
  float* w2 = cv + (kNumVec + kMaxTaps) * C;  // C x LD
  float* w1 = w2 + C * LD;         // C x LD
  float* ta = w1 + C * LD;         // ROWS x LD: dwg, then v, then dv
  float* tb = ta + ROWS * LD;      // ROWS x LD: s0
  float* td = tb + ROWS * LD;      // ROWS x LD: dr, then ds0
  float* tu = td + ROWS * LD;      // ROWS x LD: û
  float4* ta4 = reinterpret_cast<float4*>(ta);
  float4* tb4 = reinterpret_cast<float4*>(tb);
  float4* td4 = reinterpret_cast<float4*>(td);
  float4* tu4 = reinterpret_cast<float4*>(tu);

  // The elementwise steps: a thread owns four neighbouring channels
  // (one float4) of R rows, so a load, a store and an address serve
  // four values.  The per-channel constants wait in shared memory.
  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  const int warp = threadIdx.x / 32;
  const float n = a.n;
  load_consts<C, true>(a, cv);
  load_padded<C, LD>(a.pw2, w2);
  load_padded<C, LD>(a.pw1, w1);
  const float4* cv4 = reinterpret_cast<const float4*>(cv) + q;
#define VEC4(row) cv4[(row) * Q]
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* dy4 = reinterpret_cast<const float4*>(a.dy);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4* r4 = reinterpret_cast<const float4*>(a.r);
  float4* ds04 = reinterpret_cast<float4*>(a.ds0);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 sums[3] = {zero4, zero4, zero4};  // Σdv, Σds0, Σds0·û
  FragAcc accw[S::kOwn];                   // this warp's fragments of dW1
#pragma unroll
  for (int j = 0; j < S::kOwn; ++j) wm::fill_fragment(accw[j], 0.f);

  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    __syncthreads();  // the previous tile's shared reads are done (and,
                      // the first time, the constants are in place)
    float4 rv[R];  // r, for the ReLU mask after two products
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lr = g + j * G;
      const int row = row0 + lr;
      float4 dwg = zero4, s0 = zero4, uhat = zero4;
      rv[j] = zero4;
      if (row < n_rows) {
        // every load of the row is started, through the read-only path,
        // before the first value is used
        const size_t at = static_cast<size_t>(row) * Q + q;
        const float4 wv = __ldg(w4 + at);
        const float4 xv = __ldg(x4 + at);
        const float4 dyv = __ldg(dy4 + at);
        rv[j] = __ldg(r4 + at);
        const int t = row % a.T;  // the conv alone cares where t = 0 is
        float4 xt[kMaxTaps];
#pragma unroll
        for (int tap = 0; tap < kMaxTaps; ++tap) {
          const int back = (a.K - 1 - tap) * a.d;
          xt[tap] = tap < a.K && back <= t
              ? __ldg(x4 + at - static_cast<size_t>(back) * Q) : zero4;
        }
        const float4 pre = fma4(wv, VEC4(V_A2), VEC4(V_C2));
        const float4 g2 = gate4(make_float4(pre.x + xv.x, pre.y + xv.y,
                                            pre.z + xv.z, pre.w + xv.w), dyv);
        dwg = bn_back4(VEC4(V_COEF2), n, g2, VEC4(V_SG),
                       hat4(wv, VEC4(V_MU2), VEC4(V_INV2)), VEC4(V_SGW));
        float4 u = VEC4(V_DWB);
#pragma unroll
        for (int tap = 0; tap < kMaxTaps; ++tap) {
          if (tap < a.K) u = fma4(xt[tap], VEC4(kNumVec + tap), u);
        }
        s0 = fma4(u, VEC4(V_A0), VEC4(V_C0));
        uhat = hat4(u, VEC4(V_MU0), VEC4(V_INV0));
      }
      ta4[lr * LQ + q] = dwg;
      tb4[lr * LQ + q] = s0;
      tu4[lr * LQ + q] = uhat;
    }
    __syncthreads();
    tile_product<C, ROWS, true>(ta, w2, td, warp);   // dr = dwg W2ᵀ
    __syncthreads();  // every read of dwg is done
    tile_product<C, ROWS, false>(tb, w1, ta, warp);  // v = s0 W1
    __syncthreads();
    {
      const float4 b1 = VEC4(V_B1), mu1 = VEC4(V_MU1), inv1 = VEC4(V_INV1);
      const float4 k1 = VEC4(V_COEF1), sds1 = VEC4(V_SDS1);
      const float4 sds1v = VEC4(V_SDS1V);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int lr = g + j * G;
        float4 dv = zero4;
        if (row0 + lr < n_rows) {
          const float4 ds1 = gate4(rv[j], td4[lr * LQ + q]);
          const float4 v = ta4[lr * LQ + q];
          const float4 vhat = hat4(make_float4(v.x + b1.x, v.y + b1.y,
                                               v.z + b1.z, v.w + b1.w),
                                   mu1, inv1);
          dv = bn_back4(k1, n, ds1, sds1, vhat, sds1v);
          sums[0].x += dv.x;
          sums[0].y += dv.y;
          sums[0].z += dv.z;
          sums[0].w += dv.w;
        }
        ta4[lr * LQ + q] = dv;
      }
    }
    __syncthreads();
    if (warp < S::kFrags) {  // dW1 += s0ᵀ·dv
      // this warp's fragments share the column block warp % NF of dv;
      // s0ᵀ: element (m, k) is s0[k][m], a col-major fragment of s0
      for (int k = 0; k < ROWS; k += 8) {
        FragB<wm::row_major> bh, bl;
        wm::load_matrix_sync(bh, ta + k * LD + (warp % NF) * 16, LD);
        split_tf32(bh, bl);
#pragma unroll
        for (int j = 0; j < S::kOwn; ++j) {
          FragA<wm::col_major> ah, al;
          wm::load_matrix_sync(
              ah, tb + k * LD + ((warp + j * kWarps) / NF) * 16, LD);
          split_tf32(ah, al);
          mma_3x(accw[j], ah, al, bh, bl);
        }
      }
    }
    tile_product<C, ROWS, true>(ta, w1, td, warp);   // ds0 = dv W1ᵀ
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lr = g + j * G;
      const int row = row0 + lr;
      if (row < n_rows) {
        const float4 ds0 = td4[lr * LQ + q];
        sums[1].x += ds0.x;
        sums[1].y += ds0.y;
        sums[1].z += ds0.z;
        sums[1].w += ds0.w;
        sums[2] = fma4(ds0, tu4[lr * LQ + q], sums[2]);
        ds04[static_cast<size_t>(row) * Q + q] = ds0;
      }
    }
  }
#undef VEC4

  float* out = a.partials + static_cast<size_t>(blockIdx.x) * (C * C + 3 * C);
#pragma unroll
  for (int j = 0; j < S::kOwn; ++j) {
    const int f = warp + j * kWarps;
    if (f < S::kFrags) {
      wm::store_matrix_sync(out + (f / NF) * 16 * C + (f % NF) * 16, accw[j],
                            C, wm::mem_row_major);
    }
  }
  // the three channel sums, through the first two tiles
  static_assert(G * 3 * C <= 2 * ROWS * LD, "the reduction fits two tiles");
  block_sums4<C, 3>(ta, sums, out + C * C, g, q);
}

// ---------------------------------------------------------------------------
// F3 and B2 with fp32 register-blocked products
// ---------------------------------------------------------------------------

constexpr size_t kSmemLimit = 232448;  // bytes a block may take on sm_90

// 16 bytes global -> shared without passing through registers; zeros
// where `valid` is false (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// c + s b, four lanes
__device__ __forceinline__ float4 fma4s(float s, float4 b, float4 c) {
  return make_float4(fmaf(s, b.x, c.x), fmaf(s, b.y, c.y), fmaf(s, b.z, c.z),
                     fmaf(s, b.w, c.w));
}

// acc[j] = Σ_k in[g + j G][k] W[k][4q .. 4q + 3]: the outputs at this
// thread's own rows and channels of the elementwise steps, so they stay
// in registers; in and W in shared memory at row stride C + 4
template <int C, int R>
__device__ __forceinline__ void rows_product(const float* in, const float* w,
                                             int g, int q, float4 (&acc)[R]) {
  constexpr int LD = C + 4;
  constexpr int G = TileShape<C>::kGroups;
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int k = 0; k < C; k += 4) {
    float4 wk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wk[i] = *reinterpret_cast<const float4*>(w + (k + i) * LD + 4 * q);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 av =
          *reinterpret_cast<const float4*>(in + (g + j * G) * LD + k);
      acc[j] = fma4s(av.x, wk[0], acc[j]);
      acc[j] = fma4s(av.y, wk[1], acc[j]);
      acc[j] = fma4s(av.z, wk[2], acc[j]);
      acc[j] = fma4s(av.w, wk[3], acc[j]);
    }
  }
}

// acc[i] += Σ_rows A[row][MB g + i] B[row][4q .. 4q + 3], MB = C / G:
// this thread's MB x 4 block of a C x C weight gradient Aᵀ·B
template <int C, int ROWS, int MB>
__device__ __forceinline__ void rows_outer(const float* at, const float* bt,
                                           int g, int q, float4 (&acc)[MB]) {
  constexpr int LD = C + 4;
#pragma unroll 4
  for (int k = 0; k < ROWS; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(bt + k * LD + 4 * q);
    const float* ar = at + k * LD + MB * g;
    if constexpr (MB % 4 == 0) {
#pragma unroll
      for (int i = 0; i < MB; i += 4) {
        const float4 av = *reinterpret_cast<const float4*>(ar + i);
        acc[i] = fma4s(av.x, bv, acc[i]);
        acc[i + 1] = fma4s(av.y, bv, acc[i + 1]);
        acc[i + 2] = fma4s(av.z, bv, acc[i + 2]);
        acc[i + 3] = fma4s(av.w, bv, acc[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < MB; ++i) acc[i] = fma4s(ar[i], bv, acc[i]);
    }
  }
}

// F3's window of x: the tile's rows and the causal halo H = (K-1) d
// before them
template <int C>
size_t f3_window_bytes(int halo) {
  return sizeof(float) * C * (TileShape<C>::kRows + halo);
}

// rows [first, first + count) of a (n_rows, Q) float4 tensor into
// shared memory by 16-byte `cp.async` copies, zeros outside the tensor
template <int Q>
__device__ __forceinline__ void stage_rows(float4* dst, const float4* src,
                                           int first, int count,
                                           int n_rows) {
  for (int i = threadIdx.x; i < count * Q; i += kThreads) {
    const int row = first + i / Q;
    const bool ok = row >= 0 && row < n_rows;
    cp_async16(dst + i, src + (ok ? static_cast<size_t>(row) * Q + i % Q : 0),
               ok);
  }
  cp_async_commit();
}

// staged: the window of the block's next tile is copied into shared
// memory while this tile's products run (where it fits beside the rest:
// run()), else the taps are read from device memory
template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
f3_kernel(Args a, bool staged) {
  using S = TileShape<C>;
  constexpr int ROWS = S::kRows;
  constexpr int LD = S::kLd;
  constexpr int LQ = LD / 4;
  constexpr int Q = S::kQuads;
  constexpr int G = S::kGroups;
  constexpr int R = ROWS / G;
  extern __shared__ __align__(128) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cv = sm;                             // kNumVec x C, then the taps
  float* w1 = cv + (kNumVec + kMaxTaps) * C;  // C x LD
  float* w2 = w1 + C * LD;                    // C x LD
  float* ta = w2 + C * LD;                    // ROWS x LD: s0
  float* tb = ta + ROWS * LD;                 // ROWS x LD: r
  float4* ta4 = reinterpret_cast<float4*>(ta);
  float4* tb4 = reinterpret_cast<float4*>(tb);
  float4* xs4 = tb4 + ROWS * LQ;              // (ROWS + H) x Q: x, staged

  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  load_consts<C, true>(a, cv);
  load_padded<C, LD>(a.pw1, w1);
  load_padded<C, LD>(a.pw2, w2);
  const float4* cv4 = reinterpret_cast<const float4*>(cv) + q;
#define VEC4(row) cv4[(row) * Q]
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float4* r4 = reinterpret_cast<float4*>(a.out_r);
  float4* w4 = reinterpret_cast<float4*>(a.out_w);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 sums[2] = {zero4, zero4};  // Σw, Σw²
  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  const int H = (a.K - 1) * a.d;
  if (staged && blockIdx.x < n_tiles) {
    stage_rows<Q>(xs4, x4, blockIdx.x * ROWS - H, ROWS + H, n_rows);
  }
  __syncthreads();  // the constants and the weights are in place
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    if (staged) {
      cp_async_wait<0>();
      __syncthreads();  // every thread's copies of the window have landed
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lr = g + j * G;
      const int row = row0 + lr;
      float4 s0 = zero4;
      if (row < n_rows) {
        const size_t at = static_cast<size_t>(row) * Q + q;
        // a tap before the utterance's first frame is zero, so a tile
        // that spans two utterances never reads the earlier one
        const int t = row % a.T;
        float4 xt[kMaxTaps];
#pragma unroll
        for (int tap = 0; tap < kMaxTaps; ++tap) {
          const int back = (a.K - 1 - tap) * a.d;
          xt[tap] = tap >= a.K || back > t ? zero4
              : staged ? xs4[(lr + H - back) * Q + q]
                       : __ldg(x4 + at - static_cast<size_t>(back) * Q);
        }
        float4 u = VEC4(V_DWB);
#pragma unroll
        for (int tap = 0; tap < kMaxTaps; ++tap) {
          if (tap < a.K) u = fma4(xt[tap], VEC4(kNumVec + tap), u);
        }
        s0 = fma4(u, VEC4(V_A0), VEC4(V_C0));
      }
      ta4[lr * LQ + q] = s0;
    }
    __syncthreads();  // s0 is in place and the window is read
    if (staged && tile + gridDim.x < n_tiles) {
      stage_rows<Q>(xs4, x4, (tile + gridDim.x) * ROWS - H, ROWS + H, n_rows);
    }
    float4 acc[R];
    rows_product<C, R>(ta, w1, g, q, acc);  // v - b1 = s0 W1
    {
      const float4 b1 = VEC4(V_B1), a1 = VEC4(V_A1), c1 = VEC4(V_C1);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int lr = g + j * G;
        const int row = row0 + lr;
        const float4 r = relu4(fma4(add4(acc[j], b1), a1, c1));
        tb4[lr * LQ + q] = r;
        if (row < n_rows) r4[static_cast<size_t>(row) * Q + q] = r;
      }
    }
    __syncthreads();
    rows_product<C, R>(tb, w2, g, q, acc);  // w - b2 = r W2
    {
      const float4 b2 = VEC4(V_B2);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = row0 + g + j * G;
        if (row < n_rows) {
          const float4 w = add4(acc[j], b2);
          w4[static_cast<size_t>(row) * Q + q] = w;
          sums[0] = add4(sums[0], w);
          sums[1] = fma4(w, w, sums[1]);
        }
      }
    }
  }
#undef VEC4
  block_sums4<C, 2>(ta, sums,
                    a.partials + static_cast<size_t>(blockIdx.x) * 2 * C, g, q);
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
b2_kernel(Args a) {
  using S = TileShape<C>;
  constexpr int ROWS = S::kRows;
  constexpr int LD = S::kLd;
  constexpr int LQ = LD / 4;
  constexpr int Q = S::kQuads;
  constexpr int G = S::kGroups;
  constexpr int R = ROWS / G;
  constexpr int MB = C / G;  // rows of dW2 a thread owns
  extern __shared__ __align__(128) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cv = sm;                // kNumVec x C
  float* w2t = cv + kNumVec * C;  // C x LD: W2ᵀ
  float* ta = w2t + C * LD;      // ROWS x LD: dwg
  float* tr = ta + ROWS * LD;    // ROWS x LD: r
  float4* ta4 = reinterpret_cast<float4*>(ta);
  float4* tr4 = reinterpret_cast<float4*>(tr);
  float4* sw4 = tr4 + ROWS * LQ;  // ROWS x Q each: w, x, dy, staged
  float4* sx4 = sw4 + ROWS * Q;
  float4* sdy4 = sx4 + ROWS * Q;

  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  const float n = a.n;
  load_consts<C, false>(a, cv);
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    w2t[(i % C) * LD + i / C] = __ldg(a.pw2 + i);
  }
  const float4* cv4 = reinterpret_cast<const float4*>(cv) + q;
#define VEC4(row) cv4[(row) * Q]
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* dy4 = reinterpret_cast<const float4*>(a.dy);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4* r4 = reinterpret_cast<const float4*>(a.r);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 sums[3] = {zero4, zero4, zero4};  // db2 = Σdwg, Σds1, Σds1·v̂
  float4 accw[MB];                         // this thread's block of dW2
#pragma unroll
  for (int i = 0; i < MB; ++i) accw[i] = zero4;

  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  if (blockIdx.x < n_tiles) {
    stage_rows<Q>(sw4, w4, blockIdx.x * ROWS, ROWS, n_rows);
    stage_rows<Q>(sx4, x4, blockIdx.x * ROWS, ROWS, n_rows);
    stage_rows<Q>(sdy4, dy4, blockIdx.x * ROWS, ROWS, n_rows);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed, and the last
                      // tile's reads of both tiles are done (the first
                      // time: the constants and W2ᵀ are in place)
    float4 rv[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lr = g + j * G;
      const int row = row0 + lr;
      float4 dwg = zero4;
      rv[j] = zero4;
      if (row < n_rows) {
        const size_t at = static_cast<size_t>(row) * Q + q;
        rv[j] = __ldg(r4 + at);
        const float4 wv = sw4[lr * Q + q];
        const float4 xv = sx4[lr * Q + q];
        const float4 dyv = sdy4[lr * Q + q];
        const float4 g2 =
            gate4(add4(fma4(wv, VEC4(V_A2), VEC4(V_C2)), xv), dyv);
        dwg = bn_back4(VEC4(V_COEF2), n, g2, VEC4(V_SG),
                       hat4(wv, VEC4(V_MU2), VEC4(V_INV2)), VEC4(V_SGW));
        sums[0] = add4(sums[0], dwg);
      }
      ta4[lr * LQ + q] = dwg;
      tr4[lr * LQ + q] = rv[j];
    }
    __syncthreads();  // the tiles are in place and the staged rows read
    const int next = tile + gridDim.x;
    if (next < n_tiles) {  // its rows land while this tile's products run
      stage_rows<Q>(sw4, w4, next * ROWS, ROWS, n_rows);
      stage_rows<Q>(sx4, x4, next * ROWS, ROWS, n_rows);
      stage_rows<Q>(sdy4, dy4, next * ROWS, ROWS, n_rows);
    }
    float4 dr[R];
    rows_product<C, R>(ta, w2t, g, q, dr);  // dr = dwg W2ᵀ
    {
      const float4 beta1 = VEC4(V_BETA1), rgamma1 = VEC4(V_GAMMA1);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (row0 + g + j * G < n_rows) {
          const float4 ds1 = gate4(rv[j], dr[j]);
          sums[1] = add4(sums[1], ds1);
          sums[2] = fma4(ds1, hat4(rv[j], beta1, rgamma1), sums[2]);
        }
      }
    }
    rows_outer<C, ROWS, MB>(tr, ta, g, q, accw);  // dW2 += rᵀ·dwg
  }
#undef VEC4

  float* out = a.partials + static_cast<size_t>(blockIdx.x) * (C * C + 3 * C);
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    *reinterpret_cast<float4*>(out + (MB * g + i) * C + 4 * q) = accw[i];
  }
  static_assert(G * 3 * C <= 2 * ROWS * LD, "the reduction fits two tiles");
  block_sums4<C, 3>(ta, sums, out + C * C, g, q);
}

// ---------------------------------------------------------------------------
// B4: one streaming kernel, no product
// ---------------------------------------------------------------------------

// x rows with a halo each way, ds0 rows with the forward halo, dy and w
// rows, the taps; at least the block's reduction buffer (G x
// (kMaxTaps + 1) x C floats = 1024 x (kMaxTaps + 1)).  The wrapper's
// `b4_smem_bytes` is the same count.
template <int C>
size_t b4_smem_bytes(int rows, int halo) {
  const size_t staged =
      sizeof(float) * C * (4 * static_cast<size_t>(rows) + 3 * halo + kMaxTaps);
  const size_t red = sizeof(float) * 1024 * (kMaxTaps + 1);
  return staged > red ? staged : red;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2) b4_kernel(Args a, int rows) {
  constexpr int Q = C / 4;        // float4s of a row
  constexpr int G = kThreads / Q;  // row groups
  extern __shared__ __align__(128) float4 smem4[];
  const int K = a.K;
  const int H = (K - 1) * a.d;
  float4* sx = smem4;                  // (rows + 2H) x Q: x from t0 - H
  float4* sd = sx + (rows + 2 * H) * Q;  // (rows + H) x Q: ds0, then du
  float4* sy = sd + (rows + H) * Q;    // rows x Q: dy
  float4* sw = sy + rows * Q;          // rows x Q: w
  float4* taps = sw + rows * Q;        // kMaxTaps x Q

  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  const float4* vec4 = reinterpret_cast<const float4*>(a.vec);
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* dy4 = reinterpret_cast<const float4*>(a.dy);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4* ds04 = reinterpret_cast<const float4*>(a.ds0);
  float4* dx4 = reinterpret_cast<float4*>(a.dx);
  for (int i = threadIdx.x; i < K * Q; i += kThreads) {
    taps[i] = __ldg(reinterpret_cast<const float4*>(a.dw) + i);
  }
  const float n = a.n;
  const float4 dwb = __ldg(vec4 + V_DWB * Q + q);
  const float4 mu0 = __ldg(vec4 + V_MU0 * Q + q);
  const float4 inv0 = __ldg(vec4 + V_INV0 * Q + q);
  const float4 coef0 = __ldg(vec4 + V_COEF0 * Q + q);
  const float4 k0 = make_float4(coef0.x / n, coef0.y / n, coef0.z / n,
                                coef0.w / n);
  const float4 sds0 = __ldg(vec4 + V_SDS0 * Q + q);
  const float4 sds0u = __ldg(vec4 + V_SDS0U * Q + q);
  const float4 a2 = __ldg(vec4 + V_A2 * Q + q);
  const float4 c2 = __ldg(vec4 + V_C2 * Q + q);

  float4 sums[kMaxTaps + 1];  // dWd per tap, then dbd
#pragma unroll
  for (int i = 0; i <= kMaxTaps; ++i) sums[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int tiles_per_utt = (a.T + rows - 1) / rows;
  const int n_tiles = a.B * tiles_per_utt;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_utt;
    const int t0 = (tile % tiles_per_utt) * rows;
    const size_t base = static_cast<size_t>(b) * a.T * Q;
    __syncthreads();  // the previous tile's shared reads are done
    for (int i = threadIdx.x; i < (rows + 2 * H) * Q; i += kThreads) {
      const int t = t0 - H + i / Q;
      const bool ok = t >= 0 && t < a.T;
      cp_async16(sx + i, x4 + base + (ok ? static_cast<size_t>(t) * Q + i % Q : 0),
                 ok);
    }
    for (int i = threadIdx.x; i < (rows + H) * Q; i += kThreads) {
      const int t = t0 + i / Q;
      const bool ok = t < a.T;
      cp_async16(sd + i, ds04 + base + (ok ? static_cast<size_t>(t) * Q + i % Q : 0),
                 ok);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < rows * Q; i += kThreads) {
      const int t = t0 + i / Q;
      const bool ok = t < a.T;
      const size_t at = base + (ok ? static_cast<size_t>(t) * Q + i % Q : 0);
      cp_async16(sy + i, dy4 + at, ok);
      cp_async16(sw + i, w4 + at, ok);
    }
    cp_async_commit();
    cp_async_wait<1>();  // x and ds0 have landed; dy and w may be in flight
    __syncthreads();

    // u, û and du for the tile's rows and the forward halo; du = 0 past
    // the utterance's end
    for (int lr = g; lr < rows + H; lr += G) {
      float4 du = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + lr < a.T) {
        const float4* xr = sx + (lr + H) * Q + q;  // x at frame t0 + lr
        float4 u = dwb;
        for (int tap = 0; tap < K; ++tap) {
          u = fma4(xr[-(K - 1 - tap) * a.d * Q], taps[tap * Q + q], u);
        }
        const float4 ds = sd[lr * Q + q];
        du.x = k0.x * (n * ds.x - sds0.x - (u.x - mu0.x) * inv0.x * sds0u.x);
        du.y = k0.y * (n * ds.y - sds0.y - (u.y - mu0.y) * inv0.y * sds0u.y);
        du.z = k0.z * (n * ds.z - sds0.z - (u.z - mu0.z) * inv0.z * sds0u.z);
        du.w = k0.w * (n * ds.w - sds0.w - (u.w - mu0.w) * inv0.w * sds0u.w);
        if (lr < rows) {  // the sums take the tile's own rows only
          sums[kMaxTaps].x += du.x;
          sums[kMaxTaps].y += du.y;
          sums[kMaxTaps].z += du.z;
          sums[kMaxTaps].w += du.w;
#pragma unroll
          for (int tap = 0; tap < kMaxTaps; ++tap) {
            if (tap < K) {
              sums[tap] = fma4(du, xr[-(K - 1 - tap) * a.d * Q], sums[tap]);
            }
          }
        }
      }
      sd[lr * Q + q] = du;
    }
    cp_async_wait<0>();
    __syncthreads();

    // dx[t] = g2[t] + Σ_tap du[t + (K-1-tap) d] w_tap
    for (int lr = g; lr < rows; lr += G) {
      const int t = t0 + lr;
      if (t >= a.T) break;
      const float4 wv = sw[lr * Q + q];
      const float4 xv = sx[(lr + H) * Q + q];
      const float4 dyv = sy[lr * Q + q];
      float4 acc;
      acc.x = wv.x * a2.x + c2.x + xv.x > 0.f ? dyv.x : 0.f;
      acc.y = wv.y * a2.y + c2.y + xv.y > 0.f ? dyv.y : 0.f;
      acc.z = wv.z * a2.z + c2.z + xv.z > 0.f ? dyv.z : 0.f;
      acc.w = wv.w * a2.w + c2.w + xv.w > 0.f ? dyv.w : 0.f;
      for (int tap = 0; tap < K; ++tap) {
        acc = fma4(sd[(lr + (K - 1 - tap) * a.d) * Q + q], taps[tap * Q + q],
                   acc);
      }
      dx4[base + static_cast<size_t>(t) * Q + q] = acc;
    }
  }

  // this block's partial: dWd (K x C) then dbd, the row groups added in
  // order
  __syncthreads();
  float4* red4 = smem4;  // G x (kMaxTaps + 1) x Q
#pragma unroll
  for (int i = 0; i <= kMaxTaps; ++i) {
    red4[(g * (kMaxTaps + 1) + i) * Q + q] = sums[i];
  }
  __syncthreads();
  const float* red = reinterpret_cast<const float*>(smem4);
  float* out = a.partials + static_cast<size_t>(blockIdx.x) * (K * C + C);
  for (int o = threadIdx.x; o < (K + 1) * C; o += kThreads) {
    const int i = o / C < K ? o / C : kMaxTaps;
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      acc += red[(gg * (kMaxTaps + 1) + i) * C + o % C];
    }
    out[o] = acc;
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
int run(int pass, const Args& a, int n_blocks, int b4_rows, float* reduced,
        cudaStream_t s) {
  const size_t wsz = sizeof(float) * C * (C + 1);
  const size_t tile = sizeof(float) * kTile * C;
  const size_t red = sizeof(float) * (kThreads / C) * 2 * C;  // block_sums
  const size_t total = static_cast<size_t>(a.B) * a.T * C;
  int width = 2 * C;
  int err = 0;
  switch (pass) {
    case kF1:
      err = launch_tiles(fwd_kernel<C, kF1>, a, tile + red, n_blocks, s);
      break;
    case kF2:
      err = launch_tiles(fwd_kernel<C, kF2>, a, wsz + tile + red, n_blocks, s);
      break;
    case kF3: {
      const size_t window = f3_window_bytes<C>((a.K - 1) * a.d);
      const bool staged = f3_smem_bytes<C>() + window <= kSmemLimit;
      const size_t smem = f3_smem_bytes<C>() + (staged ? window : 0);
      err = static_cast<int>(cudaFuncSetAttribute(
          f3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (err != 0) return err;
      f3_kernel<C><<<n_blocks, kThreads, smem, s>>>(a, staged);
      err = static_cast<int>(cudaGetLastError());
      break;
    }
    case kF4:
      f4_kernel<C><<<elementwise_blocks(total), kThreads, 0, s>>>(a, total);
      return static_cast<int>(cudaGetLastError());
    case kB1:
      err = launch_tiles(b1_kernel<C>, a, red, n_blocks, s);
      break;
    case kB2:
      err = launch_tiles(b2_kernel<C>, a, b2_smem_bytes<C>(), n_blocks, s);
      width = C * C + 3 * C;
      break;
    case kB3:
      err = launch_tiles(b3_kernel<C>, a, b3_smem_bytes<C>(), n_blocks, s);
      width = C * C + 3 * C;
      break;
    case kB4: {
      const size_t smem = b4_smem_bytes<C>(b4_rows, (a.K - 1) * a.d);
      if (b4_rows < 1 || smem > kSmemLimit) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = static_cast<int>(cudaFuncSetAttribute(
          b4_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (err != 0) return err;
      b4_kernel<C><<<n_blocks, kThreads, smem, s>>>(a, b4_rows);
      err = static_cast<int>(cudaGetLastError());
      width = a.K * C + C;
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
  return err;
}

}  // namespace

extern "C" {

// One pass of the fused training block.  `ptrs` lists, in order: x, dy,
// w, r, dw (K, C), pw1, pw2, vec (kNumVec, C), out_r, out_w, out_y, dx,
// ds0 (B, T, C: B3's output, B4's input), partials (n_blocks, width),
// reduced (width); unused slots are null.  `dims` = {C, B, T, K,
// dilation, n_blocks, rows of a B4 tile}.
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
  a.ds0 = static_cast<float*>(ptrs[12]);
  a.partials = static_cast<float*>(ptrs[13]);
  float* reduced = static_cast<float*>(ptrs[14]);
  a.B = dims[1];
  a.T = dims[2];
  a.K = dims[3];
  a.d = dims[4];
  a.n = n;
  const int n_blocks = dims[5];
  const int b4_rows = dims[6];
  if (a.B < 1 || a.T < 1 || a.K < 1 || a.K > kMaxTaps || a.d < 1 ||
      n_blocks < 1 || pass < kF1 || pass > kB4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return run<32>(pass, a, n_blocks, b4_rows, reduced, s);
    case 64: return run<64>(pass, a, n_blocks, b4_rows, reduced, s);
    case 128: return run<128>(pass, a, n_blocks, b4_rows, reduced, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
