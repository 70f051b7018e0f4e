// Fused TCNBlock training step with exact BatchNorm, for Hopper
// (sm_90a), fp32, with bf16-operand variants of F2, F3, B2 and B3.
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
// operations; B3 runs its products on the tensor cores.  At 16 warps
// an SM a pass with one channel a thread is bound by the instructions
// it issues before either, so every pass but F4 gives a thread four
// neighbouring channels (float4 loads, stores and shared traffic).
//
// bf16 (the JAX package's `precision="bfloat16"`, `mdt = bf16`).  F2,
// F3, B2 and B3 have a second kernel each, `f2_bf16_kernel` ..
// `b3_bf16_kernel`, that computes what the TPU kernels compute at
// mdt = bf16: every C x C product takes operands rounded to bf16 (round
// to nearest even, __float2bfloat16_rn) and sums in fp32; F3 writes r
// as bf16 and B2 and B3 read it back; x, w, dy, ds0, every sum and
// every per-channel constant stay fp32.  F1, F4, B1 and B4 read no r
// and no product operand and have no variant.  At bf16 the operations
// of all four are far under the bf16 peak, so their bound is bytes, and
// r moves half of them.  All four run their products on the tensor
// cores with `mma.sync` m16n8k16 and `ldmatrix` (their section below
// says how they near their bytes bound): F2 and F3 are one body
// (bf16_forward), F2 ending at v's sums; B3 runs B2's dr beside three
// more products, each result in registers.
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
// F1 is the conv alone: tile_forward's prefix (below) without W1 and
// without a product.  It tiles the flattened frames as F2 does, with
// twice F2's rows (eight rows a thread), four channels a thread, and
// sums u and u² in registers; with nothing to hide a copy behind, it
// keeps two windows of x in shared memory and copies the tile after
// next while it reads this one (kF1Staged; streaming instead, each
// thread reading its taps by __ldg from L1 and L2, was 0.0003 ms slower
// on an H100, PERF.md §6).  From frame (K-1) d of an utterance on
// the conv's loads go unpredicated.
//
// F2, F3 and B2 (fp32) take B3's tiles (below) over
// the flattened frames and its float4 elementwise steps, with fp32
// products: a thread forms the four channels of its own R rows of a
// product in registers (float4 loads of a row of the input tile and of
// four rows of W, 64 FMAs per
// eight 16-byte shared loads at C = 64), so the product's output never
// goes through shared memory and the elementwise step that follows
// reads it where it is.  F2 and F3 are one body (tile_forward): conv
// and s0 into a tile, v = s0 W1; F2 ends there with Σv and Σv² (bound
// by its one product; nothing written but the partials), F3 goes on:
// r written and into the second tile, w = r W2 written, Σw and Σw².
// B2: dwg and r into two tiles (r read once, kept in registers for the
// mask and v̂), dr = dwg W2ᵀ (W2 stored transposed) -> ds1 and its
// sums, and dW2 += rᵀ dwg with each thread's (C / G) x 4 block of dW2
// in registers across a block's tiles.  While a tile's products run,
// 16-byte `cp.async` copies bring the next tile's inputs into shared
// memory: F2's and F3's window of x (the tile's rows and the causal
// halo (K-1) d before them, zero before frame 0; where F3's does not
// fit beside the rest, a halo over 538 frames at C = 64 or 58 at
// C = 128, both read the taps from device memory), B2's rows of w, x
// and dy (r is read directly: a fourth staged input would leave one
// block per SM).  B3's three TF32 passes on the tensor cores were
// slower here (F3) or as fast with ten times the error (B2).
//
// B1 has no halo and no product: one stream over the flattened frames,
// bound by its reads of w, x and dy (78 MB at the main shape).  A
// thread keeps one channel quad for the whole grid stride, a2, c2, mu2
// and inv2 in registers, and issues the loads of kB1Rows rows before it
// uses the first, so that enough bytes are in flight to near the
// card's rate; its eight sums are reduced over the block in row-group
// order.  On an NVIDIA H100 80GB HBM3 at 700 W, B=512 x T=198 x C=64
// (chip_smoke.py phase 8, reductions included): B1 0.036 ms a call
// against 0.023 for its bytes, F2 0.050 ms against 0.014 for its fp32
// operations (PERF.md §6).

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
// as in F1, these steps alone took longer than the four products: the
// pass is bound by instruction count, at 16 warps an SM.)  The dW1 accumulator fragments stay in registers across a
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
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
  // the bf16 variants' r (the same slots as r and out_r)
  const __nv_bfloat16* r16;
  __nv_bfloat16* out_r16;
};

__device__ __forceinline__ float vc(const Args& a, int row, int C, int c) {
  return __ldg(a.vec + row * C + c);
}

// four neighbouring bf16 values (8 bytes) <-> a float4
__device__ __forceinline__ void st_bf16x4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// a bf16 value is the top half of its fp32 value: widening is a shift
__device__ __forceinline__ float4 widen_bf16x4(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ float4 ld_bf16x4(const __nv_bfloat16* p) {
  return widen_bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// (C, C) row-major -> shared, row stride LD
template <int C, int LD>
__device__ __forceinline__ void load_padded(const float* __restrict__ g,
                                            float* s) {
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    s[(i / C) * LD + i % C] = g[i];
  }
}

// ---------------------------------------------------------------------------
// forward: F4 (F1, F2 and F3: tile_forward)
// ---------------------------------------------------------------------------

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

// the per-channel vector and the taps, then the reduction tile (F1), W1
// and the s0 tile (F2), or W1, W2 and two tiles (F3)
template <int C, int P>
constexpr size_t fwd_smem_bytes() {
  using S = TileShape<C>;
  constexpr int mats = P == kF3 ? 2 : (P == kF2 ? 1 : 0);
  constexpr int tiles = P == kF3 ? 2 : 1;
  return sizeof(float) * ((kNumVec + kMaxTaps) * C + mats * C * S::kLd +
                          tiles * S::kRows * S::kLd);
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

// F1 stages its windows of x (true) or streams, reading its taps by
// __ldg from L1 and L2 (false); its tiles are kF1RowScale times F2's rows
constexpr bool kF1Staged = true;
constexpr int kF1RowScale = 2;

// u, the causal depthwise conv of x plus dw_b, for this thread's
// channel quad at frame t of its utterance; `xr` points at the row's
// quad of x, in a staged window (kShared) or in device memory.  A tap
// before the utterance's first frame is zero, so a tile that spans two
// utterances never reads the earlier one; from frame H = (K-1) d on no
// tap is, and the loads go unpredicated.
template <int C, bool kShared>
__device__ __forceinline__ float4 conv4(const Args& a, const float4* cv4,
                                        const float4* xr, int t, int H) {
  constexpr int Q = C / 4;
  float4 u = cv4[V_DWB * Q];
  if (t >= H) {
#pragma unroll
    for (int tap = 0; tap < kMaxTaps; ++tap) {
      if (tap < a.K) {
        const float4* p = xr - (a.K - 1 - tap) * a.d * Q;
        u = fma4(kShared ? *p : __ldg(p), cv4[(kNumVec + tap) * Q], u);
      }
    }
  } else {
#pragma unroll
    for (int tap = 0; tap < kMaxTaps; ++tap) {
      const int back = (a.K - 1 - tap) * a.d;
      if (tap < a.K && back <= t) {
        const float4* p = xr - back * Q;
        u = fma4(kShared ? *p : __ldg(p), cv4[(kNumVec + tap) * Q], u);
      }
    }
  }
  return u;
}

// the frame in its utterance of a row G rows on from frame t
__device__ __forceinline__ int next_frame(int t, int G, int T) {
  t += G;
  while (t >= T) t -= T;
  return t;
}

// F1, F2 and F3 share their prefix: the conv over flattened tiles.  F1
// (P = kF1) ends there with Σu and Σu² (no product, no tile but the
// reduction's); F2 and F3 go on to s0 in a tile and v = s0 W1, F2 ending
// with Σv and Σv², F3 going on to r, w and Σw, Σw².  staged: F2's and
// F3's window of the block's next tile is copied into shared memory
// while this tile's products run (where F3's fits beside the rest,
// run(): one rule for both), else the taps are read from device memory.
// F1 has no product to hide a copy behind, so it keeps two windows and
// copies the tile after next while it works on this one (where they
// fit and kF1Staged).  At bf16 F2 and F3 are bf16_forward (below).
template <int C, int P>
__device__ __forceinline__ void tile_forward(const Args& a, bool staged) {
  using S = TileShape<C>;
  constexpr bool kFull = P == kF3;
  constexpr int ROWS = S::kRows * (P == kF1 ? kF1RowScale : 1);
  constexpr int LD = S::kLd;
  constexpr int LQ = LD / 4;
  constexpr int Q = S::kQuads;
  constexpr int G = S::kGroups;
  constexpr int R = ROWS / G;
  static_assert(G * 2 * C <= S::kRows * LD, "the reduction fits the s0 tile");
  extern __shared__ __align__(128) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cv = sm;                             // kNumVec x C, then the taps
  float* w1 = cv + (kNumVec + kMaxTaps) * C;  // C x LD (F2, F3)
  float* w2 = w1 + (P == kF1 ? 0 : C * LD);   // C x LD (F3)
  float* ta = w2 + (kFull ? C * LD : 0);      // ROWS x LD: s0 (F1: only
                                              // the reduction)
  float* tb = ta + S::kRows * LD;             // ROWS x LD: r (F3)
  float4* ta4 = reinterpret_cast<float4*>(ta);
  float4* tb4 = reinterpret_cast<float4*>(tb);
  float4* xs4 = reinterpret_cast<float4*>(tb + (kFull ? ROWS * LD : 0));
                                              // (ROWS + H) x Q: x, staged
                                              // (F1: two of them)

  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  load_consts<C, true>(a, cv);
  if (P != kF1) load_padded<C, LD>(a.pw1, w1);
  if (kFull) load_padded<C, LD>(a.pw2, w2);
  const float4* cv4 = reinterpret_cast<const float4*>(cv) + q;
#define VEC4(row) cv4[(row) * Q]
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float4* r4 = reinterpret_cast<float4*>(a.out_r);
  float4* w4 = reinterpret_cast<float4*>(a.out_w);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 sums[2] = {zero4, zero4};  // F1: Σu, Σu²; F2: Σv, Σv²; F3: Σw, Σw²
  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  const int H = (a.K - 1) * a.d;
  if constexpr (P == kF1) {
    const int span = (ROWS + H) * Q;  // float4s of one window
    if (staged) {  // the block's first two tiles, one group each
      for (int i = 0; i < 2; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        if (tile < n_tiles) {
          stage_rows<Q>(xs4 + i * span, x4, tile * ROWS - H, ROWS + H, n_rows);
        } else {
          cp_async_commit();
        }
      }
    }
    __syncthreads();  // the constants are in place
    for (int tile = blockIdx.x, it = 0; tile < n_tiles;
         tile += gridDim.x, ++it) {
      const float4* xw = nullptr;
      if (staged) {
        cp_async_wait<1>();  // this tile's group has landed (this thread's)
        __syncthreads();     // (every thread's)
        xw = xs4 + (it & 1) * span;
      }
      const int row0 = tile * ROWS;
      int t = (row0 + g) % a.T;  // the frame of row row0 + g + j G
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int lr = g + j * G;
        const int row = row0 + lr;
        if (row < n_rows) {
          const float4 u =
              xw != nullptr
                  ? conv4<C, true>(a, cv4, xw + (lr + H) * Q + q, t, H)
                  : conv4<C, false>(a, cv4, x4 + static_cast<size_t>(row) * Q
                                                + q, t, H);
          sums[0] = add4(sums[0], u);
          sums[1] = fma4(u, u, sums[1]);
        }
        t = next_frame(t, G, a.T);
      }
      if (staged) {
        __syncthreads();  // every read of this window is done
        const int later = tile + 2 * gridDim.x;
        if (later < n_tiles) {
          stage_rows<Q>(xs4 + (it & 1) * span, x4, later * ROWS - H, ROWS + H,
                        n_rows);
        } else {
          cp_async_commit();
        }
      }
    }
  } else {
  if (staged && blockIdx.x < n_tiles) {
    stage_rows<Q>(xs4, x4, blockIdx.x * ROWS - H, ROWS + H, n_rows);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    if (staged) cp_async_wait<0>();
    __syncthreads();  // every thread's copies of the window have landed,
                      // and the last tile's reads of s0 are done (the
                      // first time: the constants and weights are in place)
    int t = (row0 + g) % a.T;  // the frame of row row0 + g + j G
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lr = g + j * G;
      const int row = row0 + lr;
      float4 s0 = zero4;
      if (row < n_rows) {
        const float4 u =
            staged ? conv4<C, true>(a, cv4, xs4 + (lr + H) * Q + q, t, H)
                   : conv4<C, false>(a, cv4, x4 + static_cast<size_t>(row) * Q
                                                 + q, t, H);
        s0 = fma4(u, VEC4(V_A0), VEC4(V_C0));
      }
      ta4[lr * LQ + q] = s0;
      t = next_frame(t, G, a.T);
    }
    __syncthreads();  // s0 is in place and the window is read
    if (staged && tile + gridDim.x < n_tiles) {
      stage_rows<Q>(xs4, x4, (tile + gridDim.x) * ROWS - H, ROWS + H, n_rows);
    }
    float4 acc[R];
    rows_product<C, R>(ta, w1, g, q, acc);  // v - b1 = s0 W1
    const float4 b1 = VEC4(V_B1);
    if constexpr (!kFull) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (row0 + g + j * G < n_rows) {
          const float4 v = add4(acc[j], b1);
          sums[0] = add4(sums[0], v);
          sums[1] = fma4(v, v, sums[1]);
        }
      }
    } else {
      {
        const float4 a1 = VEC4(V_A1), c1 = VEC4(V_C1);
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
  }
#undef VEC4
  block_sums4<C, 2>(ta, sums,
                    a.partials + static_cast<size_t>(blockIdx.x) * 2 * C, g, q);
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
f1_tile_kernel(Args a, bool staged) {
  tile_forward<C, kF1>(a, staged);
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
f2_kernel(Args a, bool staged) {
  tile_forward<C, kF2>(a, staged);
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
f3_kernel(Args a, bool staged) {
  tile_forward<C, kF3>(a, staged);
}

// B2 with fp32 products in registers (see the head of this file)
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
// F2, F3, B2 and B3 at bf16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------
//
// Bound: at bf16 the C x C products are far under the tensor cores'
// peak (1.66 GFLOP a product at the main shape, some 0.002 ms at 989
// TFLOP/s), so all four are bound by the bytes they move, at B=512 x
// T=198 x C=64 and 3.35 TB/s: F2 reads x, 26.0 MB, 0.0078 ms; F3 reads x
// and writes r (bf16) and w, 64.9 MB, 0.0194 ms; B2 reads dy, w, x and
// r (bf16), 90.8 MB, 0.0271 ms; B3 reads dy, w, x and r and writes ds0,
// 116.8 MB, 0.0349 ms.  Their first bf16 versions ran the products as
// fp32 FMAs on the CUDA cores on operands rounded into fp32 tiles (F2,
// F3, B2) or as `wmma` passes through fp32 result tiles (B3).
//
// Design.  Every product is `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`
// with its operands from `ldmatrix` (`.trans` where the operand is
// needed transposed) or formed in registers; W1 and W2 sit in shared
// memory as bf16 at row stride C + 8 (16-byte rows, the eight rows of an
// `ldmatrix` matrix on 32 different banks).  Within each 16-channel
// slice a product's k and n run in fragment order: position p holds
// channel perm16(p), so the four positions a thread owns of an A
// fragment's row (2t, 2t+1, 2t+8, 2t+9) and of a pair of n8 accumulator
// tiles are the four neighbouring channels 4t .. 4t+3.  The weights are
// stored in that order (`load_frag_weights`); in exchange every
// elementwise step works on float4 channel quads, constants are float4
// loads, and a quad of lanes writes a row's 32 bytes of r or 64 of w:
// whole sectors.
//
// F2 and F3 (`f2_bf16_kernel`, `f3_bf16_kernel`, one body:
// bf16_forward): a warp owns 16 rows of a 128-row tile over the
// flattened frames and keeps the chain in registers.  The conv and bn0
// are formed in fp32 straight into s0's A fragments from the window of
// x, taps outside and slices inside (one window row's address serves
// every slice); v = s0 W1 goes to accumulators.  F2 ends there with Σv
// and Σv² of v + b1 (the same v, in the same order, that F3 goes on to
// normalise); F3's v takes b1, bn1 and the ReLU there
// and is rounded to bf16, and since two neighbouring n8 accumulator
// tiles are one k16 A fragment, r feeds w = r W2 without passing through
// shared memory; r (bf16) and w (fp32) go to device memory from the
// fragments.  The window of x (the tile's rows and the causal halo
// (K-1) d before them) comes by 16-byte `cp.async`, the next tile's
// copied while this tile's products run, where it fits beside the
// weights; otherwise the taps are read from device memory.  A ring of
// two windows tied one (0.0416 against 0.0419 ms at B=512 x T=198 x
// C=64, 0.1019 against 0.1016 at T=598, PERF.md §6): the time goes to
// the products and the conv's shared-memory loads issued by 16 warps an
// SM, not to the copies, so one window it is.  A window row's 16-byte
// chunks swap halves in odd rows, so the float4 loads of two
// neighbouring rows at one channel quad fall on different banks at any
// dilation.  F2 stages its window by F3's rule.
//
// B2 (`b2_bf16_kernel`): 64-row tiles; the next tile's rows of w, x and
// dy (fp32) and r (bf16, a ring of two tiles) are copied by `cp.async`
// while this tile's products run.  g2, ŵ and dwg are formed in fp32 with
// a thread on a channel quad (as b2_kernel), db2 summed before dwg is
// rounded into a bf16 tile; dr = dwg W2ᵀ reads that tile (`ldmatrix`)
// and W2 in place (`ldmatrix` on W2's rows is Wᵀ's B fragment), two
// warps to a 16-row block; ds1 and its sums on the accumulators with r
// from its tile; dW2 += rᵀ dwg contracts over the tile's rows with both
// operands from the bf16 tiles by `ldmatrix.trans`, each warp's share of
// the C x C fp32 accumulators in registers across the block's tiles (16
// floats a thread at C = 64, 64 at C = 128).  Rows past the end are zero
// in both tiles and left out of every sum.
//
// B3 (`b3_bf16_kernel`): four products, dr = dwg W2ᵀ and v = s0 W1 on
// the tile, dW1 += s0ᵀ dv over its rows and ds0 = dv W1ᵀ, each result in
// registers.  One copy each of W1 and W2, rows and columns in fragment
// order, serves both of its products (`ldmatrix` on rows for Wᵀ,
// `.trans` for W); the dwg (then dv) and s0 tiles are bf16 in fragment
// order too, so the elementwise steps run at the accumulators' own rows
// and channel quads: g2, dwg, the conv, s0 and û in fp32 there (û kept
// in registers for Σds0·û at the end), ds1, v̂ and dv on the dr and v
// accumulators (Σdv before dv is rounded), ds0 to device memory from its
// accumulators.  dW1 is B2b's rᵀ dwg scheme, written back to natural
// order in the partial.  32-row tiles (64 at C = 32): at 64 rows and
// C = 64 a thread's two slices and dW1's share spilled 76 B.  One stage:
// the next tile's w, dy (fp32, odd rows' chunks swapped) and window of x
// are copied by `cp.async` once the elementwise step has read this
// tile's, its r (bf16) once ds1 has; they land while the products run.
// A second stage, in flight from the top of the tile, left no room for
// the window at C = 128 beyond a halo of 12 and was no faster at
// C = 64 (PERF.md §6, row 12b).
//
// The sums keep the scheme above: lane partials, a shuffle over the
// fragment's row groups, the warps in a fixed order through shared
// memory, one partial a block, reduce_kernel in block order.

constexpr int kFragRows = 16;                 // rows of an A fragment
constexpr int kF3bRows = kFragRows * kWarps;  // rows of an F3 tile at bf16
constexpr int kB2bRows = 64;                  // rows of a B2 tile at bf16

// two fp32 values rounded to bf16 (nearest even), the first in the low
// half: one 32-bit register of a fragment
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices, lanes 8i .. 8i+7 giving the rows of matrix
// i; register i of lane l holds matrix i's row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 (.trans: its column l / 4, rows 2 (l % 4) and
// 2 (l % 4) + 1)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) · b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the channel at fragment position p of a 16-channel slice: positions
// 2t, 2t+1, 2t+8, 2t+9 hold channels 4t .. 4t+3
__device__ __forceinline__ int perm16(int p) {
  return 4 * ((p & 7) >> 1) + 2 * (p >> 3) + (p & 1);
}

__device__ __forceinline__ int frag_channel(int c) {
  return (c & ~15) | perm16(c & 15);
}

// (C, C) fp32 [in][out] -> shared bf16 at row stride LH, its rows (PR)
// and columns (PC) in fragment order; every load of a thread is issued
// before the first store
template <int C, int LH, bool PR, bool PC>
__device__ __forceinline__ void load_frag_weights(const float* __restrict__ g,
                                                  __nv_bfloat16* s) {
  constexpr int N = C * C / kThreads;
  static_assert(C * C % kThreads == 0, "whole rounds of the block");
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int p = i / C, q = i % C;
    v[k] = __ldg(g + (PR ? frag_channel(p) : p) * C +
                 (PC ? frag_channel(q) : q));
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = threadIdx.x + k * kThreads;
    s[(i / C) * LH + i % C] = __float2bfloat16_rn(v[k]);
  }
}

// one step of sum_scatter_rows: lanes `bit` apart add their values, the
// lane with the bit set keeping the upper half
template <int HALF>
__device__ __forceinline__ void scatter_step(float* v, int lane, int bit) {
  const bool hi = (lane & bit) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = hi ? v[k] : v[HALF + k];
    const float keep = hi ? v[HALF + k] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// N values of each lane summed over a fragment's eight row groups (lanes
// 4, 8 and 16 apart) and dealt out: lane l ends with the sums of values
// [g N/8, (g + 1) N/8), g = l / 4, in v[0 .. N/8)
template <int N>
__device__ __forceinline__ void sum_scatter_rows(float (&v)[N], int lane) {
  static_assert(N % 8 == 0, "eight row groups");
  scatter_step<N / 2>(v, lane, 16);
  scatter_step<N / 4>(v, lane, 8);
  scatter_step<N / 8>(v, lane, 4);
}

// acc (16 x C in n8 tiles) += A (16 x C: C / 16 k16 fragments) · W, W
// bf16 [k][n] in shared memory at row stride LH, both in fragment order;
// B fragments by `ldmatrix.trans`, a pair of n8 tiles a load
template <int C, int LH>
__device__ __forceinline__ void frag_product(const unsigned (&af)[C / 16][4],
                                             const __nv_bfloat16* w,
                                             float (&acc)[C / 8][4],
                                             int lane) {
  constexpr int NS = C / 16;
  // lane l: row (l & 8) + (l & 7) of the k slice, column 8 (l >> 4) of
  // the n pair: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n
  // 8-15), (k 8-15, n 8-15) are b0, b1 of the pair's first tile and b0,
  // b1 of its second
  const __nv_bfloat16* base =
      w + ((lane & 7) + (lane & 8)) * LH + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      unsigned b[4];
      ldsm_x4_trans(b, base + 16 * s * LH + 16 * m);
      mma_bf16(acc[2 * m], af[s], b[0], b[1]);
      mma_bf16(acc[2 * m + 1], af[s], b[2], b[3]);
    }
  }
}

// the channel quad of row half h (fragment row g, or g + 8) held by a
// pair of n8 accumulator tiles
__device__ __forceinline__ float4 acc_quad(const float (&lo)[4],
                                           const float (&hi)[4], int h) {
  return make_float4(lo[2 * h], lo[2 * h + 1], hi[2 * h], hi[2 * h + 1]);
}

// F2's and F3's shared memory at bf16 without their window: the
// per-channel vector and the taps, then W1 (F3: and W2) as bf16 at row
// stride C + 8 (the block's reduction reuses the weights' space)
template <int C, int P>
constexpr size_t fwd_bf16_base_bytes() {
  return sizeof(float) * (kNumVec + kMaxTaps) * C +
         (P == kF3 ? 2 : 1) * sizeof(__nv_bfloat16) * C * (C + 8);
}

// the window of x: a tile's rows and the halo before them
template <int C>
size_t f3_bf16_window_bytes(int halo) {
  return sizeof(float) * C * static_cast<size_t>(kF3bRows + halo);
}

// the window is staged where it fits a block beside F3's weights, else
// the taps are read from device memory: one rule for F2 and F3
template <int C>
bool f3_bf16_staged(int halo) {
  return fwd_bf16_base_bytes<C, kF3>() + f3_bf16_window_bytes<C>(halo) <=
         kSmemLimit;
}

// rows [first, first + count) of a (n_rows, Q) float4 tensor into a
// window, as stage_rows, with the 16-byte chunk c of an odd row at c ^ 4
template <int Q>
__device__ __forceinline__ void stage_window(float4* dst, const float4* src,
                                             int first, int count,
                                             int n_rows) {
  for (int i = threadIdx.x; i < count * Q; i += kThreads) {
    const int lr = i / Q, c = i % Q;
    const int row = first + lr;
    const bool ok = row >= 0 && row < n_rows;
    cp_async16(dst + lr * Q + (c ^ ((lr & 1) << 2)),
               src + (ok ? static_cast<size_t>(row) * Q + c : 0), ok);
  }
  cp_async_commit();
}

// the float4 at channel quad cq of row lr of a window (or of rows staged
// by stage_window)
template <int Q>
__device__ __forceinline__ float4 window_quad(const float4* win, int lr,
                                              int cq) {
  return win[lr * Q + (cq ^ ((lr & 1) << 2))];
}

// F2 (P = kF2) and F3 (P = kF3) at bf16, one body: the conv and bn0
// straight into s0's A fragments, v = s0 W1 in accumulators.  F2 ends
// there with Σv and Σv² of v + b1, F3 goes on to r, w and Σw, Σw².  Both
// form v in the same order, so the v whose sums F2 returns is, bit for
// bit, the v that F3 normalises.  F2 loads no W2, writes no r and no w.
template <int C, int P>
__device__ __forceinline__ void bf16_forward(const Args& a, bool staged) {
  constexpr bool kFull = P == kF3;
  constexpr int Q = C / 4;
  constexpr int NS = C / 16;  // k16 slices; pairs of n8 tiles
  constexpr int LH = C + 8;
  static_assert(NS % 2 == 0 && Q >= 8, "a window row has two halves");
  static_assert(kWarps * 2 * C * sizeof(float) <=
                    (kFull ? 2 : 1) * sizeof(__nv_bfloat16) * C * LH,
                "the reduction fits the weights' space");
  extern __shared__ __align__(128) float4 smem4[];
  float* cv = reinterpret_cast<float*>(smem4);  // kNumVec x C, the taps
  __nv_bfloat16* w1h =
      reinterpret_cast<__nv_bfloat16*>(cv + (kNumVec + kMaxTaps) * C);
  __nv_bfloat16* w2h = w1h + C * LH;  // (F3)
  float4* win = reinterpret_cast<float4*>(w1h + (kFull ? 2 : 1) * C * LH);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float4* w4 = reinterpret_cast<float4*>(a.out_w);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + kF3bRows - 1) / kF3bRows;
  const int H = (a.K - 1) * a.d;
  // the block's first window in flight while the constants load
  if (staged && blockIdx.x < n_tiles) {
    stage_window<Q>(win, x4, blockIdx.x * kF3bRows - H, kF3bRows + H, n_rows);
  }
  load_consts<C, true>(a, cv);
  load_frag_weights<C, LH, true, true>(a.pw1, w1h);
  if (kFull) load_frag_weights<C, LH, true, true>(a.pw2, w2h);
  // row `row` of the per-channel vector at this thread's quad of slice s
  const float4* cv4 = reinterpret_cast<const float4*>(cv) + tq;
#define VQ(row, s) cv4[(row) * Q + 4 * (s)]

  // F2: Σv then Σv², F3: Σw then Σw², at the channel quads 16 m + 4 tq
  // .. +3 (float4 m, then NS + m) of this warp's rows, summed over its
  // row groups each tile and dealt out: this lane keeps values [g NS,
  // (g + 1) NS)
  float sums[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) sums[k] = 0.f;
  const int lr = warp * kFragRows + g;  // the tile row of fragment row g
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (staged) cp_async_wait<0>();  // this tile's window has landed
    __syncthreads();  // (every thread's; the first time, the constants
                      // and the weights are in place)
    int rows[2], tt[2];  // rows g and g + 8, their frames (-1 past the end)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = tile * kF3bRows + lr + 8 * h;
      tt[h] = rows[h] < n_rows ? rows[h] % a.T : -1;
    }
    // s0 = a0 u + c0 (u the causal depthwise conv of x plus dw_b),
    // straight into A fragments; a tap before the utterance's first frame
    // is zero.  Taps outside, slices inside: one window row's address
    // serves the NS slices.
    unsigned af[NS][4];
    {
      float4 u[NS][2];
#pragma unroll
      for (int s = 0; s < NS; ++s) u[s][0] = u[s][1] = VQ(V_DWB, s);
      // tap `tap` of row lr + 8 h reads window row lr + 8 h + tap d; it is
      // zero while (K - 1 - tap) d > t, and a row past the end (t = -1)
      // reads none
      int first[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        first[h] = tt[h] < 0 ? a.K : tt[h] >= H ? 0 : a.K - 1 - tt[h] / a.d;
      }
#pragma unroll 1
      for (int tap = first[0] < first[1] ? first[0] : first[1]; tap < a.K;
           ++tap) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (tap >= first[h]) {
            const int wr = lr + 8 * h + tap * a.d;
            const float4* xr = staged ? win + wr * Q + tq
                                      : x4 + static_cast<size_t>(
                                                 rows[h] - H + tap * a.d) *
                                                 Q + tq;
            const int odd = staged ? wr & 1 : 0;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const float4 xv = staged ? xr[4 * (s ^ odd)] : __ldg(xr + 4 * s);
              u[s][h] = fma4(xv, VQ(kNumVec + tap, s), u[s][h]);
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float4 s0[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s0[h] = tt[h] >= 0 ? fma4(u[s][h], VQ(V_A0, s), VQ(V_C0, s)) : zero4;
        }
        af[s][0] = pack_bf16x2(s0[0].x, s0[0].y);
        af[s][1] = pack_bf16x2(s0[1].x, s0[1].y);
        af[s][2] = pack_bf16x2(s0[0].z, s0[0].w);
        af[s][3] = pack_bf16x2(s0[1].z, s0[1].w);
      }
    }
    if (staged) {
      __syncthreads();  // every read of this window is done
      const int next = tile + gridDim.x;
      if (next < n_tiles) {  // it lands while the products run
        stage_window<Q>(win, x4, next * kF3bRows - H, kF3bRows + H, n_rows);
      }
    }
    float acc[2 * NS][4];
#pragma unroll
    for (int j = 0; j < 2 * NS; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    frag_product<C, LH>(af, w1h, acc, lane);  // v - b1 = s0 W1
    float part[8 * NS];  // this tile's two sums of rows g and g + 8
    if constexpr (!kFull) {  // F2: Σv, Σv² of v = s0 W1 + b1
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const float4 b1 = VQ(V_B1, m);
        float4 sv = zero4, svv = zero4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (tt[h] >= 0) {
            const float4 v = add4(acc_quad(acc[2 * m], acc[2 * m + 1], h), b1);
            sv = add4(sv, v);
            svv = fma4(v, v, svv);
          }
        }
        *reinterpret_cast<float4*>(part + 4 * m) = sv;
        *reinterpret_cast<float4*>(part + 4 * (NS + m)) = svv;
      }
    } else {
      // r = relu(a1 (v + b1) + c1) in bf16: written, and w's A fragments
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const float4 b1 = VQ(V_B1, m), a1 = VQ(V_A1, m), c1 = VQ(V_C1, m);
        float4 r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          r[h] = relu4(fma4(add4(acc_quad(acc[2 * m], acc[2 * m + 1], h), b1),
                            a1, c1));
        }
        af[m][0] = pack_bf16x2(r[0].x, r[0].y);
        af[m][1] = pack_bf16x2(r[1].x, r[1].y);
        af[m][2] = pack_bf16x2(r[0].z, r[0].w);
        af[m][3] = pack_bf16x2(r[1].z, r[1].w);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (tt[h] >= 0) {
            *reinterpret_cast<uint2*>(a.out_r16 +
                                      static_cast<size_t>(rows[h]) * C +
                                      16 * m + 4 * tq) =
                make_uint2(af[m][h], af[m][2 + h]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * NS; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      frag_product<C, LH>(af, w2h, acc, lane);  // w - b2 = r W2
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const float4 b2 = VQ(V_B2, m);
        float4 sw = zero4, sww = zero4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (tt[h] >= 0) {
            const float4 w = add4(acc_quad(acc[2 * m], acc[2 * m + 1], h), b2);
            w4[static_cast<size_t>(rows[h]) * Q + 4 * m + tq] = w;
            sw = add4(sw, w);
            sww = fma4(w, w, sww);
          }
        }
        *reinterpret_cast<float4*>(part + 4 * m) = sw;
        *reinterpret_cast<float4*>(part + 4 * (NS + m)) = sww;
      }
    }
    sum_scatter_rows(part, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) sums[k] += part[k];
  }
#undef VQ

  // the warps' sums in order, through the weights' space
  __syncthreads();  // every read of the weights is done
  float* red = reinterpret_cast<float*>(w1h);  // kWarps x 2 x C
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int f = g * NS + k;  // value f: float4 f / 4, its lane f % 4
    const int j = f / 4;
    red[(warp * 2 + j / NS) * C + 16 * (j % NS) + 4 * tq + f % 4] = sums[k];
  }
  __syncthreads();
  float* out = a.partials + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int o = threadIdx.x; o < 2 * C; o += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += red[w * 2 * C + o];
    out[o] = acc;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
f2_bf16_kernel(Args a, bool staged) {
  bf16_forward<C, kF2>(a, staged);
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
f3_bf16_kernel(Args a, bool staged) {
  bf16_forward<C, kF3>(a, staged);
}

// B2's shared memory at bf16: the per-channel vector, the staged w, x
// and dy rows (fp32; the block's reductions reuse them), then bf16 at
// row stride C + 8: W2 (rows in fragment order), the dwg tile and a ring
// of two r tiles
template <int C>
constexpr size_t b2_bf16_smem_bytes() {
  return sizeof(float) * (kNumVec * C + 3 * kB2bRows * C) +
         sizeof(__nv_bfloat16) * (C + 3 * kB2bRows) * (C + 8);
}

// rows [first, first + count) of a (n_rows, C) bf16 tensor into shared
// memory at row stride LH by 16-byte `cp.async` copies, zeros past the
// end
template <int C, int LH>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int first, int count,
                                                int n_rows) {
  constexpr int P = C / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < count * P; i += kThreads) {
    const int lr = i / P, c = i % P;
    const int row = first + lr;
    const bool ok = row < n_rows;
    cp_async16(reinterpret_cast<float4*>(dst + lr * LH + 8 * c),
               reinterpret_cast<const float4*>(
                   src + (ok ? static_cast<size_t>(row) * C + 8 * c : 0)),
               ok);
  }
  cp_async_commit();
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
b2_bf16_kernel(Args a) {
  constexpr int ROWS = kB2bRows;
  constexpr int Q = C / 4;
  constexpr int G = kThreads / Q;  // row groups of the elementwise step
  constexpr int R = ROWS / G;      // its rows a thread
  constexpr int LH = C + 8;
  constexpr int NS = C / 16;
  // dr: four 16-row blocks, WPM warps to a block, NP pairs of n8 tiles a
  // warp
  constexpr int WPM = kWarps / (ROWS / kFragRows);
  constexpr int NP = NS / WPM;
  // dW2: C / 16 row blocks of n8 tiles, OWPM warps to a block, ONT n8
  // tiles a warp
  constexpr int OWPM = kWarps / NS;
  constexpr int ONT = (C / 8) / OWPM;
  static_assert(ROWS % G == 0 && NP >= 1 && OWPM >= 1 &&
                    (ONT == 1 || ONT % 2 == 0),
                "the tiles deal out evenly");
  extern __shared__ __align__(128) float4 smem4[];
  float* cv = reinterpret_cast<float*>(smem4);  // kNumVec x C
  float4* sw4 = reinterpret_cast<float4*>(cv + kNumVec * C);  // ROWS x Q
  float4* sx4 = sw4 + ROWS * Q;                               // each
  float4* sdy4 = sx4 + ROWS * Q;
  __nv_bfloat16* w2h = reinterpret_cast<__nv_bfloat16*>(sdy4 + ROWS * Q);
  __nv_bfloat16* tg = w2h + C * LH;    // ROWS x LH: dwg
  __nv_bfloat16* tr = tg + ROWS * LH;  // 2 x ROWS x LH: r

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const int q = threadIdx.x % Q, ge = threadIdx.x / Q;  // elementwise
  const float n = a.n;
  const float4* cv4 = reinterpret_cast<const float4*>(cv);
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* dy4 = reinterpret_cast<const float4*>(a.dy);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  const int mb = warp / WPM;             // dr's row block
  const int p0 = (warp % WPM) * NP;      // its first n pair
  const int om = warp / OWPM;            // dW2's row block
  const int nt0 = (warp % OWPM) * ONT;   // its first n8 tile
  float4 db2 = zero4;                    // Σdwg at channels 4q .. 4q+3
  float4 sds[2][NP];                     // Σds1, Σds1·v̂ at 16 (p0+j) + 4tq
  float accw[ONT][4];                    // this warp's tiles of dW2
#pragma unroll
  for (int j = 0; j < NP; ++j) sds[0][j] = sds[1][j] = zero4;
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    accw[j][0] = accw[j][1] = accw[j][2] = accw[j][3] = 0.f;
  }

  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  auto stage = [&](int tile, __nv_bfloat16* rbuf) {
    stage_rows<Q>(sw4, w4, tile * ROWS, ROWS, n_rows);
    stage_rows<Q>(sx4, x4, tile * ROWS, ROWS, n_rows);
    stage_rows<Q>(sdy4, dy4, tile * ROWS, ROWS, n_rows);
    stage_rows_bf16<C, LH>(rbuf, a.r16, tile * ROWS, ROWS, n_rows);
  };
  // the first tile's rows are in flight while the constants load
  if (blockIdx.x < n_tiles) stage(blockIdx.x, tr);
  load_consts<C, false>(a, cv);
  // dr's B[o][i] = W2[i][o]: `ldmatrix` on W2's rows, i in fragment
  // order (the accumulators' channel quads)
  load_frag_weights<C, LH, true, false>(a.pw2, w2h);
  for (int tile = blockIdx.x, it = 0; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const int row0 = tile * ROWS;
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed, and the last
                      // tile's reads of the tiles are done (the first
                      // time: the constants and W2 are in place)
    // g2, ŵ and dwg in fp32; db2 sums dwg before it is rounded into its
    // tile (zero past the end)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lr = ge + j * G;
      float4 dwg = zero4;
      if (row0 + lr < n_rows) {
        const float4 wv = sw4[lr * Q + q];
        const float4 xv = sx4[lr * Q + q];
        const float4 dyv = sdy4[lr * Q + q];
        const float4 g2 = gate4(
            add4(fma4(wv, cv4[V_A2 * Q + q], cv4[V_C2 * Q + q]), xv), dyv);
        dwg = bn_back4(cv4[V_COEF2 * Q + q], n, g2, cv4[V_SG * Q + q],
                       hat4(wv, cv4[V_MU2 * Q + q], cv4[V_INV2 * Q + q]),
                       cv4[V_SGW * Q + q]);
        db2 = add4(db2, dwg);
      }
      st_bf16x4(tg + lr * LH + 4 * q, dwg);
    }
    __syncthreads();  // the dwg tile is in place and the staged rows read
    if (tile + gridDim.x < n_tiles) {  // they land while the products run
      stage(tile + gridDim.x, tr + ((it + 1) & 1) * ROWS * LH);
    }
    const __nv_bfloat16* rt = tr + (it & 1) * ROWS * LH;
    {  // dr = dwg W2ᵀ -> ds1 = dr·[r > 0], Σds1, Σds1·v̂
      float acc[2 * NP][4];
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7,
      // k 8-15), (rows 8-15, k 8-15) of the block's dwg rows; B: W2's
      // rows i (n) 0-7 and 8-15 of the pair by its columns o (k) 0-7 and
      // 8-15
      const __nv_bfloat16* pa =
          tg + (mb * kFragRows + (lane & 7) + (lane & 8)) * LH +
          (lane >> 4) * 8;
      const __nv_bfloat16* pb =
          w2h + (16 * p0 + (lane & 7) + (lane >> 4) * 8) * LH + (lane & 8);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        unsigned af[4];
        ldsm_x4(af, pa + 16 * s);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          unsigned b[4];
          ldsm_x4(b, pb + 16 * j * LH + 16 * s);
          mma_bf16(acc[2 * j], af, b[0], b[1]);
          mma_bf16(acc[2 * j + 1], af, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int cq = 4 * (p0 + j) + tq;  // the channel quad
        const float4 beta1 = cv4[V_BETA1 * Q + cq];
        const float4 rgamma1 = cv4[V_GAMMA1 * Q + cq];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = mb * kFragRows + g + 8 * h;
          if (row0 + lr < n_rows) {
            const float4 rv = widen_bf16x4(
                *reinterpret_cast<const uint2*>(rt + lr * LH + 4 * cq));
            const float4 ds1 =
                gate4(rv, acc_quad(acc[2 * j], acc[2 * j + 1], h));
            sds[0][j] = add4(sds[0][j], ds1);
            sds[1][j] = fma4(ds1, hat4(rv, beta1, rgamma1), sds[1][j]);
          }
        }
      }
    }
    // dW2 += rᵀ dwg over the tile's rows.  A (i x rows) = rᵀ: matrices
    // (rows 0-7, i 0-7), (rows 0-7, i 8-15), (rows 8-15, i 0-7), (rows
    // 8-15, i 8-15) of the r tile, transposed; B (rows x o) = dwg: (rows
    // 0-7, o 0-7), (rows 8-15, o 0-7), then o 8-15, transposed
    const __nv_bfloat16* pa =
        rt + ((lane & 7) + (lane >> 4) * 8) * LH + om * 16 + (lane & 8);
    const __nv_bfloat16* pb =
        tg + ((lane & 7) + (lane & 8)) * LH + 8 * nt0 + (lane >> 4) * 8;
#pragma unroll
    for (int s = 0; s < ROWS / 16; ++s) {
      unsigned af[4];
      ldsm_x4_trans(af, pa + 16 * s * LH);
      if constexpr (ONT == 1) {
        unsigned b[2];
        ldsm_x2_trans(b, pb + 16 * s * LH);
        mma_bf16(accw[0], af, b[0], b[1]);
      } else {
#pragma unroll
        for (int j = 0; j < ONT / 2; ++j) {
          unsigned b[4];
          ldsm_x4_trans(b, pb + 16 * s * LH + 16 * j);
          mma_bf16(accw[2 * j], af, b[0], b[1]);
          mma_bf16(accw[2 * j + 1], af, b[2], b[3]);
        }
      }
    }
  }

  // dW2's tiles straight into the block's partial: rows (i) 16 om + g
  // and + 8, columns (o) 8 (nt0 + j) + 2 tq and + 1
  float* out =
      a.partials + static_cast<size_t>(blockIdx.x) * (C * C + 3 * C);
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    const int i0 = om * 16 + g, o0 = 8 * (nt0 + j) + 2 * tq;
    *reinterpret_cast<float2*>(out + i0 * C + o0) =
        make_float2(accw[j][0], accw[j][1]);
    *reinterpret_cast<float2*>(out + (i0 + 8) * C + o0) =
        make_float2(accw[j][2], accw[j][3]);
  }
  // Σds1, Σds1·v̂ over the fragment's row groups, then (below) over the
  // row blocks in order; db2 over the elementwise step's row groups
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        sds[i][j].x += __shfl_xor_sync(0xffffffffu, sds[i][j].x, off);
        sds[i][j].y += __shfl_xor_sync(0xffffffffu, sds[i][j].y, off);
        sds[i][j].z += __shfl_xor_sync(0xffffffffu, sds[i][j].z, off);
        sds[i][j].w += __shfl_xor_sync(0xffffffffu, sds[i][j].w, off);
      }
    }
  }
  cp_async_wait<0>();  // (the last tile staged nothing)
  float* red = reinterpret_cast<float*>(sw4);  // the staged rows are free
  block_sums4<C, 1>(red, &db2, out + C * C, ge, q);
  float4* red4 = reinterpret_cast<float4*>(red + G * C);  // blocks x 2 x Q
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        red4[(mb * 2 + i) * Q + 4 * (p0 + j) + tq] = sds[i][j];
      }
    }
  }
  __syncthreads();
  const float* red2 = red + G * C;
  for (int o = threadIdx.x; o < 2 * C; o += kThreads) {
    float acc = 0.f;
    for (int b = 0; b < ROWS / kFragRows; ++b) acc += red2[b * 2 * C + o];
    out[C * C + C + o] = acc;
  }
}

// rows of a B3 tile at bf16: 32 (64 at C = 32, where 32 rows leave a
// warp no whole slice), so that a thread's registers hold its share of
// dW1 beside two rows' chain without spilling
template <int C>
__host__ __device__ constexpr int b3_bf16_rows() {
  return C == 32 ? 64 : 32;
}

// B3's shared memory at bf16 without its window: the per-channel vector
// and the taps, the staged w and dy rows (fp32, stage_window's chunk
// order; the block's reduction reuses them), then bf16 at row stride
// C + 8: W1 and W2 (rows and columns in fragment order), the dwg tile
// (then dv), the s0 tile and the r tile
template <int C>
constexpr size_t b3_bf16_base_bytes() {
  constexpr int ROWS = b3_bf16_rows<C>();
  return sizeof(float) * ((kNumVec + kMaxTaps) * C + 2 * ROWS * C) +
         sizeof(__nv_bfloat16) * (2 * C + 3 * ROWS) * (C + 8);
}

// B3's window of x: a tile's rows and the halo before them
template <int C>
size_t b3_bf16_window_bytes(int halo) {
  return sizeof(float) * C * static_cast<size_t>(b3_bf16_rows<C>() + halo);
}

// B3 stages its window of x where it fits a block, else it reads x and
// its taps from device memory
template <int C>
bool b3_bf16_staged(int halo) {
  return b3_bf16_base_bytes<C>() + b3_bf16_window_bytes<C>(halo) <=
         kSmemLimit;
}

// a float4 channel quad (channels 4t .. 4t+3 of a slice) into a bf16
// tile in fragment order: positions 2t, 2t+1 and 2t+8, 2t+9
__device__ __forceinline__ void st_frag_quad(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16x2(v.x, v.y);
  *reinterpret_cast<unsigned*>(p + 8) = pack_bf16x2(v.z, v.w);
}

// B3 at bf16 (see the head of this file): every product on the tensor
// cores, operands by `ldmatrix`, results in registers.
template <int C>
__global__ void __launch_bounds__(kThreads, C == 128 ? 1 : 2)
b3_bf16_kernel(Args a, bool staged) {
  constexpr int ROWS = b3_bf16_rows<C>();
  constexpr int Q = C / 4;
  constexpr int LH = C + 8;
  constexpr int NS = C / 16;
  // dr, v and ds0: ROWS / 16 row blocks, WPM warps to a block, NP
  // slices (pairs of n8 tiles) a warp; the elementwise steps and the
  // sums at the same rows and channels
  constexpr int WPM = kWarps / (ROWS / kFragRows);
  constexpr int NP = NS / WPM;
  // dW1: NS row blocks of n8 tiles, OWPM warps to a block, ONT n8 tiles
  // a warp
  constexpr int OWPM = kWarps / NS;
  constexpr int ONT = (C / 8) / OWPM;
  // a lane's values of Σdv, Σds0 and Σds0·û a tile (12 NP), padded to
  // whole row groups
  constexpr int NV = 12 * NP;
  constexpr int NPART = (NV + 7) / 8 * 8;
  static_assert(NP >= 1 && NP * WPM == NS && OWPM >= 1 &&
                    (ONT == 1 || ONT % 2 == 0) && Q >= 8,
                "the tiles deal out evenly");
  static_assert((ROWS / kFragRows) * 3 * C <= 2 * ROWS * C,
                "the reduction fits the staged rows");
  extern __shared__ __align__(128) float4 smem4[];
  float* cv = reinterpret_cast<float*>(smem4);  // kNumVec x C, the taps
  float4* sw4 = reinterpret_cast<float4*>(cv + (kNumVec + kMaxTaps) * C);
  float4* sdy4 = sw4 + ROWS * Q;  // ROWS x Q each: w, dy
  __nv_bfloat16* w1h = reinterpret_cast<__nv_bfloat16*>(sdy4 + ROWS * Q);
  __nv_bfloat16* w2h = w1h + C * LH;   // C x LH each
  __nv_bfloat16* tg = w2h + C * LH;    // ROWS x LH: dwg, then dv
  __nv_bfloat16* ts = tg + ROWS * LH;  // ROWS x LH: s0
  __nv_bfloat16* tr = ts + ROWS * LH;  // ROWS x LH: r
  float4* win = reinterpret_cast<float4*>(tr + ROWS * LH);  // x, staged

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const float n = a.n;
  const int mb = warp / WPM;          // the row block of dr, v and ds0
  const int p0 = (warp % WPM) * NP;   // its first slice
  const int om = warp / OWPM;         // dW1's row block
  const int nt0 = (warp % OWPM) * ONT;  // its first n8 tile
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* dy4 = reinterpret_cast<const float4*>(a.dy);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  float4* ds04 = reinterpret_cast<float4*>(a.ds0);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  const int H = (a.K - 1) * a.d;
  auto stage = [&](int tile) {  // a tile's w and dy rows, its window of x
    stage_window<Q>(sw4, w4, tile * ROWS, ROWS, n_rows);
    stage_window<Q>(sdy4, dy4, tile * ROWS, ROWS, n_rows);
    if (staged) stage_window<Q>(win, x4, tile * ROWS - H, ROWS + H, n_rows);
  };
  // the first tile's rows are in flight while the constants load
  if (blockIdx.x < n_tiles) {
    stage(blockIdx.x);
    stage_rows_bf16<C, LH>(tr, a.r16, blockIdx.x * ROWS, ROWS, n_rows);
  }
  load_consts<C, true>(a, cv);
  // one copy of each weight serves both of its products
  load_frag_weights<C, LH, true, true>(a.pw1, w1h);
  load_frag_weights<C, LH, true, true>(a.pw2, w2h);
  const float4* cv4 = reinterpret_cast<const float4*>(cv) + tq;
#define VQ(row, s) cv4[(row) * Q + 4 * (s)]

  float sums[NPART / 8];  // this lane's share of the three sums
  float accw[ONT][4];     // this warp's tiles of dW1 (fragment order)
#pragma unroll
  for (int k = 0; k < NPART / 8; ++k) sums[k] = 0.f;
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    accw[j][0] = accw[j][1] = accw[j][2] = accw[j][3] = 0.f;
  }
  // ldmatrix addresses: the A operands (dwg, s0, dv) of this warp's row
  // block; W2's and W1's rows (B of dr and ds0: Wᵀ); W1's columns (B of
  // v, .trans)
  const int arow =
      (mb * kFragRows + (lane & 7) + (lane & 8)) * LH + (lane >> 4) * 8;
  const int brow = (16 * p0 + (lane & 7) + (lane >> 4) * 8) * LH + (lane & 8);
  const int bcol = ((lane & 7) + (lane & 8)) * LH + 16 * p0 + (lane >> 4) * 8;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed, and the last
                      // tile's reads of the tiles are done (the first
                      // time: the constants and weights are in place)
    int lrs[2], rows[2], tt[2];  // rows g and g + 8 of the row block, their
                                 // frames (-1 past the end)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lrs[h] = mb * kFragRows + g + 8 * h;
      rows[h] = row0 + lrs[h];
      tt[h] = rows[h] < n_rows ? rows[h] % a.T : -1;
    }
    // g2, dwg, u, s0 and û in fp32 at this thread's rows and channel
    // quads 4 (p0 + j) + tq; dwg and s0 rounded into their tiles (zero
    // past the end), û kept for the end of the tile
    float4 uhat[2][NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int s = p0 + j;
      const int cq = 4 * s + tq;
      float4 u[2] = {VQ(V_DWB, s), VQ(V_DWB, s)};
#pragma unroll
      for (int tap = 0; tap < kMaxTaps; ++tap) {
        if (tap < a.K) {
          const int back = (a.K - 1 - tap) * a.d;
          const float4 wk = VQ(kNumVec + tap, s);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (back <= tt[h]) {
              u[h] = fma4(staged ? window_quad<Q>(win, lrs[h] + H - back, cq)
                                 : __ldg(x4 + static_cast<size_t>(
                                                  rows[h] - back) * Q + cq),
                          wk, u[h]);
            }
          }
        }
      }
      float4 dwg[2], s0[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dwg[h] = s0[h] = uhat[h][j] = zero4;
        if (tt[h] >= 0) {
          const float4 wv = window_quad<Q>(sw4, lrs[h], cq);
          const float4 dyv = window_quad<Q>(sdy4, lrs[h], cq);
          const float4 xv =
              staged ? window_quad<Q>(win, lrs[h] + H, cq)
                     : __ldg(x4 + static_cast<size_t>(rows[h]) * Q + cq);
          const float4 g2 =
              gate4(add4(fma4(wv, VQ(V_A2, s), VQ(V_C2, s)), xv), dyv);
          dwg[h] = bn_back4(VQ(V_COEF2, s), n, g2, VQ(V_SG, s),
                            hat4(wv, VQ(V_MU2, s), VQ(V_INV2, s)),
                            VQ(V_SGW, s));
          s0[h] = fma4(u[h], VQ(V_A0, s), VQ(V_C0, s));
          uhat[h][j] = hat4(u[h], VQ(V_MU0, s), VQ(V_INV0, s));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st_frag_quad(tg + lrs[h] * LH + 16 * s + 2 * tq, dwg[h]);
        st_frag_quad(ts + lrs[h] * LH + 16 * s + 2 * tq, s0[h]);
      }
    }
    __syncthreads();  // the dwg and s0 tiles are in place, the staged rows
                      // read
    const int next = tile + gridDim.x;
    if (next < n_tiles) stage(next);  // they land while the products run

    // dr = dwg W2ᵀ and v = s0 W1 - b1, both in registers
    float dr[2 * NP][4], v[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      dr[j][0] = dr[j][1] = dr[j][2] = dr[j][3] = 0.f;
      v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      unsigned ag[4], as[4];
      ldsm_x4(ag, tg + arow + 16 * s);
      ldsm_x4(as, ts + arow + 16 * s);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        unsigned b[4];
        ldsm_x4(b, w2h + brow + 16 * j * LH + 16 * s);
        mma_bf16(dr[2 * j], ag, b[0], b[1]);
        mma_bf16(dr[2 * j + 1], ag, b[2], b[3]);
        ldsm_x4_trans(b, w1h + bcol + 16 * s * LH + 16 * j);
        mma_bf16(v[2 * j], as, b[0], b[1]);
        mma_bf16(v[2 * j + 1], as, b[2], b[3]);
      }
    }
    // ds1 = dr·[r > 0], v̂, dv = k1 (n ds1 - Σds1 - v̂ Σds1v); db1 sums
    // dv before it is rounded
    float part[NPART];  // this tile's Σdv, Σds0, Σds0·û: float4 t NP + j
#pragma unroll
    for (int k = 0; k < NPART; ++k) part[k] = 0.f;
    unsigned dvh[2][NP][2];  // dv in bf16, fragment order
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int s = p0 + j;
      const float4 b1 = VQ(V_B1, s), mu1 = VQ(V_MU1, s);
      const float4 inv1 = VQ(V_INV1, s), k1 = VQ(V_COEF1, s);
      const float4 sds1 = VQ(V_SDS1, s), sds1v = VQ(V_SDS1V, s);
      float4 sdv = zero4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 dv = zero4;
        if (tt[h] >= 0) {
          const float4 rv = widen_bf16x4(*reinterpret_cast<const uint2*>(
              tr + lrs[h] * LH + 4 * (4 * s + tq)));
          const float4 ds1 =
              gate4(rv, acc_quad(dr[2 * j], dr[2 * j + 1], h));
          const float4 vhat =
              hat4(add4(acc_quad(v[2 * j], v[2 * j + 1], h), b1), mu1, inv1);
          dv = bn_back4(k1, n, ds1, sds1, vhat, sds1v);
          sdv = add4(sdv, dv);
        }
        dvh[h][j][0] = pack_bf16x2(dv.x, dv.y);
        dvh[h][j][1] = pack_bf16x2(dv.z, dv.w);
      }
      *reinterpret_cast<float4*>(part + 4 * j) = sdv;
    }
    __syncthreads();  // every read of dwg and of r is done
    if (next < n_tiles) {  // it lands while dW1 and ds0 run
      stage_rows_bf16<C, LH>(tr, a.r16, next * ROWS, ROWS, n_rows);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* p = tg + lrs[h] * LH + 16 * (p0 + j) + 2 * tq;
        *reinterpret_cast<unsigned*>(p) = dvh[h][j][0];
        *reinterpret_cast<unsigned*>(p + 8) = dvh[h][j][1];
      }
    }
    __syncthreads();  // the dv tile is in place
    {  // dW1 += s0ᵀ dv over the tile's rows, both by `ldmatrix.trans`
      // (B2b's rᵀ dwg): A (i x rows) = s0ᵀ, B (rows x o) = dv
      const __nv_bfloat16* pa =
          ts + ((lane & 7) + (lane >> 4) * 8) * LH + om * 16 + (lane & 8);
      const __nv_bfloat16* pb =
          tg + ((lane & 7) + (lane & 8)) * LH + 8 * nt0 + (lane >> 4) * 8;
#pragma unroll
      for (int s = 0; s < ROWS / 16; ++s) {
        unsigned af[4];
        ldsm_x4_trans(af, pa + 16 * s * LH);
        if constexpr (ONT == 1) {
          unsigned b[2];
          ldsm_x2_trans(b, pb + 16 * s * LH);
          mma_bf16(accw[0], af, b[0], b[1]);
        } else {
#pragma unroll
          for (int j = 0; j < ONT / 2; ++j) {
            unsigned b[4];
            ldsm_x4_trans(b, pb + 16 * s * LH + 16 * j);
            mma_bf16(accw[2 * j], af, b[0], b[1]);
            mma_bf16(accw[2 * j + 1], af, b[2], b[3]);
          }
        }
      }
    }
    // ds0 = dv W1ᵀ
    float d0[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      d0[j][0] = d0[j][1] = d0[j][2] = d0[j][3] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      unsigned ad[4];
      ldsm_x4(ad, tg + arow + 16 * s);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        unsigned b[4];
        ldsm_x4(b, w1h + brow + 16 * j * LH + 16 * s);
        mma_bf16(d0[2 * j], ad, b[0], b[1]);
        mma_bf16(d0[2 * j + 1], ad, b[2], b[3]);
      }
    }
    // ds0 to device memory as channel quads; Σds0 and Σds0·û
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float4 sd = zero4, sdu = zero4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tt[h] >= 0) {
          const float4 ds0 = acc_quad(d0[2 * j], d0[2 * j + 1], h);
          ds04[static_cast<size_t>(rows[h]) * Q + 4 * (p0 + j) + tq] = ds0;
          sd = add4(sd, ds0);
          sdu = fma4(ds0, uhat[h][j], sdu);
        }
      }
      *reinterpret_cast<float4*>(part + 4 * (NP + j)) = sd;
      *reinterpret_cast<float4*>(part + 4 * (2 * NP + j)) = sdu;
    }
    sum_scatter_rows(part, lane);
#pragma unroll
    for (int k = 0; k < NPART / 8; ++k) sums[k] += part[k];
  }
#undef VQ

  // dW1's tiles into the block's partial in natural order: position
  // 16 om + g (+ 8) is channel i = 16 om + perm16(g (+ 8)), positions
  // 8 nt + 2 tq, + 1 are channels o, o + 1
  float* out =
      a.partials + static_cast<size_t>(blockIdx.x) * (C * C + 3 * C);
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    const int nt = nt0 + j;
    const int o = 16 * (nt / 2) + 4 * tq + 2 * (nt & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * om + perm16(g + 8 * h);
      *reinterpret_cast<float2*>(out + i * C + o) =
          make_float2(accw[j][2 * h], accw[j][2 * h + 1]);
    }
  }
  // the three sums: over the row blocks in order, through the staged rows
  cp_async_wait<0>();  // (the last tile staged nothing)
  __syncthreads();     // every read of the staged rows is done
  float* red = reinterpret_cast<float*>(sw4);  // row blocks x 3 x C
#pragma unroll
  for (int k = 0; k < NPART / 8; ++k) {
    const int f = g * (NPART / 8) + k;  // value f: float4 f / 4 (sum f /
                                        // 4 / NP, slice p0 + f / 4 % NP)
    if (f < NV) {
      const int t = f / 4 / NP, j = f / 4 % NP;
      red[(mb * 3 + t) * C + 16 * (p0 + j) + 4 * tq + f % 4] = sums[k];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 3 * C; o += kThreads) {
    float acc = 0.f;
    for (int b = 0; b < ROWS / kFragRows; ++b) acc += red[b * 3 * C + o];
    out[C * C + o] = acc;
  }
}

// ---------------------------------------------------------------------------
// B1: the bn2 gradient sums of g2, one stream over the flattened frames
// ---------------------------------------------------------------------------

constexpr int kB1Rows = 4;  // rows of a thread in flight at once

// the block's reduction of B1's two channel sums (block_sums4)
template <int C>
constexpr size_t b1_smem_bytes() {
  return sizeof(float) * (kThreads / (C / 4)) * 2 * C;
}

// A thread owns one channel quad for the whole grid stride and holds
// kB1Rows rows of w, x and dy in flight (every load issued before the
// first is used); a block takes kThreads / (C / 4) x kB1Rows rows at a
// time.
template <int C>
__global__ void __launch_bounds__(kThreads, 2) b1_stream_kernel(Args a) {
  constexpr int Q = C / 4;
  constexpr int G = kThreads / Q;
  constexpr int ROWS = G * kB1Rows;
  extern __shared__ __align__(128) float4 smem4[];
  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  const float4* vec4 = reinterpret_cast<const float4*>(a.vec) + q;
  const float4 a2 = __ldg(vec4 + V_A2 * Q), c2 = __ldg(vec4 + V_C2 * Q);
  const float4 mu2 = __ldg(vec4 + V_MU2 * Q);
  const float4 inv2 = __ldg(vec4 + V_INV2 * Q);
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* dy4 = reinterpret_cast<const float4*>(a.dy);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 sums[2] = {zero4, zero4};  // Σg2, Σg2·ŵ
  const int n_rows = a.B * a.T;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS + g;
    float4 wv[kB1Rows], xv[kB1Rows], dyv[kB1Rows];
#pragma unroll
    for (int j = 0; j < kB1Rows; ++j) {  // rows past the end read row 0
      const int row = row0 + j * G;
      const size_t at = static_cast<size_t>(row < n_rows ? row : 0) * Q + q;
      wv[j] = __ldg(w4 + at);
      xv[j] = __ldg(x4 + at);
      dyv[j] = __ldg(dy4 + at);
    }
#pragma unroll
    for (int j = 0; j < kB1Rows; ++j) {
      if (row0 + j * G < n_rows) {
        const float4 g2 = gate4(add4(fma4(wv[j], a2, c2), xv[j]), dyv[j]);
        sums[0] = add4(sums[0], g2);
        sums[1] = fma4(g2, hat4(wv[j], mu2, inv2), sums[1]);
      }
    }
  }
  block_sums4<C, 2>(reinterpret_cast<float*>(smem4), sums,
                    a.partials + static_cast<size_t>(blockIdx.x) * 2 * C, g, q);
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

template <typename Kern, typename... Extra>
int launch_tiles(Kern kern, const Args& a, size_t smem, int n_blocks,
                 cudaStream_t s, Extra... extra) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_blocks, kThreads, smem, s>>>(a, extra...);
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
int run(int pass, const Args& a, int n_blocks, int b4_rows, bool bf,
        float* reduced, cudaStream_t s) {
  const size_t total = static_cast<size_t>(a.B) * a.T * C;
  int width = 2 * C;
  int err = 0;
  if (bf && pass != kF2 && pass != kF3 && pass != kB2 && pass != kB3) {
    return static_cast<int>(cudaErrorInvalidValue);  // no bf16 variant
  }
  switch (pass) {
    case kF1: {  // two windows where they fit
      const size_t windows =
          2 * sizeof(float) * C *
          (TileShape<C>::kRows * kF1RowScale + (a.K - 1) * a.d);
      const bool staged =
          kF1Staged && fwd_smem_bytes<C, kF1>() + windows <= kSmemLimit;
      err = launch_tiles(f1_tile_kernel<C>, a,
                         fwd_smem_bytes<C, kF1>() + (staged ? windows : 0),
                         n_blocks, s, staged);
      break;
    }
    case kF2:
    case kF3: {
      const int halo = (a.K - 1) * a.d;
      if (bf) {  // their own tiles and window
        const bool staged = f3_bf16_staged<C>(halo);
        const size_t window = staged ? f3_bf16_window_bytes<C>(halo) : 0;
        err = pass == kF2
            ? launch_tiles(f2_bf16_kernel<C>, a,
                           fwd_bf16_base_bytes<C, kF2>() + window, n_blocks,
                           s, staged)
            : launch_tiles(f3_bf16_kernel<C>, a,
                           fwd_bf16_base_bytes<C, kF3>() + window, n_blocks,
                           s, staged);
        break;
      }
      const size_t window = f3_window_bytes<C>(halo);
      const bool staged = fwd_smem_bytes<C, kF3>() + window <= kSmemLimit;
      const size_t extra = staged ? window : 0;
      err = pass == kF2
          ? launch_tiles(f2_kernel<C>, a, fwd_smem_bytes<C, kF2>() + extra,
                         n_blocks, s, staged)
          : launch_tiles(f3_kernel<C>, a, fwd_smem_bytes<C, kF3>() + extra,
                         n_blocks, s, staged);
      break;
    }
    case kF4:
      f4_kernel<C><<<elementwise_blocks(total), kThreads, 0, s>>>(a, total);
      return static_cast<int>(cudaGetLastError());
    case kB1:
      err = launch_tiles(b1_stream_kernel<C>, a, b1_smem_bytes<C>(), n_blocks,
                         s);
      break;
    case kB2:
      err = bf ? launch_tiles(b2_bf16_kernel<C>, a, b2_bf16_smem_bytes<C>(),
                              n_blocks, s)
               : launch_tiles(b2_kernel<C>, a, b2_smem_bytes<C>(), n_blocks,
                              s);
      width = C * C + 3 * C;
      break;
    case kB3:
      if (bf) {
        const int halo = (a.K - 1) * a.d;
        const bool staged = b3_bf16_staged<C>(halo);
        err = launch_tiles(b3_bf16_kernel<C>, a,
                           b3_bf16_base_bytes<C>() +
                               (staged ? b3_bf16_window_bytes<C>(halo) : 0),
                           n_blocks, s, staged);
      } else {
        err = launch_tiles(b3_kernel<C>, a, b3_smem_bytes<C>(), n_blocks, s);
      }
      width = C * C + 3 * C;
      break;
    case kB4: {
      const size_t smem = b4_smem_bytes<C>(b4_rows, (a.K - 1) * a.d);
      if (b4_rows < 1 || smem > kSmemLimit) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_tiles(b4_kernel<C>, a, smem, n_blocks, s, b4_rows);
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
// dilation, n_blocks, rows of a B4 tile, bf16}: with bf16 = 1 (F2, F3,
// B2 and B3 only) the bf16-operand variant runs, and r and out_r point
// at bf16 tensors.
// Returns a cudaError_t code (0 on success).
int fused_train_launch(int pass, void* const* ptrs, const int* dims,
                       float n, void* stream) {
  const int C = dims[0];
  Args a;
  a.x = static_cast<const float*>(ptrs[0]);
  a.dy = static_cast<const float*>(ptrs[1]);
  a.w = static_cast<const float*>(ptrs[2]);
  a.r = static_cast<const float*>(ptrs[3]);
  a.r16 = static_cast<const __nv_bfloat16*>(ptrs[3]);
  a.dw = static_cast<const float*>(ptrs[4]);
  a.pw1 = static_cast<const float*>(ptrs[5]);
  a.pw2 = static_cast<const float*>(ptrs[6]);
  a.vec = static_cast<const float*>(ptrs[7]);
  a.out_r = static_cast<float*>(ptrs[8]);
  a.out_r16 = static_cast<__nv_bfloat16*>(ptrs[8]);
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
  const bool bf = dims[7] != 0;
  if (a.B < 1 || a.T < 1 || a.K < 1 || a.K > kMaxTaps || a.d < 1 ||
      n_blocks < 1 || pass < kF1 || pass > kB4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return run<32>(pass, a, n_blocks, b4_rows, bf, reduced, s);
    case 64: return run<64>(pass, a, n_blocks, b4_rows, bf, reduced, s);
    case 128: return run<128>(pass, a, n_blocks, b4_rows, bf, reduced, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
