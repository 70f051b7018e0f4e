// Whole-backbone BN-folded MDTC and DS-TCN forward for Hopper (sm_90a),
// fp32: one kernel body, two layer variants (`Arch`).
//
// Replaces the Pallas TPU kernels wekws_tpu/ops/fused_mdtc.py `_kernel`
// (whole utterance, via `fused_mdtc_forward`) and `_kernel_stream`
// (carried left context, via `fused_mdtc_stream`), and
// wekws_tpu/ops/fused_tcn.py `_kernel` (via `fused_ds_tcn`).  One source
// serves all three: `cache_in`/`cache_out` are null for the
// whole-utterance MDTC entry.
//
// Per MDTC layer l (dilation d_l, K taps, C channels, BN already folded):
//   a = sum_j act[t - (K-1-j) d_l] * dw_w[l, j] + dw_b[l]   (causal depthwise)
//   b = relu(a @ pw1_w[l] + pw1_b[l])
//   y = relu(b @ pw2_w[l] + pw2_b[l] + act[t])              (residual)
// and the output of every layer l > 0 with l % stack_size == 0 is summed
// into `out` (multi-scale aggregation).  A DS-TCN layer (kDsTcn) has the
// same conv with a ReLU after its bias, one product and the residual
// after the second ReLU:
//   h = relu(a);  y = relu(h @ pw_w[l] + pw_b[l]) + act[t]
// and `out` is the last layer's y.  In streaming mode the left
// margin of layer l is cache_in[l] and cache_out[l] receives the last
// pad_max rows of [cache_in[l] | layer-l input]; all pad_max rows are
// carried although only the last (K-1) d_l are read.
//
// Bound on an H100: at B=16, T=198 (the offline batch) the MDTC work is
// ~0.93 GFLOP of fp32 FMA against ~2 MB of compulsory traffic: 0.014 ms
// at 67 TFLOP/s, bound by operations.  At the serving step (B=16, T=8) it
// is bound by bytes: the 17 layers' folded weights (~0.6 MB) and the (L,
// B, pad_max, C) cache in and out (~4.5 MB), 0.0015 ms.  The hey_snips
// DS-TCN (C=64, K=8, 4 layers) is 0.12 GFLOP offline (0.0018 ms, bound by
// operations) and 2.0 MB a streaming step (0.0006 ms, bytes); the
// hi_xiaowen DS-TCN (C=256) 1.73 GFLOP offline (0.026 ms).  A design that
// walks the layers of one row inside one block is bound by that chain.
//
// Design: one thread-block CLUSTER of N blocks per batch row
// (`cudaLaunchKernelEx`; ops/fused_mdtc.py `mdtc_plan` picks N and the
// rest of the plan from the shapes and from how many clusters the card
// holds at once: on an H100 N = 6 at B=16 x T=198, each block on an SM
// of its own, where the 16 clusters of 7 or 8 would not all fit; N = 1
// for a streaming chunk of 8 frames).  Block k owns the frames
// [k R, (k + 1) R), R = ceil(T / N), and walks the layers in order; one
// cluster barrier per layer.  Where they fit, a block keeps each layer's input in shared
// memory as a window [P halo rows | its R rows] (two windows, by layer
// parity): the layer's output rows go straight into the next window,
// and only the halo, the (K-1) d rows before the block's frames, is
// copied per layer: from the blocks to its left through distributed
// shared memory, from x (layer 0), from the cache (streaming) or zero
// (offline).  Block 0's halo is the cache itself, brought by the copy
// engine.  A range that does not fit (long utterances at C = 128) keeps
// the layer outputs in a per-row device buffer (`act`) and stages each
// sub-tile's window, the halo read from L2 by __ldcg (an L1 may hold
// stale lines); where even that window does not fit (a halo of hundreds
// of rows: a dilation of 64 at C = 128), only the rows each tap reads
// are staged, K slices of a sub-tile's rows, whatever the halo.  Per
// sub-tile of TR rows the conv runs four channels a
// thread (float4), then the C x C products as fp32 products blocked in
// registers (thread (g, q) owns channels 4q .. 4q+3 of rows g + j G, j <
// RJ; a streaming chunk of few rows splits each product's depth over two
// threads, Map; where 256 threads are no multiple of the map's, C = 48,
// the last few threads repeat a row's work and store nothing), the hidden
// tile written over the conv's.  A layer's folded
// weights (W1, W2 or W, taps, biases), its cache rows and layer 0's x rows
// come by bulk copies of the copy engine (TMA) on an mbarrier, one
// thread issuing them: a layer ahead into a second weight buffer where
// two fit (not at C = 128, nor at T = 2048).  A DS-TCN W wider than a
// block holds (C = 256: 256 KB) streams through a ring of two slices of
// kSliceRows input rows by TMA, a slice ahead, each sub-tile's product
// summing slice after slice; the frame split, windows and halo stay as
// they are (a split of the output channels over the cluster would need
// the conv's tile all-gathered, two cluster barriers a sub-tile).
// `out` rows are the block's own, written or summed by the thread that
// owns them.  Everything is deterministic: no atomics, fixed summation
// order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr int kMaxSmem = 232448;
constexpr int kNoCluster = -2;
constexpr int kMaxTaps = 8;  // the conv's taps unrolled (more run a loop)
// where a layer's input lies (Plan::mode; ops/fused_mdtc.py WINDOWS)
constexpr int kSmem = 0;    // windows [P halo | R rows] in shared memory
constexpr int kStaged = 1;  // `act`; each sub-tile's window staged
constexpr int kTaps = 2;    // `act`; each tap's rows of a sub-tile staged
// the layer a kernel runs (ops/fused_mdtc.py ARCHS, by index)
constexpr int kMdtc = 0;   // two products, residual inside the ReLU
constexpr int kDsTcn = 1;  // ReLU after the conv, one product
// the widest C whose C x C weights a block holds; a wider DS-TCN W
// streams in slices of kSliceRows input rows
constexpr int kMaxResident = 128;
constexpr int kSliceRows = 32;

__host__ __device__ constexpr bool sliced(int arch, int C) {
  return arch == kDsTcn && C > kMaxResident;
}

struct LayerDilations {
  int d[kMaxLayers];
};

struct Plan {
  int batch, T, C, L, K, stack_size, P;
  int N;         // blocks of a cluster, one cluster per batch row
  int R;         // frames a block owns: ceil(T / N)
  int TR;        // rows of a sub-tile: G RJ (Map<C, S>)
  int mode;      // kSmem, kStaged or kTaps
  int nbuf;      // weight buffers: 2 overlaps the next layer's copy
};

// Shared-memory layout in floats; every offset is a multiple of 4.
struct Layout {
  int wsize;            // one weight buffer: the layer's C x C matrices
                        // (MDTC W1, W2; DS-TCN W unless sliced), taps,
                        // biases (MDTC three, DS-TCN two)
  int w2, dw, bias;     // offsets inside a weight buffer
  int ring;             // two W slices of kSliceRows x C (sliced)
  int win;              // two windows (P + R) x C, or one staged
  int wspan;            // floats of one window
  int ta;               // the conv's tile, then the hidden one: TR x (C + 4)
  int bar, total;       // two mbarriers, two more for the W slices
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

template <int Arch>
__host__ __device__ inline Layout layout(const Plan& p) {
  const int C = p.C;
  const bool slc = sliced(Arch, C);
  const int mats = Arch == kMdtc ? 2 : slc ? 0 : 1;
  Layout s;
  s.w2 = C * C;
  s.dw = mats * C * C;
  s.bias = s.dw + p.K * C;
  s.wsize = s.bias + (Arch == kMdtc ? 3 : 2) * C;
  s.ring = p.nbuf * s.wsize;
  s.win = s.ring + (slc ? 2 * kSliceRows * C : 0);
  s.wspan = p.mode == kSmem     ? (p.P + p.R) * C
            : p.mode == kStaged ? (p.P + p.TR) * C
                                : p.K * p.TR * C;
  s.ta = s.win + (p.mode == kSmem ? 2 : 1) * s.wspan;
  s.bar = s.ta + p.TR * (C + 4);
  s.total = s.bar + (slc ? 8 : 4);
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)));
}

// the one arrival of the barrier's phase, which then also waits for
// `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state) : "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) global -> shared by the copy engine (TMA),
// completing on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float4 fma4s(float s, float4 b, float4 c) {
  return make_float4(fmaf(s, b.x, c.x), fmaf(s, b.y, c.y), fmaf(s, b.z, c.z),
                     fmaf(s, b.w, c.w));
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}

// The thread map of a sub-tile: thread t owns channel quad q = (t / S) %
// Q (channels 4q .. 4q+3) of rows g + j G, j < RJ, g = t / (S Q), and
// for S = 2 one half of every product's reduction depth (s = t % S, the
// two halves added by a shuffle).  TR = G RJ rows.  S = 2 halves each
// thread's chain of FMAs where a sub-tile has few rows (a streaming
// chunk): more threads busy, shorter chains.  Where S Q does not divide
// the block (C = 48: 252 or 240 of 256 threads), the threads past G S Q
// are idle: they take row group G - 1 so that their loads stay in the
// tile and their shuffles pair, and store nothing.
template <int C, int S>
struct Map {
  static constexpr int Q = C / 4;
  static constexpr int G = kThreads / (S * Q);
  static constexpr bool kExact = kThreads % (S * Q) == 0;
};

// acc[j] += Σ_k in[g + j G][k] W[k][4q .. 4q + 3] over this thread's half
// (S = 2) or all of a depth of D rows of W: this thread's rows and
// channels, in registers; in at row stride C + 4, W at C, both in shared
// memory
template <int C, int RJ, int S, int D>
__device__ __forceinline__ void rows_accumulate(const float* in,
                                                const float* w, int g, int q,
                                                int sh, float4 (&acc)[RJ]) {
  constexpr int LD = C + 4;
  constexpr int G = Map<C, S>::G;
  constexpr int KS = D / S;
  const int k0 = sh * KS;
#pragma unroll 2
  for (int k = k0; k < k0 + KS; k += 4) {
    float4 wk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wk[i] = *reinterpret_cast<const float4*>(w + (k + i) * C + 4 * q);
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const float4 av =
          *reinterpret_cast<const float4*>(in + (g + j * G) * LD + k);
      acc[j] = fma4s(av.x, wk[0], acc[j]);
      acc[j] = fma4s(av.y, wk[1], acc[j]);
      acc[j] = fma4s(av.z, wk[2], acc[j]);
      acc[j] = fma4s(av.w, wk[3], acc[j]);
    }
  }
}

// the two halves of the depth (S = 2) summed by a shuffle
template <int RJ, int S>
__device__ __forceinline__ void sum_halves(float4 (&acc)[RJ]) {
  if constexpr (S == 2) {
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      acc[j].x += __shfl_xor_sync(0xffffffffu, acc[j].x, 1);
      acc[j].y += __shfl_xor_sync(0xffffffffu, acc[j].y, 1);
      acc[j].z += __shfl_xor_sync(0xffffffffu, acc[j].z, 1);
      acc[j].w += __shfl_xor_sync(0xffffffffu, acc[j].w, 1);
    }
  }
}

// acc[j] = Σ_k in[g + j G][k] W[k][4q .. 4q + 3] over all C rows of a
// resident W
template <int C, int RJ, int S>
__device__ __forceinline__ void rows_product(const float* in, const float* w,
                                             int g, int q, int sh,
                                             float4 (&acc)[RJ]) {
#pragma unroll
  for (int j = 0; j < RJ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  rows_accumulate<C, RJ, S, C>(in, w, g, q, sh, acc);
  sum_halves<RJ, S>(acc);
}

// Thread 0 issues slice i (input rows i kSliceRows ...) of the layer's W
// at wg into buf, completing on bar.
template <int C>
__device__ __forceinline__ void issue_slice(float* buf, const float* wg,
                                            int i, unsigned long long* bar) {
  constexpr unsigned bytes = 4u * kSliceRows * C;
  mbar_expect(bar, bytes);
  bulk_copy(buf, wg + static_cast<size_t>(i) * kSliceRows * C, bytes, bar);
}

// rows_product with W streamed: C / kSliceRows slices through the ring's
// two buffers (barriers sbar[0], sbar[1]).  Slices 0 and 1 were issued
// at the sub-tile's start; slice i + 2 goes into slice i's buffer once
// every thread has read it.  u counts the block's earlier sub-tiles (each
// completes every buffer's barrier NS / 2 times): the phases.
template <int C, int RJ, int S>
__device__ __forceinline__ void sliced_product(const float* in, float* ring,
                                               const float* wg,
                                               unsigned long long* sbar,
                                               unsigned u, int g, int q,
                                               int sh, float4 (&acc)[RJ]) {
  constexpr int NS = C / kSliceRows;
  static_assert(NS % 2 == 0, "an even number of slices a sub-tile");
#pragma unroll
  for (int j = 0; j < RJ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int i = 0; i < NS; ++i) {
    float* buf = ring + (i & 1) * kSliceRows * C;
    mbar_wait(sbar + (i & 1), (u * (NS / 2) + (i >> 1)) & 1u);
    rows_accumulate<C, RJ, S, kSliceRows>(in + i * kSliceRows, buf, g, q, sh,
                                          acc);
    __syncthreads();  // every read of this slice's buffer is done
    if (threadIdx.x == 0 && i + 2 < NS) {
      issue_slice<C>(buf, wg, i + 2, sbar + (i & 1));
    }
  }
  sum_halves<RJ, S>(acc);
}

struct Ptrs {
  const float* x;
  const float* cache_in;
  const float* dw_w;
  const float* dw_b;
  const float* pw1_w;
  const float* pw1_b;
  const float* pw2_w;
  const float* pw2_b;
  float* out;
  float* cache_out;
  float* act;
};

// Thread 0 issues layer l's group of bulk copies on `bar`: its weights
// (the resident C x C matrices, taps, biases) into the weight buffer wb
// and, into the window `win` of layer l's input, block 0's cache rows
// (streaming) and, for layer 0, the block's x rows.  DS-TCN's W and b
// are pw1_w and pw1_b.
template <int Arch, int C>
__device__ __forceinline__ void issue_layer(const Ptrs& a, const Plan& p,
                                            const Layout& s, float* wb,
                                            float* win, int l, int row,
                                            int t0, int nr, bool cache,
                                            unsigned long long* bar) {
  constexpr unsigned mats = Arch == kMdtc ? 2 : sliced(Arch, C) ? 0 : 1;
  constexpr unsigned biases = Arch == kMdtc ? 3 : 2;
  const unsigned cc = 4u * C * C, kc = 4u * p.K * C, c4 = 4u * C;
  const unsigned cache_bytes = cache ? p.P * c4 : 0u;
  const unsigned x_bytes = l == 0 && p.mode == kSmem ? nr * c4 : 0u;
  mbar_expect(bar, mats * cc + kc + biases * c4 + cache_bytes + x_bytes);
  const size_t lcc = static_cast<size_t>(l) * C * C;
  if constexpr (mats >= 1) bulk_copy(wb, a.pw1_w + lcc, cc, bar);
  if constexpr (mats == 2) bulk_copy(wb + s.w2, a.pw2_w + lcc, cc, bar);
  bulk_copy(wb + s.dw, a.dw_w + static_cast<size_t>(l) * p.K * C, kc, bar);
  bulk_copy(wb + s.bias, a.dw_b + l * C, c4, bar);
  bulk_copy(wb + s.bias + C, a.pw1_b + l * C, c4, bar);
  if constexpr (biases == 3) {
    bulk_copy(wb + s.bias + 2 * C, a.pw2_b + l * C, c4, bar);
  }
  if (cache_bytes) {
    bulk_copy(win, a.cache_in + (static_cast<size_t>(l) * p.batch + row) *
                                    p.P * C, cache_bytes, bar);
  }
  if (x_bytes) {
    bulk_copy(win + p.P * C,
              a.x + (static_cast<size_t>(row) * p.T + t0) * C, x_bytes, bar);
  }
}

// blocks an SM the registers are planned for: two, where the plan's
// shared memory can leave two (C <= 64 and sub-tiles of up to two rows a
// thread); else one, so that four rows a thread do not spill
template <int C, int RJ>
constexpr int kMinBlocks = C <= 64 && RJ <= 2 ? 2 : 1;

// The whole layer chain of one block of a batch row's cluster, for the
// layer `Arch` (kMdtc, kDsTcn); the two kernels below are its entries.
template <int Arch, int C, int RJ, int S>
__device__ __forceinline__ void run_layers(const Ptrs& a, const Plan& p,
                                           const LayerDilations& dil) {
  constexpr int Q = C / 4;
  constexpr int LD = C + 4;
  constexpr int LQ = LD / 4;
  constexpr int G = Map<C, S>::G;
  constexpr bool kSliced = sliced(Arch, C);
  extern __shared__ __align__(16) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Layout s = layout<Arch>(p);
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / p.N;
  const int t0 = rank * p.R;
  const int nr = imax(0, imin(p.R, p.T - t0));  // frames this block owns
  const int sh = threadIdx.x % S;             // the half of the depth
  const int q = (threadIdx.x / S) % Q;        // the channel quad
  // the rows g + j G; a thread past the map (C = 48) is idle: `owner`
  // false, its loads those of group G - 1
  const int g = Map<C, S>::kExact ? threadIdx.x / (S * Q)
                                  : imin(threadIdx.x / (S * Q), G - 1);
  const bool owner = Map<C, S>::kExact || threadIdx.x < G * S * Q;
  const bool stream = a.cache_in != nullptr;
  const int T = p.T, P = p.P;
  // block 0 of the smem plan finds its whole halo in the window: the
  // cache by the copy engine (streaming) or zeros (offline)
  const bool own_halo = p.mode == kSmem && rank == 0;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm + s.bar);

  float* ta = sm + s.ta;
  float4* ta4 = reinterpret_cast<float4*>(ta);
  float4* out4 = reinterpret_cast<float4*>(a.out) +
                 static_cast<size_t>(row) * T * Q;
  const float4* x4 = reinterpret_cast<const float4*>(a.x) +
                     static_cast<size_t>(row) * T * Q;
  float4* act_g4 = reinterpret_cast<float4*>(a.act) +
                   static_cast<size_t>(row) * 2 * T * Q;
  // the window of layer l's input: l odd -> 0, l even -> 1 (layer l's
  // output goes to the other); the one staging window of kStaged, kTaps
  auto window = [&](int l) {
    return sm + s.win + (p.mode == kSmem ? ((l + 1) & 1) * s.wspan : 0);
  };
  unsigned subtiles = 0;  // this block's sub-tiles so far (sliced W)

  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    if constexpr (kSliced) {
      mbar_init(bars + 2);
      mbar_init(bars + 3);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (own_halo && !stream) {  // the zero left context, once
    for (int i = threadIdx.x; i < P * C; i += kThreads) {
      sm[s.win + i] = 0.f;
      sm[s.win + s.wspan + i] = 0.f;
    }
  }
  if constexpr (Arch == kMdtc) {  // the stack outputs are summed into out
    for (int i = threadIdx.x; i < nr * Q; i += kThreads) {
      out4[static_cast<size_t>(t0) * Q + i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    issue_layer<Arch, C>(a, p, s, sm, window(0), 0, row, t0, nr,
                         stream && own_halo, bars);
    if (p.nbuf == 2 && p.L > 1) {
      issue_layer<Arch, C>(a, p, s, sm + s.wsize, window(1), 1, row, t0, nr,
                           stream && own_halo, bars + 1);
    }
  }

  for (int l = 0; l < p.L; ++l) {
    const int d = dil.d[l];
    const int H = (p.K - 1) * d;
    // layer l - 1's rows are in place in every block of the cluster, and
    // every read of what this layer's copies and stores overwrite is done
    cluster.sync();
    const int buf = p.nbuf == 2 ? (l & 1) : 0;
    if (p.nbuf == 2 && l >= 1 && l + 1 < p.L && threadIdx.x == 0) {
      issue_layer<Arch, C>(a, p, s, sm + ((l + 1) & 1) * s.wsize,
                           window(l + 1), l + 1, row, t0, nr,
                           stream && own_halo, bars + ((l + 1) & 1));
    }
    // this layer's group has landed
    mbar_wait(bars + buf, p.nbuf == 2 ? (l >> 1) & 1 : l & 1);
    const float* wl = sm + buf * s.wsize;
    const float* w1 = wl;
    const float* w2 = wl + s.w2;
    const float4* dw4 = reinterpret_cast<const float4*>(wl + s.dw);
    const float4* bias4 = reinterpret_cast<const float4*>(wl + s.bias);
    const float4* cache_g4 =
        stream ? reinterpret_cast<const float4*>(a.cache_in) +
                     (static_cast<size_t>(l) * p.batch + row) * P * Q
               : nullptr;
    float4* cache_o4 =
        stream ? reinterpret_cast<float4*>(a.cache_out) +
                     (static_cast<size_t>(l) * p.batch + row) * P * Q
               : nullptr;
    float* win = window(l);
    float4* win4 = reinterpret_cast<float4*>(win);
    // the other window: this layer's output (smem plan)
    float4* nxt4 = reinterpret_cast<float4*>(window(l + 1));
    const float4* in_g4 = act_g4 + static_cast<size_t>((l + 1) & 1) * T * Q;
    float4* out_g4 = act_g4 + static_cast<size_t>(l & 1) * T * Q;
    const bool accumulate =
        Arch == kMdtc && l > 0 && (l % p.stack_size) == 0;
    // DS-TCN's output is its last layer's
    const bool last_out = Arch == kDsTcn && l == p.L - 1;

    // layer l's input row t (t < 0: the left context), from wherever it
    // lies; rows of other blocks after the cluster barrier
    auto input_row = [&](int t, int qq) -> float4 {
      if (t < 0) {
        return stream ? __ldg(cache_g4 + (P + t) * Q + qq)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (l == 0) return __ldg(x4 + static_cast<size_t>(t) * Q + qq);
      if (p.mode == kSmem) {
        const int o = t / p.R;
        float* src = window(l);
        if (o != rank) src = cluster.map_shared_rank(src, o);
        return reinterpret_cast<const float4*>(src)[(P + t - o * p.R) * Q +
                                                    qq];
      }
      return __ldcg(in_g4 + static_cast<size_t>(t) * Q + qq);
    };
    // rows [first, first + count) of the input into window rows from
    // `at`, four float4s a thread in flight before any is stored
    auto fill = [&](int first, int count, int at) {
      const int total = count * Q;
      for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          v[u] = i < total ? input_row(first + i / Q, i % Q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          if (i < total) win4[(at + i / Q) * Q + i % Q] = v[u];
        }
      }
    };

    if (nr == 0) {
      // no frames here (a short utterance over a wide cluster)
    } else if (p.mode == kSmem) {
      if (!own_halo) fill(t0 - H, H, P - H);
      if (stream) {  // the new cache: the last P rows of [cache | input]
        if (rank == 0) {
          for (int i = threadIdx.x; i < (P - T) * Q; i += kThreads) {
            cache_o4[i] = win4[T * Q + i];
          }
        }
        const int first = imax(t0, T - P);
        for (int i = threadIdx.x; i < (t0 + nr - first) * Q; i += kThreads) {
          const int t = first + i / Q;
          cache_o4[(t - (T - P)) * Q + i % Q] =
              win4[(P + t - t0) * Q + i % Q];
        }
      }
    } else if (stream && rank == 0) {
      for (int i = threadIdx.x; i < (P - T) * Q; i += kThreads) {
        cache_o4[i] = cache_g4[static_cast<size_t>(T) * Q + i];
      }
    }

    for (int s0 = t0; s0 < t0 + nr; s0 += p.TR) {
      const int n = imin(p.TR, t0 + nr - s0);
      if constexpr (kSliced) {
        // the first two slices of W, in flight during the window and the
        // conv (the last sub-tile's product has read the ring)
        if (threadIdx.x == 0) {
          const float* wg = a.pw1_w + static_cast<size_t>(l) * C * C;
          issue_slice<C>(sm + s.ring, wg, 0, bars + 2);
          issue_slice<C>(sm + s.ring + kSliceRows * C, wg, 1, bars + 3);
        }
      }
      // tap j of the conv reads frame s0 + r at window row tap0 + j step +
      // r: in the windows of kSmem and kStaged frame s0 - back sits back
      // rows before frame s0; kTaps stages each tap's n rows in a slice
      // of its own, tap j at TR j
      const float4* tap0;
      int step = d * Q;
      if (p.mode == kSmem) {
        tap0 = win4 + (P + s0 - t0 - (p.K - 1) * d) * Q;
      } else if (p.mode == kStaged) {
        tap0 = win4 + (P - (p.K - 1) * d) * Q;
        fill(s0 - H, H + n, P - H);
      } else {
        tap0 = win4;
        step = p.TR * Q;
        for (int tap = 0; tap < p.K; ++tap) {
          fill(s0 - (p.K - 1 - tap) * d, n, tap * p.TR);
        }
      }
      // the input rows themselves (the last tap's): the residual
      const float4* xw = tap0 + (p.K - 1) * step;
      // the window is in place, and the last sub-tile's reads of ta are
      // done
      __syncthreads();
      if (p.mode != kSmem && stream) {  // the sub-tile's rows of the new cache
        const int first = imax(s0, T - P);
        for (int i = threadIdx.x; i < (s0 + n - first) * Q; i += kThreads) {
          const int t = first + i / Q;
          cache_o4[(t - (T - P)) * Q + i % Q] = xw[(t - s0) * Q + i % Q];
        }
      }
      // causal dilated depthwise conv + bias (both halves of a pair of
      // threads compute and store the same values), DS-TCN's ReLU
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int r = g + j * G;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < n) {
          const float4* xr = tap0 + r * Q + q;
#pragma unroll
          for (int tap = 0; tap < kMaxTaps; ++tap) {
            if (tap < p.K) v = fma4(xr[tap * step], dw4[tap * Q + q], v);
          }
          for (int tap = kMaxTaps; tap < p.K; ++tap) {
            v = fma4(xr[tap * step], dw4[tap * Q + q], v);
          }
          v = add4(v, bias4[q]);
          if constexpr (Arch == kDsTcn) v = relu4(v);
        }
        if (owner) ta4[r * LQ + q] = v;
      }
      __syncthreads();
      float4 acc[RJ];
      if constexpr (kSliced) {  // h W, W through the ring
        sliced_product<C, RJ, S>(ta, sm + s.ring,
                                 a.pw1_w + static_cast<size_t>(l) * C * C,
                                 bars + 2, subtiles++, g, q, sh, acc);
      } else {
        rows_product<C, RJ, S>(ta, w1, g, q, sh, acc);  // a W1 or h W
      }
      if constexpr (Arch == kMdtc) {
        __syncthreads();  // every read of the conv's tile is done
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          if (owner) {
            ta4[(g + j * G) * LQ + q] = relu4(add4(acc[j], bias4[Q + q]));
          }
        }
        __syncthreads();
        rows_product<C, RJ, S>(ta, w2, g, q, sh, acc);  // relu(a W1 + b1) W2
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int r = g + j * G;
        if (r < n && sh == 0 && owner) {
          const int t = s0 + r;
          // the residual: this layer's input row
          const float4 y =
              Arch == kMdtc
                  ? relu4(add4(add4(acc[j], bias4[2 * Q + q]), xw[r * Q + q]))
                  : add4(relu4(add4(acc[j], bias4[Q + q])), xw[r * Q + q]);
          if (last_out) {
            out4[static_cast<size_t>(t) * Q + q] = y;
          } else if (p.mode == kSmem) {
            nxt4[(P + t - t0) * Q + q] = y;
          } else {
            out_g4[static_cast<size_t>(t) * Q + q] = y;
          }
          if (accumulate) {
            float4* o = out4 + static_cast<size_t>(t) * Q + q;
            *o = add4(*o, y);
          }
        }
      }
    }
    if (p.nbuf == 1 && l + 1 < p.L) {
      __syncthreads();  // every read of the one weight buffer is done
      if (threadIdx.x == 0) {
        issue_layer<Arch, C>(a, p, s, sm, window(l + 1), l + 1, row, t0, nr,
                             stream && own_halo, bars);
      }
    }
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
}

template <int C, int RJ, int S>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<C, RJ>))
fused_mdtc_kernel(Ptrs a, Plan p, LayerDilations dil) {
  run_layers<kMdtc, C, RJ, S>(a, p, dil);
}

template <int C, int RJ, int S>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<C, RJ>))
fused_ds_tcn_kernel(Ptrs a, Plan p, LayerDilations dil) {
  run_layers<kDsTcn, C, RJ, S>(a, p, dil);
}

// Whether a cluster of this kernel's shape can be resident on this
// card, asked once per combination.
template <typename Kern>
bool cluster_fits(Kern kern, const cudaLaunchConfig_t& cfg) {
  static std::mutex mu;
  static const void* seen_kern[64];
  static size_t seen_smem[64];
  static int seen_n[64], seen_ok[64], n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  const void* key = reinterpret_cast<const void*>(kern);
  const int n = static_cast<int>(cfg.attrs[0].val.clusterDim.x);
  for (int i = 0; i < n_seen; ++i) {
    if (seen_kern[i] == key && seen_smem[i] == cfg.dynamicSmemBytes &&
        seen_n[i] == n) {
      return seen_ok[i] != 0;
    }
  }
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it; the launch reports its own
    clusters = 0;
  }
  if (n_seen < 64) {
    seen_kern[n_seen] = key;
    seen_smem[n_seen] = cfg.dynamicSmemBytes;
    seen_n[n_seen] = n;
    seen_ok[n_seen] = clusters > 0;
    ++n_seen;
  }
  return clusters > 0;
}

// the entry of the layer Arch at (C, RJ, S)
template <int Arch, int C, int RJ, int S>
auto kernel_of() {
  if constexpr (Arch == kMdtc) {
    return fused_mdtc_kernel<C, RJ, S>;
  } else {
    return fused_ds_tcn_kernel<C, RJ, S>;
  }
}

// f(kernel) for the kernel of (Arch, C, rows_per_thread, splits), else
// bad.  Rows a thread: 1 to 4 (splits 2: 1); where W streams in slices
// also 6, 8 and 9, so that one sub-tile covers a block's frames and each
// slice of W serves them all.
template <int Arch, int C, typename F>
int with_map(int rows_per_thread, int splits, int bad, F&& f) {
  if (splits == 2) {
    return rows_per_thread == 1 ? f(kernel_of<Arch, C, 1, 2>()) : bad;
  }
  if (splits != 1) return bad;
  switch (rows_per_thread) {
    case 1: return f(kernel_of<Arch, C, 1, 1>());
    case 2: return f(kernel_of<Arch, C, 2, 1>());
    case 3: return f(kernel_of<Arch, C, 3, 1>());
    case 4: return f(kernel_of<Arch, C, 4, 1>());
    default: break;
  }
  if constexpr (sliced(Arch, C)) {
    switch (rows_per_thread) {
      case 6: return f(kernel_of<Arch, C, 6, 1>());
      case 8: return f(kernel_of<Arch, C, 8, 1>());
      case 9: return f(kernel_of<Arch, C, 9, 1>());
      default: break;
    }
  }
  return bad;
}

// the widths each layer takes: MDTC 32, 64, 128, DS-TCN also 48 and 256
template <int Arch, typename F>
int with_kernel(int C, int rows_per_thread, int splits, int bad, F&& f) {
  switch (C) {
    case 32: return with_map<Arch, 32>(rows_per_thread, splits, bad, f);
    case 64: return with_map<Arch, 64>(rows_per_thread, splits, bad, f);
    case 128: return with_map<Arch, 128>(rows_per_thread, splits, bad, f);
    default: break;
  }
  if constexpr (Arch == kDsTcn) {
    if (C == 48) return with_map<Arch, 48>(rows_per_thread, splits, bad, f);
    if (C == 256) {
      return with_map<Arch, 256>(rows_per_thread, splits, bad, f);
    }
  }
  return bad;
}

template <typename Kern>
int launch(Kern kern, const Ptrs& a, const Plan& p, const LayerDilations& dil,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.batch * p.N, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!cluster_fits(kern, cfg)) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, kern, a, p, dil);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Plan make_plan(int batch, int T, int C, int L, int K, int stack_size,
               int pad_max, int N, int rows_per_thread, int splits,
               int mode, int nbuf) {
  Plan p;
  p.batch = batch;
  p.T = T;
  p.C = C;
  p.L = L;
  p.K = K;
  p.stack_size = stack_size;
  p.P = pad_max;
  p.N = N;
  p.R = N > 0 ? (T + N - 1) / N : 0;
  p.TR = C >= 4 && splits >= 1 ? kThreads / (splits * (C / 4)) *
                                      rows_per_thread
                                : 0;
  p.mode = mode;
  p.nbuf = nbuf;
  return p;
}

template <int Arch>
int smem_bytes(int T, int C, int K, int pad_max, int N, int rows_per_thread,
               int splits, int mode, int nbuf) {
  const Plan p = make_plan(1, T, C, 1, K, 1, pad_max, N, rows_per_thread,
                           splits, mode, nbuf);
  return static_cast<int>(sizeof(float)) * layout<Arch>(p).total;
}

// Checks the arguments and launches the layer Arch's kernel (the
// contract of fused_mdtc_launch below).
template <int Arch>
int launch_layers(const Ptrs& a, int batch, int T, int C, int L, int K,
                  int stack_size, int pad_max, const int* dilations, int N,
                  int rows_per_thread, int splits, int mode, int nbuf,
                  int smem_floor, void* stream) {
  const bool streaming = a.cache_in != nullptr;
  if (L < 1 || L > kMaxLayers || batch < 1 || T < 1 || K < 1 ||
      stack_size < 1 || pad_max < 0 ||
      streaming != (a.cache_out != nullptr) ||
      N < 1 || N > 8 || rows_per_thread < 1 || splits < 1 ||
      (nbuf != 1 && nbuf != 2) || mode < kSmem || mode > kTaps ||
      (mode != kSmem && a.act == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayerDilations dil;
  for (int l = 0; l < L; ++l) {
    dil.d[l] = dilations[l];
    if (dilations[l] < 1 || (K - 1) * dilations[l] > pad_max) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Plan p = make_plan(batch, T, C, L, K, stack_size, pad_max, N,
                           rows_per_thread, splits, mode, nbuf);
  size_t smem = sizeof(float) * static_cast<size_t>(layout<Arch>(p).total);
  if (smem > kMaxSmem || smem_floor < 0 || smem_floor > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem < static_cast<size_t>(smem_floor)) smem = smem_floor;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_kernel<Arch>(
      C, rows_per_thread, splits, static_cast<int>(cudaErrorInvalidValue),
      [&](auto kern) { return launch(kern, a, p, dil, smem, s); });
}

// How many clusters of N blocks of the layer Arch's kernel can be
// resident at once (cudaOccupancyMaxActiveClusters; a negative
// cudaError_t code on failure).
template <int Arch>
int max_clusters(int C, int rows_per_thread, int splits, int N,
                 int smem_bytes) {
  auto query = [&](auto kern) -> int {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = N;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(N, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    return err == cudaSuccess ? clusters : -static_cast<int>(err);
  };
  if (N < 1 || N > 8 || smem_bytes < 0 || smem_bytes > kMaxSmem) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return with_kernel<Arch>(C, rows_per_thread, splits,
                           -static_cast<int>(cudaErrorInvalidValue), query);
}

Ptrs make_ptrs(const void* x, const void* cache_in, const void* dw_w,
               const void* dw_b, const void* pw1_w, const void* pw1_b,
               const void* pw2_w, const void* pw2_b, void* out,
               void* cache_out, void* act) {
  Ptrs a;
  a.x = static_cast<const float*>(x);
  a.cache_in = static_cast<const float*>(cache_in);
  a.dw_w = static_cast<const float*>(dw_w);
  a.dw_b = static_cast<const float*>(dw_b);
  a.pw1_w = static_cast<const float*>(pw1_w);
  a.pw1_b = static_cast<const float*>(pw1_b);
  a.pw2_w = static_cast<const float*>(pw2_w);
  a.pw2_b = static_cast<const float*>(pw2_b);
  a.out = static_cast<float*>(out);
  a.cache_out = static_cast<float*>(cache_out);
  a.act = static_cast<float*>(act);
  return a;
}

}  // namespace

extern "C" {

// Bytes of shared memory one block takes under this plan, for the
// wrapper's check (ops/fused_mdtc.py `mdtc_smem_bytes` mirrors it).
int fused_mdtc_smem_bytes(int T, int C, int K, int pad_max, int N,
                          int rows_per_thread, int splits, int mode,
                          int nbuf) {
  return smem_bytes<kMdtc>(T, C, K, pad_max, N, rows_per_thread, splits,
                           mode, nbuf);
}

int fused_ds_tcn_smem_bytes(int T, int C, int K, int pad_max, int N,
                            int rows_per_thread, int splits, int mode,
                            int nbuf) {
  return smem_bytes<kDsTcn>(T, C, K, pad_max, N, rows_per_thread, splits,
                            mode, nbuf);
}

// Returns a cudaError_t code (0 on success), or -2 when no cluster of N
// blocks with this shared memory can be resident on the card.  The plan
// (ops/fused_mdtc.py `mdtc_plan`): N blocks a batch row (1 to 8),
// rows_per_thread (1 to 4; 6, 8, 9 too with W in slices) and splits (1,
// or 2 with one row: halves of the reduction depth) of the thread map
// (Map), mode (kSmem: layer
// windows in shared memory; kStaged, kTaps: the outputs in `act`, batch
// * 2 * T * C floats of scratch, each sub-tile's window staged, or each
// tap's rows of it),
// nbuf (1 or 2 weight buffers), smem_floor (bytes of shared memory a
// block takes at least: above half an SM's, one block an SM).  Every
// pointer is 16-byte aligned (bulk copies).  Cache pointers are both
// null (whole utterance, zero left context) or both set (streaming).
// C in {32, 64, 128}.
int fused_mdtc_launch(const void* x, const void* cache_in, const void* dw_w,
                      const void* dw_b, const void* pw1_w, const void* pw1_b,
                      const void* pw2_w, const void* pw2_b, void* out,
                      void* cache_out, void* act, int batch, int T, int C,
                      int L, int K, int stack_size, int pad_max,
                      const int* dilations, int N, int rows_per_thread,
                      int splits, int mode, int nbuf, int smem_floor,
                      void* stream) {
  return launch_layers<kMdtc>(
      make_ptrs(x, cache_in, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b, out,
                cache_out, act),
      batch, T, C, L, K, stack_size, pad_max, dilations, N, rows_per_thread,
      splits, mode, nbuf, smem_floor, stream);
}

// The DS-TCN chain (ops/fused_tcn.py `fused_ds_tcn`), on the same plan
// (ops/fused_mdtc.py `mdtc_plan(..., arch="ds_tcn")`) and the same
// contract; always streaming (both cache pointers set); C in {32, 48,
// 64, 128, 256}.
int fused_ds_tcn_launch(const void* x, const void* cache_in,
                        const void* dw_w, const void* dw_b, const void* pw_w,
                        const void* pw_b, void* out, void* cache_out,
                        void* act, int batch, int T, int C, int L, int K,
                        int pad_max, const int* dilations, int N,
                        int rows_per_thread, int splits, int mode, int nbuf,
                        int smem_floor, void* stream) {
  if (cache_in == nullptr || cache_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_layers<kDsTcn>(
      make_ptrs(x, cache_in, dw_w, dw_b, pw_w, pw_b, nullptr, nullptr, out,
                cache_out, act),
      batch, T, C, L, K, 1, pad_max, dilations, N, rows_per_thread, splits,
      mode, nbuf, smem_floor, stream);
}

// How many clusters of N blocks of the kernel planned for (C,
// rows_per_thread, splits) can be resident at once on the current card
// with smem_bytes of shared memory a block (cudaOccupancyMaxActiveClusters;
// a negative cudaError_t code on failure).  The wrapper asks before it
// picks a cluster size.
int fused_mdtc_max_clusters(int C, int rows_per_thread, int splits, int N,
                            int smem_bytes) {
  return max_clusters<kMdtc>(C, rows_per_thread, splits, N, smem_bytes);
}

int fused_ds_tcn_max_clusters(int C, int rows_per_thread, int splits, int N,
                              int smem_bytes) {
  return max_clusters<kDsTcn>(C, rows_per_thread, splits, N, smem_bytes);
}

const char* fused_mdtc_error_string(int code) {
  if (code == kNoCluster) {
    return "no cluster of this size and shared memory can be resident "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
