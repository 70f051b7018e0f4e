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
// 0.54 GFLOP (8.2 us at 67 TFLOP/s fp32) against 3.8 MB (1.1 us at
// 3.35 TB/s): bound by operations.  The single-stream step B=1, T=10 is
// bound by bytes: the four layers' weights (1.05 MB) against 5 MFLOP.
// One SM cannot pull 1 MB in less than about 9 us, so the single-block
// design this replaces (one block per batch row, 34 us a layer) could
// not get near either bound.
//
// Design: one thread-block CLUSTER of N blocks per batch row, on N
// neighbouring SMs, walking the layers in order (N = 8, portable; 16,
// non-portable, is an option).  Block k of the cluster owns
//   - the proj channels [k pc, (k + 1) pc) of PD and
//   - the affine output columns [k lc, (k + 1) lc) of LD,
// pc = round4(ceil(PD / N)), lc = round4(ceil(LD / N)) (ragged: the last
// owner's slice is shorter, later ones may be empty; `cluster_slice`,
// mirrored by ops/fused_fsmn.py `cluster_slices`).  It holds only its
// slices of the weights, about 1/N of each matrix (32 KB a layer at the
// recipe's widths), brought in for layer l + 1 while layer l computes
// (two weight buffers, so shared memory does not grow with L).  The
// matrices come packed (ops/fused_fsmn.py `pack_fsmn_weights`: each
// block's slices of a layer as two contiguous runs; build_fused_forward
// packs once) by two bulk copies of the copy engine (TMA) on an
// mbarrier: issuing the same bytes as `cp.async` copies from the
// matrices in place cost a B=1 call about 0.004 ms more on an H100
// (PERF.md §6).  The taps and the bias come by `cp.async`.
// The memory taps are per proj channel, so the window [cache; p], the
// taps and the new cache of a block's channels stay in its shared
// memory (window buffers swapped per time tile, the next layer's cache
// landing in a third): no scratch in device memory.  Per time tile of 16
// rows (the engine's chunk of 10 frames is one tile) a layer runs
//   a. the tile's rows of cur, whole, into shared memory (x or the
//      previous layer's `out` rows, from L2);
//   b. p[:, own] = cur @ proj_w[:, own] into the window;
//   c. o[:, own] from the taps, stored into EVERY block's o buffer
//      through distributed shared memory (the all-gather of o);
//   d. cluster.sync();
//   e. y[:, own] = relu(o @ aff_w[:, own] + b), written to `out` (which
//      is also the next layer's cur) or, when the whole chunk is one
//      tile and a layer follows, into every block's cur buffer through
//      distributed shared memory (the all-gather of y);
//   f. the window's last P rows move to the other buffer's front.
// The next layer's slices and cache are issued in step c of the first
// tile, where a block would otherwise only wait for its peers.  A layer
// ends on cluster.sync(), after its new cache is written.  The
// o buffer alternates between tiles, so a block that runs a tile ahead
// never overwrites an o that a peer still reads; out rows of a tile are
// written only after every block has read them (d).
// Products: a thread owns one output column, a strided set of the
// tile's rows and one of four splits of the reduction depth (depth 250
// is a chain of 250 FMAs otherwise); the four partial sums meet in
// shared memory and are added in split order.  Reduction depth is
// zero-padded to a multiple of 4 in shared memory only.  At 16 rows a
// block takes 111 KB at the recipe's widths, so two can share an SM and
// all 16 clusters of the offline batch are resident at once (at 32 rows
// they were not, and ran in two waves).  Registers decide the rest: a
// small batch runs a kernel planned for one block an SM (no spills), a
// larger one a kernel planned for two (kOneBlockBatch).  Everything is
// deterministic: no atomics, fixed summation order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // rows of a time tile
constexpr int kSplits = 4;  // splits of a product's reduction depth
constexpr int kMaxSmem = 232448;
constexpr int kMaxSlice = 32;  // widest column slice a block owns
constexpr int kNoCluster = -2;  // no cluster of this shape can be resident
// A batch of up to kOneBlockBatch rows runs the kernel planned for one
// block an SM (registers up to 255: none spilled, the products' depth
// loop unrolled twice); a larger one the kernel planned for two (128
// registers, the loop not unrolled), so that at the recipe's widths all
// of its clusters are resident at once.
constexpr int kOneBlockBatch = 8;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Dims {
  int batch, T, L, LD, PD, lorder, rorder, lstride, rstride;
  int P;      // rows of the carried window
  int N;      // blocks of a cluster
  int pc;     // proj channels a block owns (slice width, a multiple of 4)
  int lc;     // affine columns a block owns
  int ldp;    // LD padded to a multiple of 4
  int pdp;    // PD padded to a multiple of 4
};

// the slice width of one of N owners of n columns
__host__ __device__ inline int slice_width(int n, int N) {
  return round4((n + N - 1) / N);
}

// [begin, end) of owner k's slice
__host__ __device__ inline void cluster_slice(int n, int width, int k,
                                              int* begin, int* end) {
  *begin = imin(k * width, n);
  *end = imin((k + 1) * width, n);
}

// Shared-memory layout in floats; every offset is a multiple of 4.
struct Layout {
  int wsize;  // one weight buffer: proj slice, aff slice, wl, wr, bias
  int aff, wl, wr, bias;  // offsets inside a weight buffer
  int cur, obuf, win, part, bar, total;
};

__host__ __device__ inline Layout layout(const Dims& d) {
  constexpr int R = kRows;
  Layout s;
  const int wr_rows = d.rorder > 0 ? d.rorder : 1;
  s.aff = d.ldp * d.pc;
  s.wl = s.aff + d.pdp * d.lc;
  s.wr = s.wl + d.lorder * d.pc;
  s.bias = s.wr + wr_rows * d.pc;
  s.wsize = s.bias + d.lc;
  s.cur = 2 * s.wsize;                       // R x ldp
  s.obuf = s.cur + R * d.ldp;                // 2 x R x pdp
  s.win = s.obuf + 2 * R * d.pdp;            // 3 x (P + R) x pc
  s.part = s.win + 3 * (d.P + R) * d.pc;     // kSplits x R x kMaxSlice
  s.bar = s.part + kSplits * R * kMaxSlice;  // two mbarriers (16 bytes)
  s.total = s.bar + 4;
  return s;
}

size_t smem_bytes(const Dims& d) {
  return sizeof(float) * static_cast<size_t>(layout(d).total);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// rows x cols floats from global (row stride gs) into shared memory (row
// stride ss), cols not above ss; copies of 16, 8 or 4 bytes, the widest
// that the addresses allow
__device__ __forceinline__ void copy_block(float* dst, int ss,
                                           const float* src, int gs, int rows,
                                           int cols) {
  if (rows <= 0 || cols <= 0) return;
  const size_t addr = reinterpret_cast<size_t>(src);
  if (((gs | cols) & 3) == 0 && (addr & 15) == 0) {
    const int per = cols / 4;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = 4 * (i - r * per);
      cp_async<16>(dst + r * ss + c, src + static_cast<size_t>(r) * gs + c);
    }
  } else if (((gs | cols) & 1) == 0 && (addr & 7) == 0) {
    const int per = cols / 2;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = 2 * (i - r * per);
      cp_async<8>(dst + r * ss + c, src + static_cast<size_t>(r) * gs + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      cp_async<4>(dst + r * ss + c, src + static_cast<size_t>(r) * gs + c);
    }
  }
}

// One layer's slices of the weights into a weight buffer: the packed
// matrices' (L, N, LD, pc) and (L, N, PD, lc) slices as two contiguous
// runs by the copy engine, completing on `bar` (thread 0 issues them),
// the taps and the bias by cp.async (not committed).
__device__ __forceinline__ void issue_weights(
    float* wb, const Layout& s, const Dims& d, int l, int rank, int p0,
    int c0, int pn, int cn, const float* proj_w, const float* wl,
    const float* wr, const float* aff_w, const float* aff_b,
    unsigned long long* bar) {
  const int wr_rows = d.rorder > 0 ? d.rorder : 1;
  if (threadIdx.x == 0) {
    const unsigned bp = sizeof(float) * d.LD * d.pc;
    const unsigned ba = sizeof(float) * d.PD * d.lc;
    mbar_expect(bar, bp + ba);
    bulk_copy(wb,
              proj_w + (static_cast<size_t>(l) * d.N + rank) * d.LD * d.pc,
              bp, bar);
    bulk_copy(wb + s.aff,
              aff_w + (static_cast<size_t>(l) * d.N + rank) * d.PD * d.lc,
              ba, bar);
  }
  copy_block(wb + s.wl, d.pc, wl + static_cast<size_t>(l) * d.lorder * d.PD +
             p0, d.PD, d.lorder, pn);
  copy_block(wb + s.wr, d.pc, wr + static_cast<size_t>(l) * wr_rows * d.PD +
             p0, d.PD, d.rorder, pn);
  copy_block(wb + s.bias, d.lc, aff_b + static_cast<size_t>(l) * d.LD + c0,
             d.LD, 1, cn);
}

// part[s][r][c] = sum over split s of the depth of in[r][k] w[k][c], for
// the live rows and the n columns; in at row stride ks, zero padded to
// depth kp (a multiple of 4); w at row stride wn.  A thread owns column
// c, rows g + j G and split s; neighbouring lanes take neighbouring
// columns of one row group and split, so the weight loads are
// conflict-free and the input rows are broadcasts.
template <int CL, int UNROLL>
__device__ __forceinline__ void product(const float* __restrict__ in, int ks,
                                        int kp, const float* __restrict__ w,
                                        int wn, int n, int live,
                                        float* __restrict__ part) {
  constexpr int R = kRows;
  constexpr int G = kThreads / (CL * kSplits);
  constexpr int RJ = R / G;
  const int c = threadIdx.x % CL;
  const int g = (threadIdx.x / CL) % G;
  const int s = threadIdx.x / (CL * G);
  if (c >= n || g >= live) return;
  const int kq = round4((kp + kSplits - 1) / kSplits);
  const int k0 = s * kq;
  const int k1 = imin(kp, k0 + kq);
  float acc[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) acc[j] = 0.f;
  // every row of the tile, live or not (the buffers hold R rows; the
  // dead rows' sums are dropped): no branch, so all loads of a step are
  // in flight together
#pragma unroll UNROLL
  for (int k = k0; k < k1; k += 4) {
    const float wa = w[k * wn + c];
    const float wb = w[(k + 1) * wn + c];
    const float wc = w[(k + 2) * wn + c];
    const float wd = w[(k + 3) * wn + c];
    float4 v[RJ];
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      v[j] = *reinterpret_cast<const float4*>(&in[(g + j * G) * ks + k]);
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      acc[j] = fmaf(v[j].x, wa, acc[j]);
      acc[j] = fmaf(v[j].y, wb, acc[j]);
      acc[j] = fmaf(v[j].z, wc, acc[j]);
      acc[j] = fmaf(v[j].w, wd, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    if (g + j * G < live) part[(s * R + g + j * G) * kMaxSlice + c] = acc[j];
  }
}

// the sum of the four splits of output (r, c), in split order
__device__ __forceinline__ float split_sum(const float* part, int r, int c) {
  float v = part[r * kMaxSlice + c];
#pragma unroll
  for (int s = 1; s < kSplits; ++s) {
    v += part[(s * kRows + r) * kMaxSlice + c];
  }
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

// the first n (1 to 4) floats of v to p, 16-byte aligned
__device__ __forceinline__ void store_n(float* p, float4 v, int n) {
  if (n >= 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
}

// split_sum of four neighbouring columns
__device__ __forceinline__ float4 split_sum4(const float* part, int r, int c) {
  float4 v = ld4(part + r * kMaxSlice + c);
#pragma unroll
  for (int s = 1; s < kSplits; ++s) {
    const float4 u = ld4(part + (s * kRows + r) * kMaxSlice + c);
    v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
  }
  return v;
}

// CLP / CLL: thread lanes over the owned proj channels / affine columns
// (16 or 32); MINB: blocks an SM the registers are planned for.
template <int CLP, int CLL, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
fused_fsmn_kernel(const float* x, const float* __restrict__ cache_in,
                  const float* __restrict__ proj_w,
                  const float* __restrict__ wl, const float* __restrict__ wr,
                  const float* __restrict__ aff_w,
                  const float* __restrict__ aff_b, float* out,
                  float* __restrict__ cache_out, Dims d) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / d.N;  // clusters are N consecutive blocks
  const int tid = threadIdx.x;
  constexpr int R = kRows;
  constexpr int kUnroll = MINB == 1 ? 2 : 1;
  const Layout s = layout(d);
  int p0, p1, c0, c1;
  cluster_slice(d.PD, d.pc, rank, &p0, &p1);
  cluster_slice(d.LD, d.lc, rank, &c0, &c1);
  const int pn = p1 - p0;
  const int cn = c1 - c0;
  const int T = d.T;
  const int P = d.P;
  const bool one_tile = T <= R;
  float* cur = sm + s.cur;
  float* part = sm + s.part;

  // zero the padding of the depths once, nothing else (a product's
  // rows past the live ones read whatever is there and are dropped):
  // rows LD .. ldp of the proj slices and PD .. pdp of the aff slices,
  // the columns past LD of cur and past PD of the o buffers
  for (int b = 0; b < 2; ++b) {
    float* wbz = sm + b * s.wsize;
    for (int i = tid; i < (d.ldp - d.LD) * d.pc; i += kThreads) {
      wbz[d.LD * d.pc + i] = 0.f;
    }
    for (int i = tid; i < (d.pdp - d.PD) * d.lc; i += kThreads) {
      wbz[s.aff + d.PD * d.lc + i] = 0.f;
    }
  }
  for (int i = tid; i < R * (d.ldp - d.LD); i += kThreads) {
    const int r = i / (d.ldp - d.LD);
    cur[r * d.ldp + d.LD + i - r * (d.ldp - d.LD)] = 0.f;
  }
  for (int i = tid; i < 2 * R * (d.pdp - d.PD); i += kThreads) {
    const int r = i / (d.pdp - d.PD);
    sm[s.obuf + r * d.pdp + d.PD + i - r * (d.pdp - d.PD)] = 0.f;
  }
  // one barrier per weight buffer for the copy engine's packed slices
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm + s.bar);
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Three window buffers: layer l walks its tiles in buffers l % 3 and
  // (l + 2) % 3 while layer l + 1's carried cache lands in (l + 1) % 3.
  float* wins = sm + s.win;
  const int wspan = (P + R) * d.pc;
  const float* xr = x + static_cast<size_t>(row) * T * d.LD;
  // the first group: layer 0's slices and carried cache, and the rows of
  // its first tile of x
  issue_weights(sm, s, d, 0, rank, p0, c0, pn, cn, proj_w, wl, wr, aff_w,
                aff_b, bars);
  copy_block(wins, d.pc, cache_in + static_cast<size_t>(row) * P * d.PD + p0,
             d.PD, P, pn);
  copy_block(cur, d.ldp, xr, d.LD, imin(R, T), d.LD);
  cp_async_commit();
  // no block writes into a peer's shared memory before the peer has
  // zeroed its padding
  cluster.sync();

  float* outr = out + static_cast<size_t>(row) * T * d.LD;
  const int start = (d.lorder - 1) * d.lstride;
  for (int l = 0; l < d.L; ++l) {
    float* wb = sm + (l & 1) * s.wsize;
    float* win = wins + (l % 3) * wspan;             // the current window
    float* win_next = wins + ((l + 2) % 3) * wspan;  // the other buffer
    cp_async_wait<0>();  // this layer's slices have landed (this thread's)
    mbar_wait(bars + (l & 1), (l >> 1) & 1);
    __syncthreads();     // (every thread's)
    const float* taps_l = wb + s.wl;
    const float* taps_r = wb + s.wr;

    for (int t0 = 0, tile = 0; t0 < T; t0 += R, ++tile) {
      const int live = imin(R, T - t0);
      // a. the tile's rows of cur, whole (layer 0's first tile came with
      // the first group)
      if ((l == 0 && tile > 0) || (l > 0 && !one_tile)) {
        // the previous layer's rows come from other blocks: read them
        // from L2 (__ldcg), never from this SM's L1
        const float* in = (l == 0 ? xr : outr) + static_cast<size_t>(t0) * d.LD;
#pragma unroll 4
        for (int i = tid; i < live * d.LD; i += kThreads) {
          const int r = i / d.LD, k = i - r * d.LD;
          cur[r * d.ldp + k] = __ldcg(in + i);
        }
        __syncthreads();
      }
      // b. p = cur @ proj_w[:, own] -> window rows P ..
      product<CLP, kUnroll>(cur, d.ldp, d.ldp, wb, d.pc, pn, live, part);
      __syncthreads();
      for (int i = tid; i < live * pn; i += kThreads) {
        const int r = i / pn, c = i - r * pn;
        win[(P + r) * d.pc + c] = split_sum(part, r, c);
      }
      __syncthreads();
      // c. the memory taps of the own channels, four a thread, into
      // every block's o (16-byte stores; the ragged last quad stores only
      // its own channels)
      float* obuf = sm + s.obuf + (tile & 1) * R * d.pdp;
      const int pq = (pn + 3) / 4;
      for (int i = tid; i < live * pq; i += kThreads) {
        const int r = i / pq, c = 4 * (i - r * pq);
        const float* e = win + r * d.pc + c;
        float4 v = ld4(e + start * d.pc);  // identity path
        for (int j = 0; j < d.lorder; ++j) {
          v = fma4(ld4(e + j * d.lstride * d.pc), ld4(taps_l + j * d.pc + c),
                   v);
        }
        for (int j = 0; j < d.rorder; ++j) {
          v = fma4(ld4(e + (start + d.rstride + j * d.rstride) * d.pc),
                   ld4(taps_r + j * d.pc + c), v);
        }
        for (int k = 0; k < d.N; ++k) {
          store_n(cluster.map_shared_rank(obuf, k) + r * d.pdp + p0 + c, v,
                  pn - c);
        }
      }
      if (tile == 0 && l + 1 < d.L) {  // the next layer's slices and cache
        issue_weights(sm + ((l + 1) & 1) * s.wsize, s, d, l + 1, rank, p0,
                      c0, pn, cn, proj_w, wl, wr, aff_w, aff_b,
                      bars + ((l + 1) & 1));
        copy_block(wins + ((l + 1) % 3) * wspan, d.pc,
                   cache_in +
                       (static_cast<size_t>(l + 1) * d.batch + row) * P *
                           d.PD +
                       p0,
                   d.PD, P, pn);
        cp_async_commit();
      }
      // d. every block's slice of o has landed, and every block has read
      // this tile's rows of cur
      cluster.sync();
      // e. y = relu(o @ aff_w[:, own] + b)
      product<CLL, kUnroll>(obuf, d.pdp, d.pdp, wb + s.aff, d.lc, cn, live,
                            part);
      __syncthreads();
      const float* bias = wb + s.bias;
      if (one_tile && l + 1 < d.L) {  // into every block's cur, 4 a thread
        const int cq = (cn + 3) / 4;
        for (int i = tid; i < live * cq; i += kThreads) {
          const int r = i / cq, c = 4 * (i - r * cq);
          const float4 u = split_sum4(part, r, c);
          const float4 b = ld4(bias + c);
          const float4 v = make_float4(
              fmaxf(u.x + b.x, 0.f), fmaxf(u.y + b.y, 0.f),
              fmaxf(u.z + b.z, 0.f), fmaxf(u.w + b.w, 0.f));
          for (int k = 0; k < d.N; ++k) {
            store_n(cluster.map_shared_rank(cur, k) + r * d.ldp + c0 + c, v,
                    cn - c);
          }
        }
      } else {
        for (int i = tid; i < live * cn; i += kThreads) {
          const int r = i / cn, c = i - r * cn;
          outr[static_cast<size_t>(t0 + r) * d.LD + c0 + c] =
              fmaxf(split_sum(part, r, c) + bias[c], 0.f);
        }
      }
      // f. the window's last P rows to the front of the other buffer
      for (int i = tid; i < P * pn; i += kThreads) {
        const int r = i / pn, c = i - r * pn;
        win_next[r * d.pc + c] = win[(live + r) * d.pc + c];
      }
      __syncthreads();
      float* tmp = win;
      win = win_next;
      win_next = tmp;
    }
    // the new cache: the last P rows of [cache; p] (with T < P, old
    // cache rows and new frames)
    float* co =
        cache_out + (static_cast<size_t>(l) * d.batch + row) * P * d.PD + p0;
    for (int i = tid; i < P * pn; i += kThreads) {
      const int r = i / pn, c = i - r * pn;
      co[static_cast<size_t>(r) * d.PD + c] = win[r * d.pc + c];
    }
    // this layer's y is everywhere (out, or every block's cur), and no
    // block still reads the weight buffer the next prefetch overwrites
    cluster.sync();
  }
}

// Whether a cluster of this kernel, shared memory and size fits on the
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

template <int CLP, int CLL, int MINB>
int launch(const float* x, const float* cache_in, const float* proj_w,
           const float* wl, const float* wr, const float* aff_w,
           const float* aff_b, float* out, float* cache_out, const Dims& d,
           cudaStream_t stream) {
  auto kern = fused_fsmn_kernel<CLP, CLL, MINB>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d.N > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(d.batch * d.N, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!cluster_fits(kern, cfg)) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, kern, x, cache_in, proj_w, wl, wr, aff_w,
                           aff_b, out, cache_out, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Dims make_dims(int batch, int T, int L, int LD, int PD, int lorder,
               int rorder, int lstride, int rstride, int N) {
  Dims d;
  d.batch = batch;
  d.T = T;
  d.L = L;
  d.LD = LD;
  d.PD = PD;
  d.lorder = lorder;
  d.rorder = rorder;
  d.lstride = lstride;
  d.rstride = rstride;
  d.P = (lorder - 1) * lstride + rorder * rstride;
  d.N = N;
  d.pc = slice_width(PD, N);
  d.lc = slice_width(LD, N);
  d.ldp = round4(LD);
  d.pdp = round4(PD);
  return d;
}

}  // namespace

extern "C" {

// Shared memory one block needs at these widths and cluster size, for
// the wrapper's check.
int fused_fsmn_smem_bytes(int LD, int PD, int lorder, int rorder,
                          int lstride, int rstride, int N) {
  return static_cast<int>(smem_bytes(make_dims(
      1, 1, 1, LD, PD, lorder, rorder, lstride, rstride, N)));
}

// Returns a cudaError_t code (0 on success), or -2 when no cluster of N
// blocks with this shared memory can be resident on the card.  `out`
// (batch, T, LD) is also the inter-layer buffer.  N is 8 or 16; proj_w
// (L, N, LD, pc) and aff_w (L, N, PD, lc) hold each block's slices
// contiguously (ops/fused_fsmn.py `pack_fsmn_weights`).
int fused_fsmn_launch(const void* x, const void* cache_in, const void* proj_w,
                      const void* wl, const void* wr, const void* aff_w,
                      const void* aff_b, void* out, void* cache_out,
                      int batch, int T, int L, int LD, int PD, int lorder,
                      int rorder, int lstride, int rstride, int N,
                      void* stream) {
  if (batch < 1 || T < 1 || L < 1 || LD < 1 || LD > 256 || PD < 1 ||
      PD > 256 || lorder < 1 || rorder < 0 || lstride < 1 || rstride < 1 ||
      (N != 8 && N != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims d = make_dims(batch, T, L, LD, PD, lorder, rorder, lstride,
                           rstride, N);
  if (smem_bytes(d) > kMaxSmem || d.pc > kMaxSlice || d.lc > kMaxSlice) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* cf = static_cast<const float*>(cache_in);
  const auto* pw = static_cast<const float*>(proj_w);
  const auto* lw = static_cast<const float*>(wl);
  const auto* rw = static_cast<const float*>(wr);
  const auto* aw = static_cast<const float*>(aff_w);
  const auto* ab = static_cast<const float*>(aff_b);
  auto* of = static_cast<float*>(out);
  auto* cof = static_cast<float*>(cache_out);
  const int lp = d.pc <= 16 ? 16 : 32;
  const int ll = d.lc <= 16 ? 16 : 32;
#define WEKWS_LAUNCH(A, B, M) \
  return launch<A, B, M>(xf, cf, pw, lw, rw, aw, ab, of, cof, d, s)
#define WEKWS_LANES(M)                            \
  if (lp == 16 && ll == 16) WEKWS_LAUNCH(16, 16, M); \
  if (lp == 16) WEKWS_LAUNCH(16, 32, M);             \
  if (ll == 16) WEKWS_LAUNCH(32, 16, M);             \
  WEKWS_LAUNCH(32, 32, M)
  if (batch <= kOneBlockBatch) {
    WEKWS_LANES(1);
  }
  WEKWS_LANES(2);
#undef WEKWS_LANES
#undef WEKWS_LAUNCH
}

const char* fused_fsmn_error_string(int code) {
  if (code == kNoCluster) {
    return "no cluster of this size and shared memory can be resident "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
