// The fused-MLP kernels for sm_90a: K2 (IDR colour head forward), K3 (its
// backward), K4 (background NeRF forward) and K5 (its backward).
//
// Replace vdnerf_tpu/ops/pallas/fused_mlp.py::render_net_fused (forward,
// _render_kernel_fwd; backward, _render_kernel_bwd) and ::nerf_fused
// (forward, _nerf_kernel_fwd; backward, _nerf_kernel_bwd).
//
// Two operand modes. The bf16 mode (JAX's fused path, these kernels' tiles)
// and, at the end of this file, the split-operand f32 mode (JAX's default
// f32 `linear`s: 3xTF32 products, one launch a layer).
//
// Numerics of the bf16 mode follow the Pallas kernels' _mm/_mm_dx/_mm_dw: every matmul
// operand is rounded to bf16 and products accumulate in f32; bias,
// activations, the heads' outputs, deltas before rounding, db and the input
// cotangents are f32. Because every consumer of an activation is a matmul,
// the tile's activations are kept in shared memory already rounded to bf16,
// which is exact with respect to that policy; the backward's relu masks read
// those stored bf16 activations, as the Pallas backward does.
//
// Bound: operations. A row of the background NeRF is 1.208 MFLOP of bf16
// matmul forward (K4) and 3x that backward (K5), against ~50 bytes of I/O; a
// row of the colour head 0.54 MFLOP forward (K2) against 1,072 bytes.
//
// All four share one tile design (below, "wgmma tile machinery"): every
// product is a wgmma on shared-memory operands with its accumulators in
// registers, the weights stream through one ring of shared-memory stages
// that both warpgroups read, and the epilogues (bias, relu, bf16 rounding into the next
// layer's input tile, relu-mask bits, db column sums) work on the registers.
// K2 and K4 run 128-row tiles (each warpgroup owns 64 rows and a full pass of
// up to 256 columns), so each weight slab is read from L2 once per 128 rows; K3 and
// K5 run 64-row tiles (the warpgroups split a pass's columns), because K5's
// backward state (masks, point-embedding cotangent) does not fit twice.
//
// Backward design. The Pallas backward sums dW/db across row tiles in one
// VMEM block that the TPU's sequential grid revisits; CTAs run concurrently,
// so that does not carry over. A backward is a tile kernel, then the dW
// contraction and two reductions (dw_finish_launch), with no float atomics,
// so its gradients repeat bit for bit run to run:
//  1. a tile kernel (one CTA per 64 rows) recomputes the forward, stores every
//     layer's bf16 input row block (the contraction's left operand) to a
//     scratch `acts` [n_pad, sum Kp], walks the layers in reverse computing
//     the f32 delta, its per-tile column sum (db partial, scratch
//     [n_tiles, sum Np]), its bf16 rounding (scratch `dels` [n_pad, sum Np])
//     and dx = delta @ W^T, applies the relu masks (kept as bits from the
//     forward), unstitches the concats and writes the input cotangents
//     through the embedding VJP (render_bwd_kernel, nerf_bwd_kernel);
//  2. dW_l = acts_l^T @ dels_l, a split-K tiled GEMM over the rows (dw_kernel,
//     its note below), partials to scratch [splits, sum Kp*Np];
//  3. reductions over splits (dW) and over row tiles (db, one warp per
//     column), each in a fixed order.
// Bound of K3 and of the contraction: K3 is operations-bound in bf16 (3x the
// forward's products, 0.108 ms at 65,536 rows); the contraction alone moves
// 310 MB of acts/dels at K3's shape (0.093 ms at 3.35 TB/s) for 36.5 GFLOP
// (0.037 ms), so it is bound by bytes. Scratch at this slice's shapes: K3 at
// 65,536 rows holds 174 MB of acts, 136 MB of dels, 4.3 MB of db partials and
// splits x 1.1 MB of dW partials; K5 at 16,896 rows 90 MB, 83 MB, 2.6 MB and
// splits x 2.5 MB. Padded rows carry a zero delta, so they add nothing to
// dW/db.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kMaxProds = 32;  // wgmma product passes of one tile

struct LayerDesc {
  int K, N, Kp, Np;
  long long woff, boff;
  int aoff, doff;  // backward: column offsets of the layer in `acts`, `dels`
};

struct Plan {
  int n_layers;
  LayerDesc L[kMaxLayers];
  int mode;         // K2: 0 idr, 1 no_view_dir, 2 no_normal
  int squeeze_out;  // K2: sigmoid (1) or relu (0) output
  int freqs_a;      // K2: view bands; K4: point bands
  int freqs_b;      // K4: view bands
  int d_a;          // K4: point dims (4 with the inverted sphere)
  int d_feat;       // K2: feature width
  unsigned skips;   // K4: trunk layers followed by the skip concat
  int trunk;        // K4: number of trunk layers
  int d_rgb, d_dpt; // K4: head widths
  int lda;          // the activation tile's row stride (elements)
  int e_a, e_b;     // embedding widths
  int act_w, del_w; // backward: widths of `acts` (sum Kp) and `dels` (sum Np)
  int total_b;      // sum Np: packed bias length
  long long total_w;  // sum Kp * Np: packed weight length
  int wf;           // K4/K5: feature width ([feature | alpha] is wf + 1 wide)
  // the tile's product passes in the order the kernel runs them: layer,
  // forward (0) or dx (1), first output column, output width
  int n_prod;
  unsigned char q_layer[kMaxProds], q_dx[kMaxProds];
  short q_n0[kMaxProds], q_w[kMaxProds];
  int q_off[kMaxProds];  // K2/K4/K5: the pass's first slab in the ring image (elements)
};

__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) & ~15; }

// value of column c of the positional encoding [x | sin f0 x | cos f0 x | ...]
__device__ __forceinline__ float embed_at(const float* x, int d, int c) {
  if (c < d) return x[c];
  const int j = c - d;
  const int band = j / (2 * d);
  const int is_cos = (j / d) & 1;
  const float v = x[j % d] * ldexpf(1.0f, band);
  return is_cos ? cosf(v) : sinf(v);
}

// VJP of the encoding for input dim j: demb(c) is the cotangent of column c
template <typename F>
__device__ __forceinline__ float embed_vjp(F demb, const float* x, int d, int j,
                                           int freqs) {
  float acc = demb(j);
  for (int b = 0; b < freqs; ++b) {
    const float f = ldexpf(1.0f, b);
    const float v = x[j] * f;
    acc = acc + f * (demb(d * (1 + 2 * b) + j) * cosf(v) -
                     demb(d * (2 + 2 * b) + j) * sinf(v));
  }
  return acc;
}

// K3's input tile: the mode's concat [pts | emb_view | normals | feat],
// element (r, c) stored at A[at(r, c)] (the wgmma core layout). The feature
// block, most of the row, is read with 16-byte loads, all of a thread's rows
// unrolled so that their loads are in flight together; a warp per row covers
// the few other columns.
template <typename At>
__device__ void render_input(const Plan& p, const float* __restrict__ pts,
                             const float* __restrict__ nrm,
                             const float* __restrict__ dirs,
                             const float* __restrict__ feat, int n, int row0,
                             bf16* A, At at) {
  const int e_view = p.e_a;
  const int use_view = p.mode != 1;
  const int use_nrm = p.mode != 2;
  const int K0 = p.L[0].K;
  const int c_feat = 3 + (use_view ? e_view : 0) + (use_nrm ? 3 : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = p.d_feat % 4 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  if (vec) {
    const int nv = p.d_feat / 4;
    for (int j = lane; j < nv; j += 32) {
      float4 f[kRows / kWarps];
#pragma unroll
      for (int i = 0; i < kRows / kWarps; ++i) {
        const int gr = row0 + warp + i * kWarps;
        f[i] = gr < n ? __ldg(reinterpret_cast<const float4*>(feat + (size_t)gr * p.d_feat) + j)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kRows / kWarps; ++i) {
        const int r = warp + i * kWarps;
        const int c = c_feat + 4 * j;
        A[at(r, c)] = __float2bfloat16(f[i].x);
        A[at(r, c + 1)] = __float2bfloat16(f[i].y);
        A[at(r, c + 2)] = __float2bfloat16(f[i].z);
        A[at(r, c + 3)] = __float2bfloat16(f[i].w);
      }
    }
  }
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    for (int c0 = lane; c0 < p.L[0].Kp; c0 += 32) {
      if (vec && c0 >= c_feat && c0 < c_feat + p.d_feat) continue;
      int c = c0;
      float v = 0.0f;
      if (gr < n && c < K0) {
        if (c < 3) {
          v = pts[gr * 3 + c];
        } else {
          c -= 3;
          if (use_view && c < e_view) {
            v = embed_at(dirs + gr * 3, 3, c);
          } else {
            if (use_view) c -= e_view;
            if (use_nrm && c < 3) {
              v = nrm[gr * 3 + c];
            } else {
              if (use_nrm) c -= 3;
              v = feat[(size_t)gr * p.d_feat + c];
            }
          }
        }
      }
      A[at(r, c0)] = __float2bfloat16(v);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma tile machinery (K2-K5): products on operands in shared memory
// ---------------------------------------------------------------------------
//
// Each product pass of a tile is [rows, Kin] x [Kin, Wout] -> [rows, Wout]
// f32: a forward layer l (A = the layer's bf16 input, B = W_l), or dx of a
// layer l (A = the bf16 delta, B = W_l^T). The passes are listed per kernel by
// the host (Plan::q_*), in the order the kernel runs them. A lives in shared
// memory (`Atile`), in wgmma's no-swizzle K-major layout: 8x8 core matrices
// of 128 contiguous bytes, the two core matrices of a k16 step 128 bytes
// apart (LBO), 8-row groups lda*16 bytes apart (SBO). B is the packed W_l
// ([Kp, Np], row-major) for both: the forward reads it MN-major (wgmma's
// transpose-B bit; a core matrix row is 8 output columns of one reduction
// row), dx K-major (a core matrix row is 8 reduction columns of one output
// row). Either way the core matrices of a slab sit at the same offsets,
// K-adjacent ones 128 bytes apart (LBO) and N-adjacent ones kKS*16 bytes
// apart (SBO), so one descriptor serves both. B streams through a 3-stage
// cp.async ring of kKS-row reduction slabs with 16-byte copies straight into
// the same core-matrix layout; the ring runs through all product passes of
// the tile, so each pass's first slabs load while the previous one finishes.
// Output columns are cut into 64-wide chunks, one m64n64k16 wgmma each,
// which stay in registers until the epilogue; a pass is at most 256 columns
// wide (wider products, such as the concat inputs' dx, run as several
// passes). How the two warpgroups share a pass is set by the chunks a
// warpgroup holds (TileMap): two (64 accumulator registers) in a 64-row tile,
// chunk c in warpgroup c % 2; four (128 registers) in a 128-row tile, where
// each warpgroup owns 64 rows. The wgmma issue between fence and wait is
// straight-line code per (chunks, k16 steps) variant, chosen by values the
// compiler sees as warpgroup-uniform; otherwise it serialises the wgmmas.
//
// A forward output column and the first pass of a dx output of the same
// width are owned by the same thread at the same register: the relu mask of
// every hidden layer is kept as one bit per accumulator register (maskw),
// with no reread of the stored activations. acts/dels go out with 16-byte
// stores from Atile; db column sums come from the registers (a fixed shuffle
// tree over the rows of a warp, then the four warps of the owning warpgroup
// in order).
//
// The ring's copies (Ring): K3's threads copy each slab from the packed W
// with 16-byte cp.async; K2, K4 and K5 fill a stage with one bulk copy
// (cp.async.bulk, the TMA engine without a tensor map) from a ring image the
// wrapper lays out stage by stage, completing on the stage's mbarrier: one
// instruction per 16 KB slab instead of 1,024. Not done here: wgmma's
// 128-byte-swizzled layouts, and TMA multicast of a slab to the CTAs of a
// cluster (which would halve the weights' L2 traffic again).

constexpr int kKS = 32;          // reduction rows per weight slab
constexpr int kChunk = 64;       // output columns per wgmma
constexpr int kMaxOut = 4 * kChunk;  // widest product pass: 256
constexpr int kSlab = kKS * kMaxOut;  // bf16 elements per ring stage
static_assert(kKS == 32, "rb_product issues one or two k16 steps per slab");

// The weight ring: ST stages of one slab each. Synchronous (K3): a slab's
// wgmma completes before the next barrier, and loads run ST - 1 slabs ahead
// into the stage just read. Asynchronous (K4, K5): a slab's wgmma stays in
// flight through the next slab's wait, barrier and load issue, so loads run
// ST - 2 slabs ahead into the stage read two slabs back, which every
// warpgroup has finished when it passes the barrier.
// The copies: 16-byte cp.async by every thread from the packed W (K3), or
// (BULK, K2, K4 and K5) one bulk asynchronous copy per slab, issued by one
// thread from a ring image that the wrapper lays out as the stages hold it
// (fused_mlp._ring_index), completing on the stage's mbarrier.
// The barrier between slabs is the CTA's, or (NAMED, K2) named barrier 1 of
// the kThreads threads that run the products, when the CTA has more.
template <int ST, bool ASYNC, bool BULK, bool NAMED = false>
struct Ring {
  static_assert(ST >= (ASYNC ? 3 : 2), "too few stages");
  static constexpr int kStages = ST;
  static constexpr bool kAsync = ASYNC;
  static constexpr bool kBulk = BULK;
  static constexpr int kLead = ASYNC ? ST - 2 : ST - 1;  // slabs loaded ahead
  __device__ static __forceinline__ void sync() {
    if constexpr (NAMED)
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    else
      __syncthreads();
  }
};
// one CTA per SM for K2, K4 and K5 (fused_mlp's render_launch_plan /
// nerf_launch_plan); the 128 accumulator registers a thread of a 128-row
// tile holds leave ptxas too few to keep a slab's wgmma in flight (it
// serialises them), so the rings of K2 and K4 are synchronous. K2's has five
// stages or three, as many as its second activation tile leaves room for (a
// launch argument: five for 304 padded inputs, three for 400), and a named
// barrier (its CTA has a third warpgroup that does not run the products)
using K3Ring = Ring<3, false, false>;  // two CTAs per SM
template <int ST>
using K2Ring = Ring<ST, false, true, true>;  // ST: fused_mlp.render_launch_plan's stages
using K4Ring = Ring<6, false, true>;
using K5Ring = Ring<6, true, true>;
static_assert(K4Ring::kStages == K5Ring::kStages, "nerf_launch_plan sizes one ring for both");

// How the two warpgroups of a CTA share a product pass, by the number NCH of
// 64-column chunks each holds in registers
template <int NCH>
struct TileMap {
  static_assert(NCH == 2 || NCH == 4, "a column split (2) or a row split (4)");
  static constexpr int kRows = NCH == 2 ? 64 : 128;
  // chunk index of the warpgroup's ci-th chunk
  __device__ static __forceinline__ int chunk(int wg, int ci) { return NCH == 2 ? wg + 2 * ci : ci; }
  // first tile row of the warpgroup
  __device__ static __forceinline__ int row0(int wg) { return NCH == 2 ? 0 : 64 * wg; }
  // the warpgroup's chunks among the first nch
  __device__ static __forceinline__ int mine(int nch, int wg) {
    return NCH == 2 ? (nch - wg + 1) / 2 : nch;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; with `bytes` = 0 the destination is zero-filled
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// wait for the phase of `bar` with this parity to complete; a stage that
// never lands is a fault (the kernel traps), not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i == (1LL << 26)) __trap();
}
// this thread's arrival on bar (release: its earlier writes are visible to
// a thread that waits for the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one thread: `bytes` from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], bf16 in, f32 accumulate; A K-major,
// B K-major (TB = 0) or MN-major (TB = 1)
template <int TB>
__device__ __forceinline__ void wgmma_64x64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// element offset of (m, k) in a no-swizzle K-major tile of `ld` columns
__device__ __forceinline__ int core_at(int m, int k, int ld) {
  return (m >> 3) * (ld << 3) + ((k >> 3) << 6) + ((m & 7) << 3) + (k & 7);
}

struct RbProd {
  const bf16* B;  // mn: Kin rows of ld bf16; else Wout rows of ld (= Kin)
  int Kin, Wout, ld;
  bool mn;
};

// product pass q of the tile (Plan::q_*): the forward reads W_l MN-major from
// column n0, dx reads W_l K-major from row n0
__device__ __forceinline__ RbProd rb_prod(const Plan& p, const bf16* W, int q) {
  const LayerDesc& d = p.L[p.q_layer[q]];
  const int n0 = p.q_n0[q];
  if (!p.q_dx[q]) return {W + d.woff + n0, d.Kp, p.q_w[q], d.Np, true};
  return {W + d.woff + (size_t)n0 * d.Np, d.Np, p.q_w[q], d.Np, false};
}

__device__ __forceinline__ int rb_slabs(const RbProd& pr) { return (pr.Kin + kKS - 1) / kKS; }

// one ring slab into `dst`: output columns n < Wout of B, reduction rows
// [k0, k0 + kKS), zero beyond Wout (up to a chunk multiple) and beyond Kin.
// Core matrix (n / 8, k / 8) of the slab sits at (n / 8) * kKS * 8 + (k / 8)
// * 64; within it row n % 8 (K-major) or row k % 8 (MN-major) holds 16 bytes.
__device__ void rb_load(const RbProd& pr, int k0, bf16* dst) {
  const int rows = (pr.Wout + kChunk - 1) / kChunk * kChunk;
  constexpr int kc_n = kKS / 8;
  for (int idx = threadIdx.x; idx < rows * kc_n; idx += kThreads) {
    if (pr.mn) {
      // a warp copies 8 reduction rows x 4 column groups: 64 contiguous bytes
      // of each row, and each 8 lanes fill one whole core matrix
      const int kr = (idx >> 5) % kc_n * 8 + (idx & 7);
      const int n = ((idx >> 5) / kc_n * 4 + ((idx >> 3) & 3)) * 8;
      const int k = k0 + kr;
      const bool ok = n < pr.Wout && k < pr.Kin;
      cp_async16_zfill(dst + (n >> 3) * (kc_n * 64) + kr * 8,
                       ok ? pr.B + (size_t)k * pr.ld + n : pr.B, ok ? 16 : 0);
    } else {
      const int n = idx / kc_n;
      const int kc = idx % kc_n;
      const int k = k0 + kc * 8;
      const bool ok = n < pr.Wout && k < pr.Kin;
      cp_async16_zfill(dst + (n >> 3) * (kc_n * 64) + kc * 64 + (n & 7) * 8,
                       ok ? pr.B + (size_t)n * pr.ld + k : pr.B, ok ? 16 : 0);
    }
  }
}

// The ring's producer side: the next slab to load, as (product pass q, slab
// i of it), advanced one slab per load; the pass list runs `reps` times (K2's
// CTA runs it once per tile)
struct RbCursor {
  int q, i, n_prod;
  uint64_t* bars;  // BULK: the stages' mbarriers
  int reps = 1;
  // the next slab into ring stage `stage` (BULK: one thread calls this)
  template <class RG>
  __device__ void load(const Plan& p, const bf16* W, bf16* ring, int stage) {
    if (q >= n_prod) return;
    const RbProd pr = rb_prod(p, W, q);
    if constexpr (RG::kBulk) {
      const int rows = (pr.Wout + kChunk - 1) / kChunk * kChunk;
      bulk_load(ring + stage * kSlab, W + p.q_off[q] + (size_t)i * rows * kKS,
                rows * kKS * (int)sizeof(bf16), bars + stage);
    } else {
      rb_load(pr, i * kKS, ring + stage * kSlab);
    }
    if (++i == rb_slabs(pr)) {
      i = 0;
      if (++q == n_prod && --reps > 0) q = 0;
    }
  }
  // BULK: the stages' mbarriers, before a barrier and the prologue
  template <class RG>
  __device__ void init() {
    if constexpr (RG::kBulk) {
      if (threadIdx.x == 0) {
        for (int j = 0; j < RG::kStages; ++j) mbar_init(bars + j, 1);
        mbar_init_fence();
      }
    }
  }
  // the ring's first slabs
  template <class RG>
  __device__ void prologue(const Plan& p, const bf16* W, bf16* ring) {
    for (int j = 0; j < RG::kLead; ++j) {
      if constexpr (RG::kBulk) {
        if (threadIdx.x == 0) load<RG>(p, W, ring, j);
      } else {
        load<RG>(p, W, ring, j);
        cp_async_commit();
      }
    }
  }
};

// NK k16 steps of a slab into the calling warpgroup's first NC chunks:
// straight-line code between the fence and the commit (and the wait, unless
// the ring is asynchronous), so that the compiler keeps the wgmma
// instructions asynchronous
template <bool ASYNC, int NCH, int NC, int NK, int TB>
__device__ __forceinline__ void rb_mma(float (&acc)[NCH][32], const bf16* Atile, int lda, int k0,
                                       const bf16* Bs, int wg) {
  const bf16* A = Atile + TileMap<NCH>::row0(wg) * lda;  // 8-row groups lda * 8 apart
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t da = wg_desc(A + (((k0 + kk * 16) >> 3) << 6), 128, lda * 16);
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      const uint64_t db = wg_desc(
          Bs + TileMap<NCH>::chunk(wg, ci) * 8 * (kKS / 8) * 64 + kk * 2 * 64, 128, kKS * 16);
      wgmma_64x64<TB>(acc[ci], da, db);
    }
  }
  wg_commit();
  if constexpr (!ASYNC) wg_wait<0>();
}

// the rb_mma variant for `mine` chunks of the calling warpgroup and a full
// (two k16 steps) or half slab
template <bool ASYNC, int NCH, int TB>
__device__ __forceinline__ void rb_mma_pick(int mine, bool full, float (&acc)[NCH][32],
                                            const bf16* Atile, int lda, int k0, const bf16* Bs,
                                            int wg) {
#define RB_CASE(M)                                                   \
  if (mine == M) {                                                   \
    if (full) rb_mma<ASYNC, NCH, M, 2, TB>(acc, Atile, lda, k0, Bs, wg); \
    else rb_mma<ASYNC, NCH, M, 1, TB>(acc, Atile, lda, k0, Bs, wg);      \
    return;                                                          \
  }
  RB_CASE(1)
  RB_CASE(2)
  if constexpr (NCH == 4) {
    RB_CASE(3)
    RB_CASE(4)
  }
#undef RB_CASE
}

// one product pass of the tile into the calling warpgroup's chunks; `s` is
// the running slab index (its ring stage is s % RG::kStages), `cur` loads the
// slab RG::kLead ahead
template <class RG, int NCH>
__device__ __forceinline__ void rb_product(const Plan& p, const bf16* W, int q, int& s,
                                           RbCursor& cur, bf16* ring, const bf16* Atile, int lda,
                                           float (&acc)[NCH][32]) {
  const RbProd pr = rb_prod(p, W, q);
  const int ns = rb_slabs(pr);
  const int nch = (pr.Wout + kChunk - 1) / kChunk;
  // the warpgroup index through a shuffle, so the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int mine = TileMap<NCH>::mine(nch, wg);
#pragma unroll
  for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[ci][i] = 0.0f;
  constexpr int ST = RG::kStages;
  for (int i = 0; i < ns; ++i, ++s) {
    if constexpr (RG::kBulk) {
      mbar_wait(cur.bars + s % ST, (s / ST) & 1);
    } else {
      cp_async_wait<RG::kLead - 1>();
      fence_async_smem();
    }
    if constexpr (RG::kAsync) wg_wait<1>();  // this warpgroup's slab s - 2 is done
    RG::sync();  // slab s landed; every warpgroup is done with the stage to load
    if constexpr (RG::kBulk) {
      if (threadIdx.x == 0) cur.load<RG>(p, W, ring, (s + RG::kLead) % ST);
    } else {
      cur.load<RG>(p, W, ring, (s + RG::kLead) % ST);
      cp_async_commit();
    }
    const bf16* Bs = ring + (s % ST) * kSlab;
    const int k0 = i * kKS;
    const bool full = pr.Kin - k0 >= kKS;
    if (pr.mn) rb_mma_pick<RG::kAsync, NCH, 1>(mine, full, acc, Atile, lda, k0, Bs, wg);
    else rb_mma_pick<RG::kAsync, NCH, 0>(mine, full, acc, Atile, lda, k0, Bs, wg);
  }
  if constexpr (RG::kAsync) wg_wait<0>();
}

// 64-row tiles: Atile[:, 0:width] -> dst[row0 + r, 0:width] (row stride ld),
// 16-byte stores; a warp's lanes cover 8 rows x 4 column groups of 8
__device__ void store_tile(const bf16* Atile, int lda, int width, bf16* dst, int ld, int row0) {
  const int n_kg = width >> 3;
  const int i8 = threadIdx.x & 7;
  for (int mb = 0; mb < kRows; mb += 8) {
    const int m = mb + i8;
    bf16* drow = dst + (size_t)(row0 + m) * ld;
    for (int kg = threadIdx.x >> 3; kg < n_kg; kg += kThreads / 8)
      *reinterpret_cast<uint4*>(drow + kg * 8) =
          *reinterpret_cast<const uint4*>(Atile + core_at(m, kg * 8, lda));
  }
}

// Loop over the accumulator registers of the calling thread that hold
// columns < width of a product pass's output, by pairs of adjacent columns
// (col even): f(ci, i, row, col, v0&, v1&), v0 in register i, v1 in i + 1
template <int NCH, typename F>
__device__ __forceinline__ void for_pairs(float (&acc)[NCH][32], int width, F f) {
  const int wg = threadIdx.x >> 7;
  const int q4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = TileMap<NCH>::row0(wg) + 16 * q4 + g;
#pragma unroll
  for (int ci = 0; ci < NCH; ++ci) {
    const int c0 = TileMap<NCH>::chunk(wg, ci) * kChunk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j * 8 < width) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(ci, j * 4 + 2 * h, r0 + h * 8, c0 + j * 8 + 2 * t, acc[ci][j * 4 + 2 * h],
            acc[ci][j * 4 + 2 * h + 1]);
      }
    }
  }
}

// the same one register at a time: f(ci, i, row, col, value&)
template <int NCH, typename F>
__device__ __forceinline__ void for_owned(float (&acc)[NCH][32], int width, F f) {
  for_pairs(acc, width, [&](int ci, int i, int r, int c, float& v0, float& v1) {
    f(ci, i, r, c, v0);
    f(ci, i + 1, r, c + 1, v1);
  });
}

// backward (64-row tiles), one layer's f32 delta in the registers, columns
// < Np: db partial column sums into `red`, the bf16 delta into Atile. The
// caller syncs, then calls emit_finish.
__device__ __forceinline__ void emit_regs(float (&acc)[2][32], int Np, bf16* Atile, int lda,
                                          float* red) {
  const int wg = threadIdx.x >> 7;
  const int q4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ci = 0; ci < 2; ++ci) {
    const int c0 = TileMap<2>::chunk(wg, ci) * kChunk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j * 8 < Np) {
        const int col = c0 + j * 8 + 2 * t;
        const float v0 = acc[ci][j * 4], v1 = acc[ci][j * 4 + 1];
        const float v2 = acc[ci][j * 4 + 2], v3 = acc[ci][j * 4 + 3];
        float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (g == 0) {
          red[q4 * kMaxOut + col] = s0;
          red[q4 * kMaxOut + col + 1] = s1;
        }
        const int r = 16 * q4 + g;
        *reinterpret_cast<__nv_bfloat162*>(Atile + core_at(r, col, lda)) =
            __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(Atile + core_at(r + 8, col, lda)) =
            __floats2bfloat162_rn(v2, v3);
      }
    }
  }
}

// after emit_regs and a barrier: db partial of the first `nreg` columns (the
// four warps in order) and the bf16 delta, all Np columns of Atile, out to
// `dels`
__device__ void emit_finish(const Plan& p, const LayerDesc& d, int nreg, const float* red,
                            const bf16* Atile, float* dbpart, bf16* dels, int row0) {
  for (int c = threadIdx.x; c < nreg; c += kThreads)
    dbpart[(size_t)blockIdx.x * p.total_b + d.boff + c] =
        ((red[c] + red[kMaxOut + c]) + red[2 * kMaxOut + c]) + red[3 * kMaxOut + c];
  store_tile(Atile, p.lda, d.Np, dels + d.doff, p.del_w, row0);
}

// K3: recompute, then g -> d(pts, normals, dirs, feat) and the per-layer
// deltas and db partials (dW follows in the contraction).
__global__ void __launch_bounds__(kThreads, 2)
render_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ dirs, const float* __restrict__ feat,
                  const float* __restrict__ g, float* __restrict__ d_pts,
                  float* __restrict__ d_nrm, float* __restrict__ d_dirs,
                  float* __restrict__ d_feat, int n,
                  const bf16* __restrict__ W, const float* __restrict__ B, Plan p, bf16* acts, bf16* dels,
                  float* dbpart) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using RG = K3Ring;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);               // [stages][kSlab]
  bf16* Atile = ring + RG::kStages * kSlab;                      // [64, lda] core
  uint32_t* maskw = reinterpret_cast<uint32_t*>(Atile + kRows * p.lda);
  float* red = reinterpret_cast<float*>(maskw + (p.n_layers - 1) * 2 * kThreads);
  float* Sv = red + 4 * kMaxOut;                                 // [64, e_a]

  const int L = p.n_layers;
  const int row0 = blockIdx.x * kRows;
  RbCursor cur{0, 0, p.n_prod, nullptr};
  cur.prologue<RG>(p, W, ring);
  render_input(p, pts, nrm, dirs, feat, n, row0, Atile,
               [&](int r, int c) { return core_at(r, c, p.lda); });
  fence_async_smem();
  __syncthreads();

  float acc[2][32];
  int s = 0;
  for (int l = 0; l < L; ++l) {
    const LayerDesc& d = p.L[l];
    store_tile(Atile, p.lda, d.Kp, acts + d.aoff, p.act_w, row0);
    rb_product<RG>(p, W, l, s, cur, ring, Atile, p.lda, acc);
    __syncthreads();  // every warpgroup is done reading Atile
    if (l + 1 == L) break;
    const float* bias = B + d.boff;
    uint32_t bits[2] = {0u, 0u};
    for_owned(acc, d.Np, [&](int ci, int i, int r, int c, float& v) {
      const bf16 h = __float2bfloat16(fmaxf(v + bias[c], 0.0f));
      Atile[core_at(r, c, p.lda)] = h;
      if (__bfloat162float(h) > 0.0f) bits[ci] |= 1u << i;
    });
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
      maskw[(l * 2 + ci) * kThreads + threadIdx.x] = bits[ci];
    fence_async_smem();
    __syncthreads();
  }

  // output delta: g * y * (1 - y) (sigmoid) or g * (y > 0) (relu)
  {
    const LayerDesc& o = p.L[L - 1];
    for_owned(acc, o.Np, [&](int, int, int r, int c, float& v) {
      const int gr = row0 + r;
      float dv = 0.0f;
      if (c < o.N && gr < n) {
        const float z = v + B[o.boff + c];
        const float gv = g[(size_t)gr * o.N + c];
        if (p.squeeze_out) {
          const float y = 1.0f / (1.0f + expf(-z));
          dv = gv * y * (1.0f - y);
        } else {
          dv = z > 0.0f ? gv : 0.0f;
        }
      }
      v = dv;
    });
    emit_regs(acc, o.Np, Atile, p.lda, red);
    fence_async_smem();
    __syncthreads();
    emit_finish(p, o, o.Np, red, Atile, dbpart, dels, row0);
  }

  for (int l = L - 1; l >= 1; --l) {
    const LayerDesc& d = p.L[l];
    rb_product<RG>(p, W, 2 * L - 1 - l, s, cur, ring, Atile, p.lda, acc);
    __syncthreads();  // every warpgroup is done reading the delta in Atile
    for_owned(acc, d.Kp, [&](int ci, int i, int, int, float& v) {
      if (!((maskw[((l - 1) * 2 + ci) * kThreads + threadIdx.x] >> i) & 1u)) v = 0.0f;
    });
    emit_regs(acc, p.L[l - 1].Np, Atile, p.lda, red);
    fence_async_smem();
    __syncthreads();
    emit_finish(p, p.L[l - 1], p.L[l - 1].Np, red, Atile, dbpart, dels, row0);
  }

  // dx of layer 0, the cotangent of the input concat, in passes of kMaxOut
  // columns; split it by mode
  const int use_view = p.mode != 1;
  const int use_nrm = p.mode != 2;
  const int c_nrm = 3 + (use_view ? p.e_a : 0);
  const int c_feat = c_nrm + (use_nrm ? 3 : 0);
  const int K0 = p.L[0].K;
  for (int q = 2 * L - 1; q < p.n_prod; ++q) {
    const int n0 = p.q_n0[q];
    rb_product<RG>(p, W, q, s, cur, ring, Atile, p.lda, acc);
    for_owned(acc, p.q_w[q], [&](int, int, int r, int c, float& v) {
      const int gr = row0 + r;
      c += n0;
      if (gr >= n || c >= K0) return;
      if (c < 3) {
        d_pts[gr * 3 + c] = v;
      } else if (c < c_nrm) {
        Sv[r * p.e_a + c - 3] = v;
      } else if (c < c_feat) {
        d_nrm[gr * 3 + c - c_nrm] = v;
      } else {
        d_feat[(size_t)gr * p.d_feat + c - c_feat] = v;
      }
    });
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * 3; idx += kThreads) {
    const int r = idx / 3;
    const int j = idx % 3;
    const int gr = row0 + r;
    if (gr >= n) continue;
    if (!use_nrm) d_nrm[gr * 3 + j] = 0.0f;
    float dd = 0.0f;
    if (use_view)
      dd = embed_vjp([&](int c) { return Sv[r * p.e_a + c]; }, dirs + gr * 3, 3, j,
                     p.freqs_a);
    d_dirs[gr * 3 + j] = dd;
  }
}

// ---------------------------------------------------------------------------
// K2: the colour head's forward on the wgmma tile machinery
// ---------------------------------------------------------------------------
//
// K2 (render_fwd_kernel, replaces _render_kernel_fwd) is K4's tile without
// the skip concat and the alpha dot: 128-row tiles, each of two warpgroups
// owning 64 rows and a full product pass (128 accumulator registers), a
// synchronous bulk-copy ring fed from a ring image the wrapper gathers once
// per pack (fused_mlp._render_pack, which K3 reuses). One product pass per
// layer (fused_mlp.render_schedule): layer 0 reduces over Kp (304 at full
// width: nine full slabs and a half one); the output layer is one 64-column
// chunk zero-padded in the image (d_out 3; d_out 96 is two), so every d_out
// <= 256 takes the same code. The epilogues work on the registers: a hidden
// layer's bias and relu, rounded to bf16 into the hidden tile; the output's
// bias and sigmoid (or relu) in f32, rows past n masked.
//
// Bound: operations (542,720 FLOP of bf16 products a row at full width,
// 0.216 ms at 393,216 rows; the padded products are 7% more). Unlike K4's,
// K2's input is wide: 265 f32 a row (417 MB a serving chunk, 0.126 ms at the
// memory rate). Read at the start of each tile it stalls the products, and
// loads issued by the product warpgroups before a pass are waited for at the
// pass's first wgmma. So the CTA is persistent (tiles blockIdx.x, +
// gridDim.x, ...; fused_mlp.render_launch_plan gives the grid, one CTA per
// SM), the ring runs on from one tile's passes into the next's, and a third
// warpgroup, the producer, loads each tile's input (K2Input) into its own
// tile X while the two product warpgroups run the previous tile's hidden
// passes on the hidden tile H. Two mbarriers hand X over: `full` (the
// producer's 128 threads arrive after their writes) and `empty` (the 256
// product threads arrive once layer 0 has read it). 220 KB of shared memory:
// a 5-stage ring (16 KB a stage), X [128, 304] and H [128, 256] in bf16;
// the colour head under depth_before_color (X [128, 400]) runs a 3-stage ring
// in 217,136 bytes.

constexpr int kK2Threads = kThreads + 128;  // two product warpgroups, one producer

// K2's producer: one tile's input into X [128, Kp0], the mode's concat [pts |
// emb_view | normals | feat] (the columns past it are zeroed once, before the
// first tile), zero for rows past n. The feature block goes in chunks of
// kPre float4 a thread, all in flight together: a warp's 32 lanes load 8 rows
// x 4 float4s (64 contiguous bytes of each row) and store them into 8 rows of
// two or three core matrices, which spreads the 2-byte stores over the banks.
// The 9 other floats a row (pts, dirs, normals) come first; the thread that
// holds a dirs value writes every view-embedding column made from it, as
// embed_at computes them.
struct K2Input {
  static constexpr int kR = 128;
  static constexpr int kT = kK2Threads - kThreads;  // producer threads
  static constexpr int kPre = 16;                   // float4 per thread per chunk

  // unit i of chunk c for producer thread t -> (tile row, first feature
  // column); false past the block
  __device__ static bool at(const Plan& p, int t, int c, int i, int& row, int& col) {
    const int u = t / 32 + (kT / 32) * (kPre * c + i);  // units of 8 rows x 16 floats
    row = 8 * (u % (kR / 8)) + (t & 7);
    col = 4 * (4 * (u / (kR / 8)) + ((t & 31) >> 3));
    return col < p.d_feat;
  }

  __device__ static void fill(const Plan& p, const float* __restrict__ pts,
                              const float* __restrict__ nrm, const float* __restrict__ dirs,
                              const float* __restrict__ feat, int n, int row0, bf16* X, int ldx) {
    const int t = threadIdx.x - kThreads;
    const int use_view = p.mode != 1, use_nrm = p.mode != 2;
    const int c_nrm = 3 + (use_view ? p.e_a : 0);
    constexpr int kSmall = 3 * kR / kT;
    float sv[3][kSmall];
#pragma unroll
    for (int h = 0; h < kSmall; ++h) {
      const int e = t + kT * h;  // row * 3 + j
      const bool ok = row0 + e / 3 < n;
      const size_t g = (size_t)row0 * 3 + e;
      sv[0][h] = ok ? pts[g] : 0.0f;
      sv[1][h] = ok && use_view ? dirs[g] : 0.0f;
      sv[2][h] = ok && use_nrm ? nrm[g] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < kSmall; ++h) {
      const int e = t + kT * h;
      const int row = e / 3, j = e % 3;
      X[core_at(row, j, ldx)] = __float2bfloat16(sv[0][h]);
      if (use_view) {
        X[core_at(row, 3 + j, ldx)] = __float2bfloat16(sv[1][h]);
        for (int b = 0; b < p.freqs_a; ++b) {
          const float v = sv[1][h] * ldexpf(1.0f, b);
          X[core_at(row, 6 + 6 * b + j, ldx)] = __float2bfloat16(sinf(v));
          X[core_at(row, 9 + 6 * b + j, ldx)] = __float2bfloat16(cosf(v));
        }
      }
      if (use_nrm) X[core_at(row, c_nrm + j, ldx)] = __float2bfloat16(sv[2][h]);
    }

    const int c_feat = p.L[0].K - p.d_feat;
    const bool vec = p.d_feat % 4 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
    const int units = (kR / 8) * ((p.d_feat + 15) / 16);
    const int chunks = ((units + kT / 32 - 1) / (kT / 32) + kPre - 1) / kPre;
    for (int c = 0; c < chunks; ++c) {
      float4 f[kPre];
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        int row, col;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (at(p, t, c, i, row, col) && row0 + row < n) {
          const float* src = feat + (size_t)(row0 + row) * p.d_feat + col;
          if (vec) {
            v = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            v.x = src[0];
            if (col + 1 < p.d_feat) v.y = src[1];
            if (col + 2 < p.d_feat) v.z = src[2];
            if (col + 3 < p.d_feat) v.w = src[3];
          }
        }
        f[i] = v;
      }
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        int row, col;
        if (!at(p, t, c, i, row, col)) continue;
        const float v[4] = {f[i].x, f[i].y, f[i].z, f[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.d_feat) X[core_at(row, c_feat + col + e, ldx)] = __float2bfloat16(v[e]);
      }
    }
  }
};
static_assert(3 * K2Input::kR % K2Input::kT == 0, "the small columns split evenly");

template <int ST>
__global__ void __launch_bounds__(kK2Threads, 1)
render_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ dirs, const float* __restrict__ feat,
                  float* __restrict__ out, int n, const bf16* __restrict__ img,
                  const float* __restrict__ B, Plan p) {
  constexpr int NCH = 4;
  constexpr int R = TileMap<NCH>::kRows;
  static_assert(R == K2Input::kR, "one input tile per product tile");
  using RG = K2Ring<ST>;
  const int L = p.n_layers;
  const int ldx = p.L[0].Kp;
  int ldh = 0;
  for (int l = 1; l < L; ++l) ldh = max(ldh, p.L[l].Kp);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                 // [stages][kSlab]
  bf16* X = ring + RG::kStages * kSlab;                            // [R, ldx] core layout
  bf16* H = X + R * ldx;                                           // [R, ldh] core layout
  uint64_t* bars = reinterpret_cast<uint64_t*>(H + R * ldh);      // [stages]
  uint64_t* full = bars + RG::kStages;                             // X holds the next tile
  uint64_t* empty = full + 1;                                      // layer 0 has read X

  const int n_tiles = (n + R - 1) / R;
  const int tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;  // this CTA's
  RbCursor cur{0, 0, p.n_prod, bars, tiles};
  cur.init<RG>();
  if (threadIdx.x == 0) {
    mbar_init(full, K2Input::kT);
    mbar_init(empty, kThreads);
    mbar_init_fence();
  }
  __syncthreads();  // the last barrier of all three warpgroups

  if (threadIdx.x >= kThreads) {  // the producer
    const int pad = ldx - p.L[0].K;
    for (int idx = threadIdx.x - kThreads; idx < R * pad; idx += K2Input::kT)
      X[core_at(idx / pad, p.L[0].K + idx % pad, ldx)] = __float2bfloat16(0.0f);
    for (int t = 0; t < tiles; ++t) {
      if (t > 0) mbar_wait(empty, (t - 1) & 1);
      K2Input::fill(p, pts, nrm, dirs, feat, n, (blockIdx.x + t * gridDim.x) * R, X, ldx);
      fence_async_smem();
      mbar_arrive(full);
    }
    return;
  }

  cur.prologue<RG>(p, img, ring);
  float acc[NCH][32];
  int s = 0;
  for (int t = 0; t < tiles; ++t) {
    const int row0 = (blockIdx.x + t * gridDim.x) * R;
    mbar_wait(full, t & 1);
    for (int l = 0; l < L; ++l) {
      rb_product<RG>(p, img, l, s, cur, ring, l == 0 ? X : H, l == 0 ? ldx : ldh, acc);
      RG::sync();  // every warpgroup is done reading its input tile
      if (l == 0 && t + 1 < tiles) mbar_arrive(empty);
      const LayerDesc& d = p.L[l];
      if (l + 1 < L) {
        const float* bias = B + d.boff;
        for_pairs(acc, d.Np, [&](int, int, int r, int col, float& v0, float& v1) {
          *reinterpret_cast<__nv_bfloat162*>(H + core_at(r, col, ldh)) = __floats2bfloat162_rn(
              fmaxf(v0 + bias[col], 0.0f), fmaxf(v1 + bias[col + 1], 0.0f));
        });
        fence_async_smem();
        RG::sync();
      } else {
        for_owned(acc, d.Np, [&](int, int, int r, int col, float& v) {
          const int gr = row0 + r;
          if (gr >= n || col >= d.N) return;
          const float z = v + B[d.boff + col];
          out[(size_t)gr * d.N + col] =
              p.squeeze_out ? 1.0f / (1.0f + expf(-z)) : fmaxf(z, 0.0f);
        });
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4 and K5: the background NeRF on the wgmma tile machinery
// ---------------------------------------------------------------------------
//
// Layers (as _nerf_meta packs them): trunk 0..T-1 (relu, width Wt), then
// [feature | alpha] (wf + 1 columns), views0 (relu) and [rgb | dpt]. Two
// packing choices keep each forward output and its dx counterpart in the
// same thread and register: the input after a skip layer is [h | emb_pts]
// (the next layer's W rows permuted to match), so columns 0..Wt-1 of its dx
// are the skip layer's delta under that layer's relu-mask bits and columns
// Wt.. add into the point embedding's cotangent dE; and the feature columns
// come first, so views0's dx columns 0..wf-1 are [feature | alpha]'s delta
// as they stand. The point embedding sits in Ea (layer 0's input, and copied
// after every skip layer), the view embedding in Eb (views0's input beside
// the feature).
//
// K4 (nerf_fwd_kernel, replaces _nerf_kernel_fwd): 128-row tiles, each
// warpgroup owning 64 rows and a full product pass (128 accumulator
// registers), one CTA of 217 KB per SM, a synchronous 6-stage bulk-copy
// ring. The [feature | alpha] layer runs its wf feature columns as a pass
// and alpha as a per-row dot of the layer's input in its epilogue; alpha,
// rgb and dpt are written from the epilogues. Bound: operations (1.208
// MFLOP of bf16 products a row at full width: 0.165 ms at 135,168 rows).
// What the design does about it: every product on the tensor cores through
// wgmma, each weight slab read from L2 once per 128 rows (1.23 MB of packed
// weights per tile) by one bulk copy.
//
// K5 (nerf_bwd_kernel, replaces _nerf_kernel_bwd): 64-row tiles (128 would
// need more than 227 KB: ring, A tile, embeddings, the f32 dE and the mask
// bits of nine layers), the warpgroups splitting each pass's columns, one
// CTA of 206 KB per SM, an asynchronous 6-stage bulk-copy ring (a slab's
// wgmma runs on through the next slab's barrier). It recomputes the forward
// through views0 storing every layer's input to `acts` and the relu masks
// as bits, then runs the dx passes in reverse (the passes of a dx wider than
// 256 columns first, so that the last pass, columns 0..255, stays in the
// registers for the next delta). Bound: operations, 3x the forward's (0.062
// ms at 16,896 rows); the same design answers it.

// rows x [c0, c1) of Atile <- E[r, c - c0] (row-major, `le` columns, zero past
// the embedding), zero from le on
template <int R>
__device__ void put_cols(bf16* Atile, int lda, int c0, int c1, const bf16* E, int le) {
  const int w = c1 - c0;
  for (int idx = threadIdx.x; idx < R * w; idx += kThreads) {
    const int r = idx / w;
    const int c = idx % w;
    Atile[core_at(r, c0 + c, lda)] = c < le ? E[r * le + c] : __float2bfloat16(0.0f);
  }
}

// the point embedding into Ea and into layer 0's input (Atile), the view
// embedding into Eb; zero past the embeddings and for rows past n
template <int R>
__device__ void nerf_input(const Plan& p, const float* __restrict__ pts,
                           const float* __restrict__ views, int n, int row0, bf16* Atile,
                           bf16* Ea, bf16* Eb) {
  const int lea = pad16(p.e_a);
  const int leb = pad16(p.e_b);
  for (int idx = threadIdx.x; idx < R * lea; idx += kThreads) {
    const int r = idx / lea;
    const int c = idx % lea;
    const int gr = row0 + r;
    const float v = gr < n && c < p.e_a ? embed_at(pts + (size_t)gr * p.d_a, p.d_a, c) : 0.0f;
    const bf16 h = __float2bfloat16(v);
    Ea[idx] = h;
    Atile[core_at(r, c, p.lda)] = h;
  }
  for (int idx = threadIdx.x; idx < R * leb; idx += kThreads) {
    const int r = idx / leb;
    const int c = idx % leb;
    const int gr = row0 + r;
    const float v = gr < n && c < p.e_b ? embed_at(views + gr * 3, 3, c) : 0.0f;
    Eb[idx] = __float2bfloat16(v);
  }
}

// K4: alpha = h . w_alpha + b_alpha for each row, h the [feature | alpha]
// layer's bf16 input in Atile; two threads per row, 16-byte reads
template <int R>
__device__ void nerf_alpha(const Plan& p, const bf16* Atile, const float* walpha, float bias,
                           float* __restrict__ alpha, int n, int row0) {
  static_assert(2 * R == kThreads, "two threads per row");
  const int r = threadIdx.x >> 1;
  float s = 0.0f;
  for (int kg = threadIdx.x & 1; kg < p.L[p.trunk].Kp / 8; kg += 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(Atile + core_at(r, kg * 8, p.lda));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s = fmaf(f.x, walpha[kg * 8 + 2 * e], s);
      s = fmaf(f.y, walpha[kg * 8 + 2 * e + 1], s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if ((threadIdx.x & 1) == 0 && row0 + r < n) alpha[row0 + r] = s + bias;
}

// The forward through views0 (product passes 0..T+1), leaving views0's bf16
// output in Atile. K5 (BWD) stores each layer's input to `acts` and keeps
// the relu masks of the trunk (slots 0..T-1) and of views0 (slot T) in
// maskw; K4 writes alpha.
template <class RG, int NCH, bool BWD>
__device__ void nerf_forward(const Plan& p, const bf16* __restrict__ W,
                             const float* __restrict__ B, int& s, RbCursor& cur, bf16* ring,
                             bf16* Atile, const bf16* Ea, const bf16* Eb, float (&acc)[NCH][32],
                             uint32_t* maskw, bf16* acts, const float* walpha,
                             float* __restrict__ alpha, int n, int row0) {
  constexpr int R = TileMap<NCH>::kRows;
  const int T = p.trunk;
  for (int l = 0; l <= T + 1; ++l) {
    const LayerDesc& d = p.L[l];
    if constexpr (BWD) store_tile(Atile, p.lda, d.Kp, acts + d.aoff, p.act_w, row0);
    rb_product<RG>(p, W, l, s, cur, ring, Atile, p.lda, acc);
    __syncthreads();  // every warpgroup is done reading Atile
    const float* bias = B + d.boff;
    if (l == T) {
      if constexpr (!BWD) {
        nerf_alpha<R>(p, Atile, walpha, bias[p.wf], alpha, n, row0);
        __syncthreads();
      }
      // views0's input: [feature | emb_view]
      for_pairs(acc, p.wf, [&](int, int, int r, int c, float& v0, float& v1) {
        *reinterpret_cast<__nv_bfloat162*>(Atile + core_at(r, c, p.lda)) =
            __floats2bfloat162_rn(v0 + bias[c], v1 + bias[c + 1]);
      });
      put_cols<R>(Atile, p.lda, p.wf, p.L[T + 1].Kp, Eb, pad16(p.e_b));
    } else {
      uint32_t bits[NCH] = {};
      for_pairs(acc, d.Np, [&](int ci, int i, int r, int c, float& v0, float& v1) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(fmaxf(v0 + bias[c], 0.0f), fmaxf(v1 + bias[c + 1], 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(Atile + core_at(r, c, p.lda)) = h;
        if (BWD) {
          const float2 f = __bfloat1622float2(h);
          bits[ci] |= (f.x > 0.0f ? 1u << i : 0u) | (f.y > 0.0f ? 2u << i : 0u);
        }
      });
      if constexpr (BWD) {
        const int slot = l < T ? l : T;
#pragma unroll
        for (int ci = 0; ci < NCH; ++ci)
          maskw[(slot * NCH + ci) * kThreads + threadIdx.x] = bits[ci];
      }
      // after a skip layer the next input is [h | emb_pts]
      if (l < T && ((p.skips >> l) & 1u))
        put_cols<R>(Atile, p.lda, d.N, p.L[l + 1].Kp, Ea, pad16(p.e_a));
    }
    fence_async_smem();
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
nerf_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                float* __restrict__ alpha, float* __restrict__ rgb, float* __restrict__ dpt, int n,
                const bf16* __restrict__ W, const bf16* __restrict__ img,
                const float* __restrict__ B, Plan p) {
  constexpr int NCH = 4;
  constexpr int R = TileMap<NCH>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using RG = K4Ring;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);         // [stages][kSlab]
  bf16* Atile = ring + RG::kStages * kSlab;                // [R, lda] core layout
  bf16* Ea = Atile + R * p.lda;                            // [R, pad16(e_a)]
  bf16* Eb = Ea + R * pad16(p.e_a);                        // [R, pad16(e_b)]
  float* walpha = reinterpret_cast<float*>(Eb + R * pad16(p.e_b));  // [Kp of the alpha layer]
  uint64_t* bars = reinterpret_cast<uint64_t*>(walpha + p.L[p.trunk].Kp);  // [stages]

  const int T = p.trunk;
  const int row0 = blockIdx.x * R;
  RbCursor cur{0, 0, p.n_prod, bars};
  cur.init<RG>();
  __syncthreads();
  cur.prologue<RG>(p, img, ring);
  nerf_input<R>(p, pts, views, n, row0, Atile, Ea, Eb);
  const LayerDesc& af = p.L[T];
  for (int k = threadIdx.x; k < af.Kp; k += kThreads)
    walpha[k] = __bfloat162float(W[af.woff + (size_t)k * af.Np + p.wf]);
  fence_async_smem();
  __syncthreads();

  float acc[NCH][32];
  int s = 0;
  nerf_forward<RG, NCH, false>(p, img, B, s, cur, ring, Atile, Ea, Eb, acc, nullptr, nullptr, walpha,
                           alpha, n, row0);
  const LayerDesc& rd = p.L[T + 2];
  rb_product<RG>(p, img, T + 2, s, cur, ring, Atile, p.lda, acc);
  for_owned(acc, rd.Np, [&](int, int, int r, int c, float& v) {
    const int gr = row0 + r;
    if (gr >= n) return;
    const float o = v + B[rd.boff + c];
    if (c < p.d_rgb)
      rgb[(size_t)gr * p.d_rgb + c] = o;
    else if (c < p.d_rgb + p.d_dpt)
      dpt[(size_t)gr * p.d_dpt + c - p.d_rgb] = o;
  });
}

// K5: recompute, then (g_alpha, g_rgb, g_dpt) -> d(pts), d(views) and the
// per-layer deltas and db partials (dW follows in the contraction).
__global__ void __launch_bounds__(kThreads, 1)
nerf_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                const float* __restrict__ g_alpha, const float* __restrict__ g_rgb,
                const float* __restrict__ g_dpt, float* __restrict__ d_pts,
                float* __restrict__ d_views, int n, const bf16* __restrict__ img,
                const float* __restrict__ B, Plan p, bf16* acts, bf16* dels, float* dbpart) {
  constexpr int NCH = 2;
  constexpr int R = TileMap<NCH>::kRows;
  const int T = p.trunk;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using RG = K5Ring;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);         // [stages][kSlab]
  bf16* Atile = ring + RG::kStages * kSlab;                // [R, lda] core layout
  bf16* Ea = Atile + R * p.lda;                            // [R, pad16(e_a)]
  bf16* Eb = Ea + R * pad16(p.e_a);                        // [R, pad16(e_b)]
  uint32_t* maskw = reinterpret_cast<uint32_t*>(Eb + R * pad16(p.e_b));  // [T + 1][NCH][threads]
  float* red = reinterpret_cast<float*>(maskw + (T + 1) * NCH * kThreads);  // [4, kMaxOut]
  float* dE = red + 4 * kMaxOut;                           // [R, e_a]
  float* Sv = dE + R * p.e_a;                              // [R, e_b]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Sv + R * p.e_b);  // [stages]

  const int row0 = blockIdx.x * R;
  RbCursor cur{0, 0, p.n_prod, bars};
  cur.init<RG>();
  __syncthreads();
  cur.prologue<RG>(p, img, ring);
  nerf_input<R>(p, pts, views, n, row0, Atile, Ea, Eb);
  for (int i = threadIdx.x; i < R * p.e_a; i += kThreads) dE[i] = 0.0f;
  fence_async_smem();
  __syncthreads();

  float acc[NCH][32];
  int s = 0;
  nerf_forward<RG, NCH, true>(p, img, B, s, cur, ring, Atile, Ea, Eb, acc, maskw, acts, nullptr, nullptr,
                          n, row0);
  const LayerDesc& af = p.L[T];
  const LayerDesc& v0 = p.L[T + 1];
  const LayerDesc& rd = p.L[T + 2];
  store_tile(Atile, p.lda, rd.Kp, acts + rd.aoff, p.act_w, row0);
  __syncthreads();  // done reading views0's output before the delta replaces it

  // [rgb | dpt]: the delta is the cotangent itself
  for_owned(acc, rd.Np, [&](int, int, int r, int c, float& v) {
    const int gr = row0 + r;
    float gv = 0.0f;
    if (gr < n) {
      if (c < p.d_rgb)
        gv = g_rgb[(size_t)gr * p.d_rgb + c];
      else if (c < p.d_rgb + p.d_dpt)
        gv = g_dpt[(size_t)gr * p.d_dpt + c - p.d_rgb];
    }
    v = gv;
  });
  emit_regs(acc, rd.Np, Atile, p.lda, red);
  fence_async_smem();
  __syncthreads();
  emit_finish(p, rd, rd.Np, red, Atile, dbpart, dels, row0);

  // dx of layer l, all its passes (those from column kMaxOut on first):
  // column c >= split of the layer's input cotangent goes to tail(r, c, v);
  // columns below stay in the registers as the next delta, under the relu
  // mask of slot mslot (none if < 0)
  int q = T + 2;
  auto dx = [&](int split, int mslot, auto tail) {
    for (; p.q_n0[q] != 0; ++q) {
      const int n0 = p.q_n0[q];
      rb_product<RG>(p, img, q, s, cur, ring, Atile, p.lda, acc);
      for_owned(acc, p.q_w[q], [&](int, int, int r, int c, float& v) { tail(r, n0 + c, v); });
    }
    rb_product<RG>(p, img, q, s, cur, ring, Atile, p.lda, acc);
    __syncthreads();  // every warpgroup is done reading the delta in Atile
    for_owned(acc, p.q_w[q], [&](int ci, int i, int r, int c, float& v) {
      if (c >= split)
        tail(r, c, v);
      else if (mslot >= 0 && !((maskw[(mslot * NCH + ci) * kThreads + threadIdx.x] >> i) & 1u))
        v = 0.0f;
    });
    ++q;
  };
  auto no_tail = [](int, int, float) {};
  auto to_dE = [&](int c0) {
    return [&, c0](int r, int c, float v) {
      c -= c0;
      if (c < p.e_a) dE[r * p.e_a + c] += v;
    };
  };
  constexpr int kAll = 1 << 30;

  // views0: dx of [rgb | dpt] under views0's relu
  dx(kAll, T, no_tail);
  emit_regs(acc, v0.Np, Atile, p.lda, red);
  fence_async_smem();
  __syncthreads();
  emit_finish(p, v0, v0.Np, red, Atile, dbpart, dels, row0);

  // [feature | alpha]: dx of views0 is [d_feature | d_emb_view]; the delta is
  // [d_feature | g_alpha | 0]
  dx(p.wf, -1, [&](int r, int c, float v) {
    c -= p.wf;
    if (c < p.e_b) Sv[r * p.e_b + c] = v;
  });
  emit_regs(acc, p.wf, Atile, p.lda, red);
  for (int idx = threadIdx.x; idx < R * (af.Np - p.wf); idx += kThreads) {
    const int r = idx % R;
    const int c = p.wf + idx / R;
    const float v = c == p.wf && row0 + r < n ? g_alpha[row0 + r] : 0.0f;
    Atile[core_at(r, c, p.lda)] = __float2bfloat16(v);
  }
  fence_async_smem();
  __syncthreads();
  emit_finish(p, af, p.wf, red, Atile, dbpart, dels, row0);
  for (int c = p.wf + threadIdx.x; c < af.Np; c += kThreads) {
    float sum = 0.0f;
    if (c == p.wf)
      for (int r = 0; r < R && row0 + r < n; ++r) sum += g_alpha[row0 + r];
    dbpart[(size_t)blockIdx.x * p.total_b + af.boff + c] = sum;
  }
  for (int idx = threadIdx.x; idx < R * 3; idx += kThreads) {
    const int r = idx / 3;
    const int j = idx % 3;
    const int gr = row0 + r;
    if (gr < n)
      d_views[gr * 3 + j] =
          embed_vjp([&](int c) { return Sv[r * p.e_b + c]; }, views + gr * 3, 3, j, p.freqs_b);
  }

  // the trunk in reverse: dx of layer i is layer i-1's delta under its relu
  // mask, and after a skip layer also the skip's share of dE
  for (int i = T; i >= 1; --i) {
    const bool skip = i < T && ((p.skips >> (i - 1)) & 1u);
    const LayerDesc& d = p.L[i - 1];
    if (skip)
      dx(d.N, i - 1, to_dE(d.N));
    else
      dx(kAll, i - 1, no_tail);
    emit_regs(acc, d.Np, Atile, p.lda, red);
    fence_async_smem();
    __syncthreads();
    emit_finish(p, d, d.Np, red, Atile, dbpart, dels, row0);
  }
  // layer 0's input is the point embedding itself
  dx(0, -1, to_dE(0));
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * p.d_a; idx += kThreads) {
    const int r = idx / p.d_a;
    const int j = idx % p.d_a;
    const int gr = row0 + r;
    if (gr < n)
      d_pts[(size_t)gr * p.d_a + j] = embed_vjp([&](int c) { return dE[r * p.e_a + c]; },
                                                pts + (size_t)gr * p.d_a, p.d_a, j, p.freqs_a);
  }
}

// ---------------------------------------------------------------------------
// The dW contraction shared by K3 and K5
// ---------------------------------------------------------------------------
//
// dW_l = acts_l^T . dels_l for every layer: M = Kp_l, N = Np_l, reduced over
// the padded rows. One CTA of 8 warps per 128x128 output tile and row split;
// the splits (rows_per_split, a multiple of 64, chosen by the wrapper for
// about two CTAs per SM in all: two resident CTAs, each with 96 KB of ring
// and <= 128 registers a thread, hide each other's barriers and load
// latency) write f32 partials that reduce_dw_kernel sums in split order.
// Both operands stream through a 3-stage cp.async ring of
// 64-row slabs (16 KB of acts and 16 KB of dels per stage, 16-byte copies,
// zero-filled past Kp/Np), stored row-major with the 16-byte chunks of each
// 256-byte row XOR-swizzled by the row index, so that the ldmatrix reads of
// 8 consecutive rows hit 8 different bank groups. All warps read the shared
// copy: A (acts, m contiguous) and B (dels, n contiguous) both go to
// mma.sync.m16n8k16 through ldmatrix.trans. Warp (wm, wn) owns a 32x64
// block of the tile. No atomics: two launches give the same bits.

constexpr int kDwTile = 128;   // output rows (Kp) and columns (Np) per CTA
constexpr int kDwRows = 64;    // reduction rows per slab
constexpr int kDwStages = 3;
constexpr int kDwThreads = 256;
constexpr int kDwSlab = kDwRows * kDwTile;  // bf16 elements per operand per stage

struct DwPlan {
  int n_layers;
  int tile0[kMaxLayers + 1];  // first output tile of each layer
  int Kp[kMaxLayers], Np[kMaxLayers], aoff[kMaxLayers], doff[kMaxLayers];
  long long woff[kMaxLayers];
  int act_w, del_w, n_rows, rows_per_split;
  long long total_w;
};

__device__ __forceinline__ int dw_swz(int r, int chunk) {
  return r * kDwTile + ((chunk ^ (r & 7)) << 3);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one 64-row slab of both operands: columns [m0, m0 + 128) of acts_l and
// [n0, n0 + 128) of dels_l
__device__ __forceinline__ void dw_load(const bf16* __restrict__ acts,
                                        const bf16* __restrict__ dels, const DwPlan& q,
                                        int l, int m0, int n0, int r0, bf16* As, bf16* Bs) {
  for (int idx = threadIdx.x; idx < 2 * kDwRows * 16; idx += kDwThreads) {
    const int which = idx >= kDwRows * 16;
    const int u = idx - which * kDwRows * 16;
    const int r = u >> 4;
    const int c = u & 15;
    const int col = (which ? n0 : m0) + c * 8;
    const bool ok = col < (which ? q.Np[l] : q.Kp[l]);
    const bf16* src = which ? dels + (size_t)(r0 + r) * q.del_w + q.doff[l] + col
                            : acts + (size_t)(r0 + r) * q.act_w + q.aoff[l] + col;
    cp_async16_zfill((which ? Bs : As) + dw_swz(r, c), ok ? src : acts, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kDwThreads, 2)
dw_kernel(const bf16* __restrict__ acts, const bf16* __restrict__ dels,
          float* __restrict__ part, DwPlan q) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [stages][2][kDwSlab]

  int t = blockIdx.x;
  int l = 0;
  while (t >= q.tile0[l + 1]) ++l;
  t -= q.tile0[l];
  const int n_tiles_n = (q.Np[l] + kDwTile - 1) / kDwTile;
  const int m0 = (t / n_tiles_n) * kDwTile;
  const int n0 = (t % n_tiles_n) * kDwTile;
  const int r_begin = blockIdx.y * q.rows_per_split;
  const int r_end = min(q.n_rows, r_begin + q.rows_per_split);
  const int n_slabs = r_end > r_begin ? (r_end - r_begin) / kDwRows : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;   // rows wm*32 .. +31 of the tile
  const int wn = warp >> 2;  // columns wn*64 .. +63
  const int lq = lane >> 3, li = lane & 7;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < n_slabs)
      dw_load(acts, dels, q, l, m0, n0, r_begin + i * kDwRows, ring + 2 * i * kDwSlab,
              ring + (2 * i + 1) * kDwSlab);
    cp_async_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // slab s landed; every warp is done with slab s - 1
    const int nxt = s + kDwStages - 1;
    if (nxt < n_slabs) {
      const int st = nxt % kDwStages;
      dw_load(acts, dels, q, l, m0, n0, r_begin + nxt * kDwRows, ring + 2 * st * kDwSlab,
              ring + (2 * st + 1) * kDwSlab);
    }
    cp_async_commit();
    const bf16* As = ring + 2 * (s % kDwStages) * kDwSlab;
    const bf16* Bs = As + kDwSlab;
#pragma unroll
    for (int kk = 0; kk < kDwRows; kk += 16) {
      uint32_t a[2][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // matrices: (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
        const int r = kk + li + (lq >> 1) * 8;
        const int m = wm * 32 + i * 16 + (lq & 1) * 8;
        ldsm_x4_trans(a[i], As + dw_swz(r, m >> 3));
      }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        const int r = kk + li + (lq & 1) * 8;
        const int n = wn * 64 + jb * 16 + (lq >> 1) * 8;
        ldsm_x4_trans(b[jb], Bs + dw_swz(r, n >> 3));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  const int g = lane >> 2, tq = lane & 3;
  float* out = part + (size_t)blockIdx.y * q.total_w + q.woff[l];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + wn * 64 + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + h * 8;
        if (m < q.Kp[l] && n < q.Np[l])
          *reinterpret_cast<float2*>(out + (size_t)m * q.Np[l] + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// dW = sum over splits, in split order
__global__ void reduce_dw_kernel(const float* __restrict__ part, int splits,
                                 long long total_w, float* __restrict__ dW) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total_w;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * total_w + i];
    dW[i] = s;
  }
}

// db = sum over row tiles: one warp per column, lane l summing tiles
// l, l + 32, ... in order, then a fixed xor-shuffle tree across the lanes
__global__ void reduce_db_kernel(const float* __restrict__ dbpart, int n_tiles,
                                 int total_b, float* __restrict__ dB) {
  const int lane = threadIdx.x % 32;
  for (int j = (blockIdx.x * blockDim.x + threadIdx.x) / 32; j < total_b;
       j += gridDim.x * blockDim.x / 32) {
    float s = 0.0f;
    for (int t = lane; t < n_tiles; t += 32) s += dbpart[(size_t)t * total_b + j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dB[j] = s;
  }
}

// meta (int64): [n_layers, mode, squeeze_out, freqs_a, freqs_b, d_a, d_feat,
// skips, trunk, d_rgb, d_dpt, then K, N, Kp, Np, woff, boff per layer].
int read_plan(const long long* meta, Plan* p) {
  *p = Plan{};
  p->n_layers = (int)meta[0];
  if (p->n_layers < 1 || p->n_layers > kMaxLayers) return 1;
  p->mode = (int)meta[1];
  p->squeeze_out = (int)meta[2];
  p->freqs_a = (int)meta[3];
  p->freqs_b = (int)meta[4];
  p->d_a = (int)meta[5];
  p->d_feat = (int)meta[6];
  p->skips = (unsigned)meta[7];
  p->trunk = (int)meta[8];
  p->d_rgb = (int)meta[9];
  p->d_dpt = (int)meta[10];
  int lda = 0, aoff = 0, doff = 0;
  long long total_w = 0;
  for (int l = 0; l < p->n_layers; ++l) {
    const long long* m = meta + 11 + 6 * l;
    LayerDesc& d = p->L[l];
    d.K = (int)m[0];
    d.N = (int)m[1];
    d.Kp = (int)m[2];
    d.Np = (int)m[3];
    d.woff = m[4];
    d.boff = m[5];
    if (d.Kp % 16 || d.Np % 16 || d.woff % 16 || d.Kp < d.K || d.Np < d.N) return 1;
    if (d.woff != total_w || d.boff != doff) return 1;  // packed in order
    d.aoff = aoff;
    d.doff = doff;
    aoff += d.Kp;
    doff += d.Np;
    total_w += (long long)d.Kp * d.Np;
    lda = lda > d.Kp ? lda : d.Kp;
    lda = lda > pad16(d.N) ? lda : pad16(d.N);
  }
  p->lda = lda;
  p->act_w = aoff;
  p->del_w = doff;
  p->total_b = doff;
  p->total_w = total_w;
  return 0;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// append product pass (layer l, forward or dx, first column n0, width w);
// 1 when the list is full
int add_prod(Plan* p, int l, int dx, int n0, int w) {
  if (p->n_prod >= kMaxProds || w <= 0 || w > kMaxOut) return 1;
  p->q_layer[p->n_prod] = (unsigned char)l;
  p->q_dx[p->n_prod] = (unsigned char)dx;
  p->q_n0[p->n_prod] = (short)n0;
  p->q_w[p->n_prod] = (short)w;
  ++p->n_prod;
  return 0;
}

// dx of layer l in passes of kMaxOut columns, from column 0 on
int add_dx(Plan* p, int l) {
  const int Kp = p->L[l].Kp;
  int err = 0;
  for (int n0 = 0; n0 < Kp; n0 += kMaxOut)
    err |= add_prod(p, l, 1, n0, Kp - n0 < kMaxOut ? Kp - n0 : kMaxOut);
  return err;
}

// K3: the forward, dx of layers L-1..1 (one pass each), layer 0's dx
int render_bwd_schedule(Plan* p) {
  const int L = p->n_layers;
  int err = 0;
  for (int l = 0; l < L; ++l) err |= add_prod(p, l, 0, 0, p->L[l].Np);
  for (int l = L - 1; l >= 1; --l) err |= p->L[l].Kp > kMaxOut || add_dx(p, l);
  return err | add_dx(p, 0);
}

// K2: check the layer list against the colour head's shape and take the
// product passes from the wrapper's `sched` ([n, then layer, dx, n0, width,
// ring-image offset per pass]): fused_mlp.render_schedule's one forward pass
// per layer, in order, over the layer's padded width, each starting on a
// 16-byte boundary of the image. 1 if any of that fails.
int render_plan(Plan* p, const long long* sched) {
  const int L = p->n_layers;
  p->e_a = p->freqs_a > 0 ? 3 * (1 + 2 * p->freqs_a) : 3;
  const LayerDesc* d = p->L;
  bool ok = p->mode >= 0 && p->mode <= 2 && p->d_feat >= 0 &&
            d[0].K == 3 + (p->mode != 1 ? p->e_a : 0) + (p->mode != 2 ? 3 : 0) + p->d_feat;
  for (int l = 0; l < L; ++l) ok = ok && d[l].Np <= kMaxOut && (l == 0 || d[l].K == d[l - 1].N);
  if (!ok || sched[0] != L) return 1;
  p->n_prod = 0;
  for (int q = 0; q < L; ++q) {
    const long long* e = sched + 1 + 5 * q;
    if (e[0] != q || e[1] != 0 || e[2] != 0 || e[3] != d[q].Np || e[4] < 0 || e[4] % 8 ||
        add_prod(p, q, 0, 0, d[q].Np))
      return 1;
    p->q_off[q] = (int)e[4];
  }
  return 0;
}

// K4/K5: check the layer list against the NeRF's shape and take the product
// passes from the wrapper's `sched` ([n, then layer, dx, n0, width,
// ring-image offset per pass]). Their order, and the dynamic shared memory
// the launch gets, come from fused_mlp.nerf_schedule / nerf_launch_plan
// alone; here each pass must lie inside its layer and start on a 16-byte
// boundary of the image. 1 if any of that fails.
int nerf_plan(Plan* p, const long long* sched) {
  const int T = p->trunk;
  if (T < 1 || p->n_layers != T + 3) return 1;
  p->e_a = p->freqs_a > 0 ? p->d_a * (1 + 2 * p->freqs_a) : p->d_a;
  p->e_b = p->freqs_b > 0 ? 3 * (1 + 2 * p->freqs_b) : 3;
  const LayerDesc* L = p->L;
  const int wt = L[0].N;
  p->wf = L[T].N - 1;
  bool ok = L[0].K == p->e_a && wt % 16 == 0 && wt <= kMaxOut && !((p->skips >> (T - 1)) & 1u);
  for (int i = 0; i < T; ++i) ok = ok && L[i].N == wt;
  for (int i = 1; i <= T; ++i)
    ok = ok && L[i].K == wt + ((i < T && ((p->skips >> (i - 1)) & 1u)) ? p->e_a : 0);
  ok = ok && p->wf % 16 == 0 && p->wf <= kMaxOut && L[T + 1].K == p->wf + p->e_b &&
       L[T + 1].Np <= kMaxOut && L[T + 2].K == L[T + 1].N && L[T + 2].Kp <= kMaxOut &&
       L[T + 2].N == p->d_rgb + p->d_dpt;
  if (!ok || sched[0] < 1 || sched[0] > kMaxProds) return 1;
  p->n_prod = 0;
  for (int q = 0; q < (int)sched[0]; ++q) {
    const long long* e = sched + 1 + 5 * q;
    if (e[0] < 0 || e[0] >= p->n_layers || (e[1] != 0 && e[1] != 1) || e[2] < 0 ||
        e[2] + e[3] > (e[1] ? L[e[0]].Kp : L[e[0]].Np) || e[4] < 0 || e[4] % 8 ||
        add_prod(p, (int)e[0], (int)e[1], (int)e[2], (int)e[3]))
      return 1;
    p->q_off[q] = (int)e[4];
  }
  return 0;
}


// ---------------------------------------------------------------------------
// The split-operand f32 mode of K2-K5 and of the dW contraction
// ---------------------------------------------------------------------------
//
// JAX's default f32 policy runs the colour head, the depth head and the
// background NeRF through f32 `linear`s; the kernels above round every
// operand to bf16. The split mode keeps f32 accuracy on the tensor cores by
// 3xTF32, as K1 does (sdf_fwd.cu): each operand x is split into big =
// tf32(x) and small = tf32(x - big) (cut), and small*big + big*small +
// big*big accumulate in f32 (the dropped small*small is below 2^-21 of the
// product). Each 32-deep slab sums from zero in the tensor cores and its sum
// adds into the running accumulators in f32, since the tensor cores'
// accumulation truncates: summed over the whole K instead, a 256 x 256 layer
// at 65,536 rows departs from f64 by 1.8e-6 relative L2 against 2.3e-7 with
// the slab sums (f32 matmul: 2.0e-7), and runs no faster (0.092 against
// 0.088 ms; H100, PERF.md section 6).
//
// Why not the bf16 mode's tiles: hi/lo copies of both operands double K2's
// 128-row tiles to 286,720 bytes, more than a block's 232,448. So the split
// mode is one product kernel (split_gemm_kernel) whose epilogues carry the
// layers' bias, relu, sigmoid, the relu masks of the backward and the
// output's delta, launched once per layer (and once for every layer's dW),
// with the activations and deltas in f32 in global memory between the
// launches. The wrapper (fused_mlp._SplitOps) lists the launches. A layer's
// activations are 1 KB a row against 0.5-1.5 MFLOP of split products a row,
// so the products bound a wide layer: 3x its operations at the TF32 peak
// (495 TFLOP/s) against the bytes at 3.35 TB/s; an output of 16-96 columns
// moves more bytes than its products take.
//
// Two paths, by what B is:
//  - the weight path (split_gemm_kernel<BN>, below: every forward and dx
//    product, whose B is a layer's weights, the same for every row): the
//    weights are split once a call into an image in the layout wgmma reads
//    (split_gemm_kernel(SplitImages)), so a stage is two copies and no
//    conversion; the consumers keep a slab's wgmma in flight while they split
//    the next slab's A; the tile is as wide as the output allows (16, 32, 64,
//    96 or 128 columns, fused_mlp.split_tile). Bound: a 256 x 256 layer's
//    products (its operations, 0.052 ms at 65,536 rows), a narrow head's
//    bytes (A read once: 0.020 ms at 65,536 x 256 in);
//  - the contraction (split_gemm_kernel(SplitProbs), this section: dW = acts^T
//    dels over the rows, in row splits): its B is a delta made by the same
//    backward, N-major, with K the rows, read once, so an image would cost a
//    pass over the deltas for one use; the producer warpgroup splits each
//    landed B slab instead, and sums its columns (db) in the same pass. Bound:
//    bytes (acts and dels read once, 0.093 ms at K3's 65,536 rows).
//
// The contraction's kernel: C = A^T B over a group of problems (one launch:
// every dW of a backward), A [M, K] stored [K, M], B [K, N], in 128 x 128
// output tiles and 32-deep slabs. A CTA of three warpgroups is persistent: it
// walks the work items (tile, K split) blockIdx.x, + gridDim.x, ..., and its
// slabs stream through two rings without a CTA-wide barrier:
//  - one producer thread keeps TMA copies (cp.async.bulk.tensor.2d, a tensor
//    map per operand, boxes of 32-float rows in the 128-byte swizzle, so that
//    the fragment and column reads below are free of bank conflicts) of the
//    f32 slabs of A and B in flight, two slabs ahead, into a 3-stage ring of
//    mbarrier-guarded stages: four boxes of 32 x 32 a slab (a box wholly past
//    the matrix is not copied). TMA zero-fills past the matrix; a split's K
//    range is masked where it is read;
//  - the producer warpgroup's 128 threads split each landed B slab once for
//    the CTA, a column a thread, into big and small tf32 tiles in the K-major
//    no-swizzle core-matrix layout that wgmma reads (wgmma cannot transpose
//    tf32 operands, so the N-major deltas are transposed on the way), into a
//    2-stage ring; masked past N and past the split's K; the same pass sums
//    each column of B over the split's K in row order (Cb: db, from the CTAs
//    of the first row tile), so db takes no second pass over the deltas;
//  - two consumer warpgroups, 64 rows each, load their A fragments from the
//    f32 stage, split them in registers (wgmma's register-A form) and issue
//    wgmma.m64n128k8.tf32 three times per 8-deep step; they are not held to
//    each other, so one's wgmma runs while the other loads or adds its slab
//    sum.
// setmaxnreg gives the consumers 224 registers (the slab's partial sums and
// the running sums, 64 each, and 32 of A fragments) and the producers 56.
// The epilogue goes through a staging block a consumer warpgroup (the
// fragments' scattered columns cost 8 memory sectors a store): the registers
// through the epilogue into it, then the rows out, 16 bytes a thread. The
// partials go to C + split * c_split (summed in split order by
// reduce_dw_kernel). The barriers count warps (each warp's lane 0 arrives
// after the warp's __syncwarp), not threads. No atomics, and a fixed order
// of every sum, on both paths: two launches give the same bits.

constexpr int kSgM = 128, kSgN = 128, kSgK = 32;
constexpr int kSgStagesF = 3, kSgStagesC = 2, kSgLead = kSgStagesF - 1;
constexpr int kSgThreads = 384;
constexpr int kSgProducerRegs = 56, kSgConsumerRegs = 224;
constexpr int kSmMaxProbs = 16;
static_assert(kSgProducerRegs * 128 + kSgConsumerRegs * 256 <= 168 * kSgThreads,
              "the register split fits the 168 registers a thread of 384 has");

enum SplitEpi { kEpiNone = 0, kEpiRelu = 1, kEpiSigmoid = 2, kEpiMask = 3, kEpiDSigmoid = 4,
                kEpiDRelu = 5 };

// one product: epilogue `epi` on z = acc (+ bias[col]); aux: the relu mask's
// source (kEpiMask: columns < aux_n zeroed where aux <= 0) or the output's
// cotangent (kEpiDSigmoid / kEpiDRelu: columns < aux_n, zero past them).
// Columns < n_store go to C, the next n_store2 to C2 (from its column 0).
// Cb (or null): the column sums of op(B) over each split's K, at
// Cb + split * c_split.
struct SplitProb {
  CUtensorMap amap, bmap;  // A and B, as split_mm_launch encodes them
  const float* A;
  const float* B;
  float* C;
  float* C2;
  const float* bias;
  const float* aux;
  float* Cb;
  long long lda, ldb, ldc, ldc2, ldaux, c_split;
  int M, N, K, k_per_split, epi, aux_n, n_store, n_store2;
};

struct SplitProbs {
  int n, splits;
  int tile0[kSmMaxProbs + 1];  // each problem's first tile; tile0[n]: tiles of a split
  SplitProb q[kSmMaxProbs];
};

// A stage of the f32 ring: A's slab, then B's, 16 KB each in TMA's 128-byte
// swizzle (boxes of 32-float rows, 1024-byte aligned); the converted ring's
// stage: B's big and small tf32 tiles
constexpr int kSgStageF = 2 * kSgM * kSgK;  // floats
constexpr int kSgStageC = 2 * kSgN * kSgK;
constexpr int kSgStaging = 64 * kSgN;  // floats: a consumer warpgroup's output block
constexpr size_t kSgBars = sizeof(float) * ((size_t)kSgStagesF * kSgStageF +
                                            (size_t)kSgStagesC * kSgStageC + 2 * kSgStaging);
constexpr size_t kSgSmem = 1024 + kSgBars + sizeof(uint64_t) * 2 * (kSgStagesF + kSgStagesC);
static_assert(kSgSmem <= 232448, "a block's shared memory");
static_assert(kSgM * kSgK == kSgN * kSgK, "A's and B's slabs are the same size");

// float offset of (row r, column c) in TMA's 128-byte swizzle of 32-float
// rows from a 1024-byte boundary: 16-byte chunk c / 4 of row r at chunk
// (c / 4) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}
// A's (m, k) and B's (k, n) in their stage (both stored with K the rows):
// four boxes of 32 rows of k, each 32 of m (n) wide
__device__ __forceinline__ int sg_at(int k, int mn) { return (mn >> 5) * 1024 + swz(k, mn & 31); }

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xFFFFE000u;
}

// the work item `item` of a launch: its problem, tile origin and K range
struct SgItem {
  int pi, m0, n0, split, k_begin, k_end, n_slabs;
};

__device__ __forceinline__ SgItem sg_item(const SplitProbs& P, int item) {
  SgItem it;
  const int tiles = P.tile0[P.n];
  it.split = item / tiles;
  int t = item - it.split * tiles;
  int pi = 0;
  while (t >= P.tile0[pi + 1]) ++pi;
  t -= P.tile0[pi];
  const SplitProb& q = P.q[pi];
  const int tiles_n = (q.N + kSgN - 1) / kSgN;
  it.pi = pi;
  it.m0 = (t / tiles_n) * kSgM;
  it.n0 = (t % tiles_n) * kSgN;
  it.k_begin = it.split * q.k_per_split;
  it.k_end = min(q.K, it.k_begin + q.k_per_split);
  it.n_slabs = (it.k_end - it.k_begin + kSgK - 1) / kSgK;  // >= 1: read_split_probs
  return it;
}

// the CTA's slabs in order: (item, slab s of it); g counts them
struct SgSeq {
  SgItem it;
  int item, s, g;
  bool valid;
  __device__ __forceinline__ void start(const SplitProbs& P, int total) {
    item = blockIdx.x;
    s = 0;
    g = 0;
    valid = item < total;
    if (valid) it = sg_item(P, item);
  }
  __device__ __forceinline__ void next(const SplitProbs& P, int total) {
    ++g;
    if (++s < it.n_slabs) return;
    s = 0;
    item += gridDim.x;
    valid = item < total;
    if (valid) it = sg_item(P, item);
  }
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// box (c0 inner, c1 outer) of the tensor `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// the warp's arrival on bar, after every lane's earlier accesses
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// the copying thread: slab `sq` into its f32 stage, arriving on the stage's
// `full` barrier with the bytes of the boxes it copies
__device__ __forceinline__ void sg_copy(const SplitProbs& P, const SgSeq& sq, float* ringF,
                                        uint64_t* full, uint64_t* empty) {
  const int st = sq.g % kSgStagesF;
  // the stage's previous slab, g - kSgStagesF, released by every reader
  mbar_wait(&empty[st], ((sq.g / kSgStagesF) & 1) ^ 1);
  const SplitProb& q = P.q[sq.it.pi];
  const int k0 = sq.it.k_begin + sq.s * kSgK;
  float* As = ringF + (size_t)st * kSgStageF;
  float* Bs = As + kSgM * kSgK;
  const int na = min(4, (q.M - sq.it.m0 + 31) / 32);
  const int nb = min(4, (q.N - sq.it.n0 + 31) / 32);
  mbar_expect_tx(&full[st], 4 * 32 * kSgK * (na + nb));
  for (int b = 0; b < na; ++b)
    tma_load_2d(As + b * 1024, &q.amap, sq.it.m0 + 32 * b, k0, &full[st]);
  for (int b = 0; b < nb; ++b)
    tma_load_2d(Bs + b * 1024, &q.bmap, sq.it.n0 + 32 * b, k0, &full[st]);
}

// d[64 x N] (+)= A[64 x 8] B[8 x N]: A from registers (4 tf32 a thread), B a
// K-major shared-memory descriptor; scale_d 0 starts from zero. Register
// 4j + 2h + e of a thread (warp w, lane 4g + t) holds row 16w + g + 8h,
// column 8j + 2t + e.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<96>(float* d, const uint32_t* a, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// the epilogue `EPI` of z, with `a` its aux value (past aux_n: 1 for the
// relu mask, which keeps z, and 0 for the output's delta)
template <int EPI>
__device__ __forceinline__ float sg_act(float z, float a) {
  if (EPI == kEpiRelu) return fmaxf(z, 0.0f);
  if (EPI == kEpiSigmoid) return 1.0f / (1.0f + expf(-z));
  if (EPI == kEpiMask) return a > 0.0f ? z : 0.0f;
  if (EPI == kEpiDSigmoid) {
    const float y = 1.0f / (1.0f + expf(-z));
    return a * y * (1.0f - y);
  }
  if (EPI == kEpiDRelu) return a * (z > 0.0f ? 1.0f : 0.0f);
  return z;
}

// (row r, column c) of a warpgroup's 64 x 128 staging block; the XOR keeps
// the fragment writes and the row reads free of bank conflicts
__device__ __forceinline__ int stg(int r, int c) { return r * kSgN + (c ^ ((r & 7) << 3)); }

__device__ __forceinline__ void wg_bar(int wc) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wc) : "memory");
}

// A consumer warpgroup's epilogue of its 64 rows of the item's tile (a dW
// partial): the registers into the staging block, then the block stored by
// rows (16-byte stores where the row's four columns are in C): the
// fragments' scattered accesses stay in shared memory
__device__ __forceinline__ void sg_epilogue(const SplitProb& q, const SgItem& it, int wc,
                                            float* staging, const float (&acc)[64]) {
  const int tl = threadIdx.x & 127;
  const int g = (tl & 31) >> 2, tq = tl & 3;
  const int r0 = (tl >> 5) * 16 + g;  // staging rows r0 and r0 + 8
  const int m_base = it.m0 + wc * 64;
  wg_bar(wc);  // the previous item's stores have read the block
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(staging + stg(r0 + 8 * h, 8 * j + 2 * tq)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  wg_bar(wc);
  float* C = q.C + (size_t)it.split * q.c_split;
  for (int i = tl; i < 64 * (kSgN / 4); i += 128) {
    const int r = i / (kSgN / 4), c = (i % (kSgN / 4)) * 4;
    const int m = m_base + r, col = it.n0 + c;
    if (m >= q.M || col >= q.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(staging + stg(r, c));
    float* dst = C + (size_t)m * q.ldc + col;
    if (col + 3 < q.N && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = v;
      continue;
    }
    const float* pv = &v.x;
    for (int e = 0; e < 4 && col + e < q.N; ++e) dst[e] = pv[e];
  }
}

// The producer warpgroup: thread 0 copies kSgLead slabs ahead; every thread
// splits column t of each landed B slab into the converted ring.
__device__ __forceinline__ void sg_producer(const SplitProbs& P, int total, float* ringF,
                                            uint32_t* ringC, uint64_t* fullF, uint64_t* emptyF,
                                            uint64_t* fullC, uint64_t* emptyC) {
  const int t = threadIdx.x;  // 0..127
  const bool copier = t == 0;
  SgSeq sq, ahead;
  sq.start(P, total);
  ahead.start(P, total);
  if (copier)
    for (int i = 0; i < kSgLead && ahead.valid; ++i) {
      sg_copy(P, ahead, ringF, fullF, emptyF);
      ahead.next(P, total);
    }
  float colsum = 0.0f;
  for (; sq.valid; sq.next(P, total)) {
    if (copier && ahead.valid) {
      sg_copy(P, ahead, ringF, fullF, emptyF);
      ahead.next(P, total);
    }
    const SplitProb& q = P.q[sq.it.pi];
    const int stF = sq.g % kSgStagesF, stC = sq.g % kSgStagesC;
    mbar_wait(&fullF[stF], (sq.g / kSgStagesF) & 1);
    mbar_wait(&emptyC[stC], ((sq.g / kSgStagesC) & 1) ^ 1);
    const float* Bs = ringF + (size_t)stF * kSgStageF + kSgM * kSgK;
    uint32_t* big = ringC + (size_t)stC * kSgStageC;
    uint32_t* small = big + kSgN * kSgK;
    const int k0 = sq.it.k_begin + sq.s * kSgK;
    const bool col_ok = sq.it.n0 + t < q.N;
    const bool sums = q.Cb != nullptr && sq.it.m0 == 0;
#pragma unroll
    for (int kq = 0; kq < kSgK / 4; ++kq) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = Bs[sg_at(4 * kq + j, t)];
      uint4 hb, hs;
      uint32_t* pb = &hb.x;
      uint32_t* ps = &hs.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = col_ok && k0 + 4 * kq + j < sq.it.k_end ? v[j] : 0.0f;
        split_tf32(x, pb[j], ps[j]);
        if (sums) colsum += x;
      }
      const int at = (t >> 3) * (8 * kSgK) + kq * 32 + (t & 7) * 4;
      *reinterpret_cast<uint4*>(big + at) = hb;
      *reinterpret_cast<uint4*>(small + at) = hs;
    }
    fence_async_smem();  // the converted tiles, to wgmma's async proxy
    warp_arrive(&fullC[stC]);
    warp_arrive(&emptyF[stF]);
    if (sums && sq.s + 1 == sq.it.n_slabs) {
      if (col_ok) q.Cb[(size_t)sq.it.split * q.c_split + sq.it.n0 + t] = colsum;
      colsum = 0.0f;
    }
  }
}

// A consumer warpgroup (wc 0 or 1): rows wc*64 .. +63 of each tile
__device__ __forceinline__ void sg_consumer(const SplitProbs& P, int total, int wc,
                                            const float* ringF, const uint32_t* ringC,
                                            float* staging, uint64_t* fullF, uint64_t* emptyF,
                                            uint64_t* fullC, uint64_t* emptyC) {
  const int lane = threadIdx.x & 31;
  const int q4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int rA = wc * 64 + q4 * 16 + g;  // tile rows rA and rA + 8
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  SgSeq sq;
  sq.start(P, total);
  while (sq.valid) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const SgItem it = sq.it;
    const SplitProb& q = P.q[it.pi];
    const bool row0 = it.m0 + rA < q.M, row1 = it.m0 + rA + 8 < q.M;
    for (int s = 0; s < it.n_slabs; ++s, sq.next(P, total)) {
      const int stF = sq.g % kSgStagesF, stC = sq.g % kSgStagesC;
      mbar_wait(&fullF[stF], (sq.g / kSgStagesF) & 1);
      const float* As = ringF + (size_t)stF * kSgStageF;
      const int kr = it.k_end - (it.k_begin + s * kSgK);  // valid k of the slab
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c0 = 8 * ks + tq, c1 = c0 + 4;
        float a[4];
        a[0] = As[sg_at(c0, rA)];
        a[1] = As[sg_at(c0, rA + 8)];
        a[2] = As[sg_at(c1, rA)];
        a[3] = As[sg_at(c1, rA + 8)];
        a[0] = row0 && c0 < kr ? a[0] : 0.0f;
        a[1] = row1 && c0 < kr ? a[1] : 0.0f;
        a[2] = row0 && c1 < kr ? a[2] : 0.0f;
        a[3] = row1 && c1 < kr ? a[3] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[ks][e], as[ks][e]);
      }
      warp_arrive(&emptyF[stF]);  // the warp is done with the f32 stage
      mbar_wait(&fullC[stC], (sq.g / kSgStagesC) & 1);
      const uint32_t* big = ringC + (size_t)stC * kSgStageC;
      const uint32_t* small = big + kSgN * kSgK;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // K-adjacent core matrices 128 bytes apart, 8-column groups 1 KB apart
        const uint64_t dbig = wg_desc(big + 64 * ks, 128, 8 * kSgK * 4);
        const uint64_t dsmall = wg_desc(small + 64 * ks, 128, 8 * kSgK * 4);
        wgmma_tf32<kSgN>(part, as[ks], dbig, ks != 0);
        wgmma_tf32<kSgN>(part, ab[ks], dsmall, 1);
        wgmma_tf32<kSgN>(part, ab[ks], dbig, 1);
      }
      wg_commit();
      wg_wait<0>();
      warp_arrive(&emptyC[stC]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    sg_epilogue(q, it, wc, staging, acc);
  }
}

// the contraction (A stored [K, M], B [K, N]: acts^T dels)
__global__ void __launch_bounds__(kSgThreads, 1)
    split_gemm_kernel(const __grid_constant__ SplitProbs P) {
  extern __shared__ __align__(128) float smf[];
  // the rings from the first 1024-byte boundary (TMA's swizzle repeats there)
  char* base = reinterpret_cast<char*>(smf) + ((1024 - (smem_u32(smf) & 1023)) & 1023);
  float* ringF = reinterpret_cast<float*>(base);
  uint32_t* ringC = reinterpret_cast<uint32_t*>(ringF + (size_t)kSgStagesF * kSgStageF);
  float* staging = reinterpret_cast<float*>(ringC + (size_t)kSgStagesC * kSgStageC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kSgBars);
  uint64_t* fullF = bars;
  uint64_t* emptyF = fullF + kSgStagesF;
  uint64_t* fullC = emptyF + kSgStagesF;
  uint64_t* emptyC = fullC + kSgStagesC;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSgStagesF; ++i) {
      mbar_init(&fullF[i], 1);       // the copying thread
      mbar_init(&emptyF[i], 4 + 8);  // every producer and consumer warp
    }
    for (int i = 0; i < kSgStagesC; ++i) {
      mbar_init(&fullC[i], 4);   // the producer warps
      mbar_init(&emptyC[i], 8);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int total = P.tile0[P.n] * P.splits;
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kSgProducerRegs));
    sg_producer(P, total, ringF, ringC, fullF, emptyF, fullC, emptyC);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kSgConsumerRegs));
    sg_consumer(P, total, wg - 1, ringF, ringC, staging + (wg - 1) * kSgStaging, fullF, emptyF,
                fullC, emptyC);
  }
}

// ---------------------------------------------------------------------------
// The weight path of split_gemm_kernel: C = epi(A W + bias) or epi(A W^T),
// where W is a layer's weights (every forward and dx product of K2-K5)
// ---------------------------------------------------------------------------
//
// The weight image (split_gemm_kernel(SplitImages), once a call for each
// layer and orientation the call runs): B = W [K, N] or W^T, split into big
// and small tf32 and laid out as the weight path's stages read it. For a tile
// width BN (chosen from N by fused_mlp.split_tile), block (column tile j,
// slab s) of 2 * BN * 32 words sits at (j * n_slabs + s) * 2 * BN * 32: the
// big tile, then the small one, element (k, n) of each at (n / 8) * 256 +
// (k / 4) * 32 + (n % 8) * 4 + k % 4, the K-major no-swizzle core-matrix
// order of wgmma's B descriptor (LBO 128 bytes, SBO 1,024); zero past K and N.
// So one bulk copy of 256 * BN bytes lands a slab where wgmma reads it.
//
// The kernel (split_gemm_kernel<BN>): 128-row tiles of BN columns (16, 32,
// 64, 96 or 128; BN x 32 of image a slab), persistent CTAs of three
// warpgroups walking the tiles blockIdx.x, + gridDim.x, ... (a row block's
// column tiles side by side, so A comes from HBM once); one thread of the
// first warpgroup keeps every stage of a ring of WpShape<BN>::kStages (3 at
// BN 128, 4 at 96, 6 below) in flight: A's f32 slab by TMA (the 128-byte
// swizzle) and the image's block by one bulk copy, both on the stage's
// barrier. Each consumer warpgroup (64 rows) issues the slab's 12 wgmma
// (small*big, big*small, big*big per 8-deep step, from zero), and while they
// run loads and splits its A fragments of the next slab; then it waits,
// releases the stage and adds the slab's sums into its accumulators in f32.
// Each tile's bias and aux block (the relu mask's source or the output's
// cotangent) are copied into shared memory by cp.async when the tile starts,
// so the epilogue waits for no load of its own. setmaxnreg gives the
// consumers 232 registers (running and slab sums, BN / 2 each, and two sets
// of A fragments, 32 each) and the copying warpgroup 40.
// A tile wider than 128 columns would read A once for a 256-wide layer, but
// its running and slab sums (128 registers each) do not fit beside the
// fragments; at BN 128 the tile moves 48 KB of L2 a slab, 4.6 TB/s at the
// 256 x 256 layer's 0.086 ms, where the tensor cores are 60% busy.

constexpr int kWpThreads = 384;
constexpr int kWpProducerRegs = 40, kWpConsumerRegs = 232;
constexpr int kWpMaxStages = 6;
constexpr int kWpMaxImages = 2 * kMaxLayers;
static_assert(kWpProducerRegs * 128 + kWpConsumerRegs * 256 <= 168 * kWpThreads,
              "the register split fits the 168 registers a thread of 384 has");

template <int BN>
struct WpShape {
  static constexpr int kStageB = 2 * BN * kSgK;          // words: the image's block
  static constexpr int kStage = kSgM * kSgK + kStageB;   // words: A's f32 slab, then B's
  static constexpr int kStaging = 64 * BN;               // floats: a consumer warpgroup's block
  static constexpr size_t kFixed = 1024 + 4 * (size_t)(2 * kStaging + 2 * BN) +
                                   16 * (size_t)kWpMaxStages;
  static constexpr int kFit = (int)((232448 - kFixed) / (4 * (size_t)kStage));
  static constexpr int kStages = kFit < kWpMaxStages ? kFit : kWpMaxStages;
  // bytes from the 1024-byte boundary to the barriers, then the whole carve
  static constexpr size_t kBars = 4 * ((size_t)kStages * kStage + 2 * kStaging + 2 * BN);
  static constexpr size_t kSmem = 1024 + kBars + 16 * (size_t)kStages;
  static_assert(kStages >= 3 && kSmem <= 232448, "a block's shared memory");
  static_assert((4 * kStage) % 1024 == 0, "each stage's A slab on a 1024-byte boundary");
  static_assert(BN % 16 == 0 && BN <= kSgN, "a tile is 16 to 128 columns");
};

// a tile of the launch: its problem, origin, column tile and slabs
struct WpItem {
  int pi, m0, n0, tile_n, n_slabs;
};

template <int BN>
__device__ __forceinline__ WpItem wp_item(const SplitProbs& P, int item) {
  int pi = 0;
  while (item >= P.tile0[pi + 1]) ++pi;
  const int t = item - P.tile0[pi];
  const SplitProb& q = P.q[pi];
  const int tiles_n = (q.N + BN - 1) / BN;
  WpItem it;
  it.pi = pi;
  it.tile_n = t % tiles_n;  // a row block's column tiles are neighbours: A read once from HBM
  it.m0 = (t / tiles_n) * kSgM;
  it.n0 = it.tile_n * BN;
  it.n_slabs = (q.K + kSgK - 1) / kSgK;
  return it;
}

// 4-byte cp.async; with `bytes` = 0 the destination is zero-filled
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// (row r, column c) of a consumer warpgroup's 64 x BN block: the XOR of
// bits 3-4 keeps the fragment writes at two wavefronts and the row reads
// free of bank conflicts, inside the row at every BN
template <int BN>
__device__ __forceinline__ int wp_stg(int r, int c) {
  return r * BN + (c ^ (((r & 3) << 3) & (BN - 1)));
}

// the producer thread: every slab of the CTA's tiles into the ring
template <int BN>
__device__ __forceinline__ void wp_producer(const SplitProbs& P, int total, float* ring,
                                            uint64_t* full, uint64_t* empty) {
  using S = WpShape<BN>;
  int g = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const WpItem it = wp_item<BN>(P, item);
    const SplitProb& q = P.q[it.pi];
    const float* img = q.B + (size_t)it.tile_n * it.n_slabs * S::kStageB;
    for (int s = 0; s < it.n_slabs; ++s, ++g) {
      const int st = g % S::kStages;
      mbar_wait(&empty[st], ((g / S::kStages) & 1) ^ 1);
      float* As = ring + (size_t)st * S::kStage;
      mbar_expect_tx(&full[st], 4 * kSgM * kSgK);
      tma_load_2d(As, &q.amap, s * kSgK, it.m0, &full[st]);
      bulk_load(As + kSgM * kSgK, img + (size_t)s * S::kStageB, 4 * S::kStageB, &full[st]);
    }
  }
}

// a consumer thread's A fragments of stage st (rows rA and rA + 8, columns
// 8 ks + tq and + 4), split into big and small tf32; rows past M and
// columns past K are TMA's zeros
__device__ __forceinline__ void wp_frags(const float* As, int rA, int tq, uint32_t (&ab)[4][4],
                                         uint32_t (&as)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c0 = 8 * ks + tq, c1 = c0 + 4;
    split_tf32(As[swz(rA, c0)], ab[ks][0], as[ks][0]);
    split_tf32(As[swz(rA + 8, c0)], ab[ks][1], as[ks][1]);
    split_tf32(As[swz(rA, c1)], ab[ks][2], as[ks][2]);
    split_tf32(As[swz(rA + 8, c1)], ab[ks][3], as[ks][3]);
  }
}

template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// a tile's bias (BN floats) and, for the epilogues that read one, its aux
// block (64 x BN of the warpgroup's rows) into shared memory, zero past the
// bias, past aux_n and past M: one cp.async group of the warpgroup
template <int BN>
__device__ __forceinline__ void wp_prefetch(const SplitProb& q, const WpItem& it, int wc,
                                            float* staging, float* biasS) {
  const int tl = threadIdx.x & 127;
  for (int c = 4 * tl; c < BN; c += 4 * 128) {
    const int col = it.n0 + c;
    const float* src = q.bias != nullptr ? q.bias + col : nullptr;
    if (src != nullptr && col + 3 < q.N && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16_zfill(biasS + c, src, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = src != nullptr && col + e < q.N;
        cp_async4_zfill(biasS + c + e, in ? src + e : q.C, in ? 4 : 0);
      }
    }
  }
  if (q.epi >= kEpiMask) {
    const int m_base = it.m0 + wc * 64;
    for (int i = tl; i < 64 * (BN / 4); i += 128) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int m = m_base + r, col = it.n0 + c;
      float* dst = staging + wp_stg<BN>(r, c);
      const float* src = q.aux + (size_t)(m < q.M ? m : 0) * q.ldaux + col;
      if (m < q.M && col + 3 < q.aux_n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16_zfill(dst, src, 16);
      } else if (m < q.M && col < q.aux_n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = col + e < q.aux_n;
          cp_async4_zfill(dst + e, in ? src + e : q.aux, in ? 4 : 0);
        }
      } else {
        cp_async16_zfill(dst, q.aux, 0);
      }
    }
  }
  cp_async_commit();
}

// A consumer warpgroup's epilogue of its 64 rows of the tile: each register
// through bias and EPI into the staging block (the aux value from the same
// place), then the block stored by rows (16-byte stores where the row's four
// columns go to C)
template <int BN, int EPI>
__device__ __forceinline__ void wp_epilogue(const SplitProb& q, const WpItem& it, int wc,
                                            float* staging, const float* biasS,
                                            const float (&acc)[BN / 2]) {
  const int tl = threadIdx.x & 127;
  const int g = (tl & 31) >> 2, tq = tl & 3;
  const int r0 = (tl >> 5) * 16 + g;  // staging rows r0 and r0 + 8
  cp_async_wait<0>();
  wg_bar(wc);  // every thread's bias and aux copies have landed
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float b0 = biasS[c], b1 = biasS[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* at = reinterpret_cast<float2*>(staging + wp_stg<BN>(r0 + 8 * h, c));
      float2 a = make_float2(0.0f, 0.0f);
      if (EPI >= kEpiMask) {
        a = *at;
        if (EPI == kEpiMask) {  // past aux_n the mask keeps z
          if (it.n0 + c >= q.aux_n) a.x = 1.0f;
          if (it.n0 + c + 1 >= q.aux_n) a.y = 1.0f;
        }
      }
      *at = make_float2(sg_act<EPI>(acc[4 * j + 2 * h] + b0, a.x),
                        sg_act<EPI>(acc[4 * j + 2 * h + 1] + b1, a.y));
    }
  }
  wg_bar(wc);
  const int m_base = it.m0 + wc * 64;
  for (int i = tl; i < 64 * (BN / 4); i += 128) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int m = m_base + r, col = it.n0 + c;
    if (m >= q.M || col >= q.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(staging + wp_stg<BN>(r, c));
    float* dst = q.C + (size_t)m * q.ldc + col;
    if (col + 3 < q.n_store && col + 3 < q.N && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = v;
      continue;
    }
    const float* pv = &v.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = col + e;
      if (cc >= q.N) break;
      if (cc < q.n_store)
        q.C[(size_t)m * q.ldc + cc] = pv[e];
      else if (cc - q.n_store < q.n_store2)
        q.C2[(size_t)m * q.ldc2 + cc - q.n_store] = pv[e];
    }
  }
  wg_bar(wc);  // the block is read: the next tile may copy into it
}

// the 12 wgmma of a slab into d, from zero: small*big, big*small, big*big
// per 8-deep step
template <int BN>
__device__ __forceinline__ void wp_issue(float (&d)[BN / 2], const uint32_t (&ab)[4][4],
                                         const uint32_t (&as)[4][4], const uint32_t* big,
                                         const uint32_t* small) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // K-adjacent core matrices 128 bytes apart, 8-column groups 1 KB apart
    const uint64_t dbig = wg_desc(big + 64 * ks, 128, 8 * kSgK * 4);
    const uint64_t dsmall = wg_desc(small + 64 * ks, 128, 8 * kSgK * 4);
    wgmma_tf32<BN>(d, as[ks], dbig, ks != 0);
    wgmma_tf32<BN>(d, ab[ks], dsmall, 1);
    wgmma_tf32<BN>(d, ab[ks], dbig, 1);
  }
}

// one slab of a consumer warpgroup: issue its wgmma on the A fragments `a*`
// and the stage's image, load and split the next slab's fragments into `n*`
// while they run, then wait, release the stage and add the slab's sums
template <int BN>
__device__ __forceinline__ void wp_slab(const float* ring, int g, bool has_next, int rA, int tq,
                                        float (&acc)[BN / 2], float (&part)[BN / 2],
                                        const uint32_t (&ab)[4][4], const uint32_t (&as)[4][4],
                                        uint32_t (&nb)[4][4], uint32_t (&ns)[4][4],
                                        uint64_t* full, uint64_t* empty) {
  using S = WpShape<BN>;
  const int st = g % S::kStages;
  const uint32_t* big =
      reinterpret_cast<const uint32_t*>(ring + (size_t)st * S::kStage + kSgM * kSgK);
  const uint32_t* small = big + BN * kSgK;
  wg_fence();
  wp_issue<BN>(part, ab, as, big, small);
  wg_commit();
  if (has_next) {
    const int nst = (g + 1) % S::kStages;
    mbar_wait(&full[nst], ((g + 1) / S::kStages) & 1);
    wp_frags(ring + (size_t)nst * S::kStage, rA, tq, nb, ns);
  }
  wg_wait<0>();
  warp_arrive(&empty[st]);
  reg_fence(part);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
}

// A consumer warpgroup (wc 0 or 1): rows wc*64 .. +63 of each tile
template <int BN>
__device__ __forceinline__ void wp_consumer(const SplitProbs& P, int total, int wc,
                                            const float* ring, float* staging, float* biasS,
                                            uint64_t* full, uint64_t* empty) {
  using S = WpShape<BN>;
  const int lane = threadIdx.x & 31;
  const int q4 = (threadIdx.x >> 5) & 3;
  const int tq = lane & 3;
  const int rA = wc * 64 + q4 * 16 + (lane >> 2);  // tile rows rA and rA + 8
  float acc[BN / 2], part[BN / 2];
  uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
  int g = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const WpItem it = wp_item<BN>(P, item);
    const SplitProb& q = P.q[it.pi];
    wp_prefetch<BN>(q, it, wc, staging, biasS);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    {
      const int st = g % S::kStages;
      mbar_wait(&full[st], (g / S::kStages) & 1);
      wp_frags(ring + (size_t)st * S::kStage, rA, tq, ab0, as0);
    }
    // two slabs an iteration, so that each fragment set keeps its registers
    for (int s = 0; s < it.n_slabs; s += 2) {
      wp_slab<BN>(ring, g++, s + 1 < it.n_slabs, rA, tq, acc, part, ab0, as0, ab1, as1, full,
                  empty);
      if (s + 1 < it.n_slabs)
        wp_slab<BN>(ring, g++, s + 2 < it.n_slabs, rA, tq, acc, part, ab1, as1, ab0, as0, full,
                    empty);
    }
    switch (q.epi) {
      case kEpiRelu: wp_epilogue<BN, kEpiRelu>(q, it, wc, staging, biasS, acc); break;
      case kEpiSigmoid: wp_epilogue<BN, kEpiSigmoid>(q, it, wc, staging, biasS, acc); break;
      case kEpiMask: wp_epilogue<BN, kEpiMask>(q, it, wc, staging, biasS, acc); break;
      case kEpiDSigmoid: wp_epilogue<BN, kEpiDSigmoid>(q, it, wc, staging, biasS, acc); break;
      case kEpiDRelu: wp_epilogue<BN, kEpiDRelu>(q, it, wc, staging, biasS, acc); break;
      default: wp_epilogue<BN, kEpiNone>(q, it, wc, staging, biasS, acc); break;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kWpThreads, 1)
    split_gemm_kernel(const __grid_constant__ SplitProbs P) {
  using S = WpShape<BN>;
  extern __shared__ __align__(128) float smf[];
  // the ring from the first 1024-byte boundary (TMA's swizzle repeats there)
  char* base = reinterpret_cast<char*>(smf) + ((1024 - (smem_u32(smf) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(base);
  float* staging = ring + (size_t)S::kStages * S::kStage;
  float* biasS = staging + 2 * S::kStaging;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + S::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 2);   // the copying thread, once with each copy's bytes
      mbar_init(&empty[i], 8);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int total = P.tile0[P.n];
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWpProducerRegs));
    if (threadIdx.x == 0) wp_producer<BN>(P, total, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWpConsumerRegs));
    const int wc = wg - 1;
    wp_consumer<BN>(P, total, wc, ring, staging + wc * S::kStaging, biasS + wc * BN, full,
                    empty);
  }
}

// the weight images of a call: image i from W_i ([rows, ldw] row-major; B =
// W, or W^T with trans) for a K x N product in tiles of bn columns
struct SplitImage {
  const float* W;
  long long ldw;
  int K, N, trans, bn;
  float* dst;
};
struct SplitImages {
  int n;
  long long begin[kWpMaxImages + 1];  // each image's first (big, small) pair; begin[n]: all
  SplitImage im[kWpMaxImages];
};

// words of a K x N image in tiles of bn columns
__host__ __device__ __forceinline__ long long image_words(int K, int N, int bn) {
  return (long long)((N + bn - 1) / bn) * ((K + kSgK - 1) / kSgK) * 2 * bn * kSgK;
}

__global__ void split_gemm_kernel(const __grid_constant__ SplitImages I) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < I.begin[I.n];
       p += (long long)gridDim.x * blockDim.x) {
    int i = 0;
    while (p >= I.begin[i + 1]) ++i;
    const SplitImage& im = I.im[i];
    const long long e = p - I.begin[i];  // (big, small) pair e of the image
    const int per = im.bn * kSgK;        // words of a tile's big (or small) block
    const long long blk = e / per;
    const int w = (int)(e - blk * per);
    const int n_slabs = (im.K + kSgK - 1) / kSgK;
    const int tile = (int)(blk / n_slabs), s = (int)(blk - (long long)tile * n_slabs);
    const int n = tile * im.bn + (w >> 8) * 8 + ((w & 31) >> 2);
    const int k = s * kSgK + ((w & 255) >> 5) * 4 + (w & 3);
    float x = 0.0f;
    if (n < im.N && k < im.K)
      x = im.trans ? im.W[(size_t)n * im.ldw + k] : im.W[(size_t)k * im.ldw + n];
    uint32_t big, small;
    split_tf32(x, big, small);
    float* out = im.dst + blk * 2 * per + w;
    out[0] = __uint_as_float(big);
    out[per] = __uint_as_float(small);
  }
}

// dst[r, c] for c < width: embedding column c of src row r (d values, `freqs`
// bands; freqs 0 copies the row), zero from the embedding's width on
__global__ void split_embed_kernel(const float* __restrict__ src, long long lds, int d,
                                   int freqs, int n, float* __restrict__ dst, long long ldd,
                                   int width) {
  const int e = freqs > 0 ? d * (1 + 2 * freqs) : d;
  const long long total = (long long)n * width;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / width);
    const int c = (int)(i % width);
    dst[r * ldd + c] = c < e ? embed_at(src + r * lds, d, c) : 0.0f;
  }
}

// out[r, j] = the embedding's VJP for input dim j of x (d values, `freqs`
// bands) of the cotangent sum over the sources (each [n, e] at src[k] with
// stride ld[k]), summed in source order
struct SplitVjpSrc {
  int n_src;
  const float* src[4];
  long long ld[4];
};

__global__ void split_embed_vjp_kernel(SplitVjpSrc S, const float* __restrict__ x, int d,
                                       int freqs, int n, float* __restrict__ out) {
  const long long total = (long long)n * d;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / d);
    const int j = (int)(i % d);
    auto demb = [&](int c) {
      float v = S.src[0][r * S.ld[0] + c];
      for (int k = 1; k < S.n_src; ++k) v += S.src[k][r * S.ld[k] + c];
      return v;
    };
    out[i] = freqs > 0 ? embed_vjp(demb, x + (long long)r * d, d, j, freqs) : demb(j);
  }
}

// the int64 records of split_mm_launch: 21 values a problem
constexpr int kSplitProbWords = 21;

// cuTensorMapEncodeTiled, from the driver through the runtime (no libcuda
// link), or null
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major f32 matrix [outer, inner] (row stride ld
// floats), boxes of box_outer rows of 32 floats in the 128-byte swizzle,
// zero past the matrix; 1 on failure
int encode_map(CUtensorMap* map, const float* base, int inner, int outer, long long ld,
               int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1;
  const cuuint64_t dim[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dim, stride, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
         CUDA_SUCCESS;
}

int read_split_probs(const long long* w, int n, int splits, SplitProbs* P) {
  if (n < 1 || n > kSmMaxProbs) return 1;
  P->n = n;
  P->splits = splits;
  P->tile0[0] = 0;
  for (int i = 0; i < n; ++i) {
    const long long* v = w + kSplitProbWords * i;
    SplitProb& q = P->q[i];
    q.A = reinterpret_cast<const float*>(v[0]);
    q.lda = v[1];
    q.B = reinterpret_cast<const float*>(v[2]);
    q.ldb = v[3];
    q.C = reinterpret_cast<float*>(v[4]);
    q.ldc = v[5];
    q.M = (int)v[6];
    q.N = (int)v[7];
    q.K = (int)v[8];
    q.bias = reinterpret_cast<const float*>(v[9]);
    q.epi = (int)v[10];
    q.aux = reinterpret_cast<const float*>(v[11]);
    q.ldaux = v[12];
    q.aux_n = (int)v[13];
    q.n_store = (int)v[14];
    q.C2 = reinterpret_cast<float*>(v[15]);
    q.ldc2 = v[16];
    q.n_store2 = (int)v[17];
    q.c_split = v[18];
    q.k_per_split = (int)v[19];
    q.Cb = reinterpret_cast<float*>(v[20]);
    // TMA: operand bases and row strides aligned to 16 bytes, a row stride
    // at least its row; every split holds at least one row of K; a partial
    // product, stored whole (no bias, epilogue or second output)
    const bool ok = q.A && q.B && q.C && q.M >= 0 && q.N > 0 && q.K > 0 && q.lda % 4 == 0 &&
                    q.ldb % 4 == 0 && (v[0] & 15) == 0 && (v[2] & 15) == 0 && q.lda >= q.M &&
                    q.ldb >= q.N && !q.bias && q.epi == kEpiNone && !q.aux && q.n_store == q.N &&
                    q.n_store2 == 0 && q.k_per_split > 0 && q.k_per_split % kSgK == 0 &&
                    (long long)splits * q.k_per_split >= q.K &&
                    (long long)(splits - 1) * q.k_per_split < q.K &&
                    (splits == 1 || q.c_split > 0);
    if (!ok) return 1;
    if (q.M > 0 && (encode_map(&q.amap, q.A, q.M, q.K, q.lda, 32) ||
                    encode_map(&q.bmap, q.B, q.N, q.K, q.ldb, 32)))
      return 1;
    P->tile0[i + 1] = P->tile0[i] + ((q.M + kSgM - 1) / kSgM) * ((q.N + kSgN - 1) / kSgN);
  }
  return 0;
}

// the weight products' 17-word records (split_wmm_launch) in tiles of bn
// columns; 1 if a record is malformed
int read_weight_probs(const long long* w, int n, int bn, SplitProbs* P) {
  if (n < 1 || n > kSmMaxProbs || bn < 16 || bn > kSgN || bn % 16) return 1;
  P->n = n;
  P->splits = 1;
  P->tile0[0] = 0;
  for (int i = 0; i < n; ++i) {
    const long long* v = w + 17 * i;
    SplitProb q{};
    q.A = reinterpret_cast<const float*>(v[0]);
    q.lda = v[1];
    q.B = reinterpret_cast<const float*>(v[2]);
    q.C = reinterpret_cast<float*>(v[3]);
    q.ldc = v[4];
    q.M = (int)v[5];
    q.N = (int)v[6];
    q.K = (int)v[7];
    q.bias = reinterpret_cast<const float*>(v[8]);
    q.epi = (int)v[9];
    q.aux = reinterpret_cast<const float*>(v[10]);
    q.ldaux = v[11];
    q.aux_n = (int)v[12];
    q.n_store = (int)v[13];
    q.C2 = reinterpret_cast<float*>(v[14]);
    q.ldc2 = v[15];
    q.n_store2 = (int)v[16];
    q.k_per_split = q.K;
    // TMA: A's base and row stride aligned to 16 bytes, the stride at least
    // its row; the image's blocks on 16-byte boundaries
    const bool ok = q.A && q.B && q.C && q.M >= 0 && q.N > 0 && q.K > 0 && q.lda % 4 == 0 &&
                    (v[0] & 15) == 0 && (v[2] & 15) == 0 && q.lda >= q.K && q.epi >= 0 &&
                    q.epi <= 5 && (q.epi < kEpiMask || q.aux) && (q.n_store2 == 0 || q.C2);
    if (!ok) return 1;
    if (q.M > 0 && encode_map(&q.amap, q.A, q.K, q.M, q.lda, kSgM)) return 1;
    P->q[i] = q;
    P->tile0[i + 1] = P->tile0[i] + ((q.M + kSgM - 1) / kSgM) * ((q.N + bn - 1) / bn);
  }
  return 0;
}

int grid_of_images(long long pairs) {
  const long long b = (pairs + 255) / 256;
  return (int)(b < 2048 ? (b > 0 ? b : 1) : 2048);
}

}  // namespace

// meta packed by fused_mlp._render_meta, img the ring image of its weights
// and sched K2's passes (fused_mlp._render_pack); ctas (persistent, each
// running every ctas-th 128-row tile) and smem, the dynamic shared memory:
// fused_mlp.render_launch_plan, which also gives the ring's stages (5 or 3)
extern "C" int render_fwd_launch(const float* pts, const float* nrm, const float* dirs,
                                 const float* feat, float* out, int n, const void* img,
                                 const float* B, const long long* meta, const long long* sched,
                                 int ctas, int smem, int stages, void* stream) {
  Plan p;
  if (read_plan(meta, &p) || render_plan(&p, sched) || smem <= 0 || smem % 16)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, const float*, float*, int,
                 const bf16*, const float*, Plan) = nullptr;
  switch (stages) {
    case 5: kernel = render_fwd_kernel<5>; break;
    case 3: kernel = render_fwd_kernel<3>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  int err = prepare(kernel, smem);
  if (err) return err;
  if (n == 0) return 0;
  if (ctas < 1 || ctas > (n + 127) / 128) return (int)cudaErrorInvalidValue;
  kernel<<<ctas, kK2Threads, smem, (cudaStream_t)stream>>>(
      pts, nrm, dirs, feat, out, n, reinterpret_cast<const bf16*>(img), B, p);
  return (int)cudaGetLastError();
}

// acts [n_pad, sum Kp] bf16, dels [n_pad, sum Np] bf16, dbpart
// [n_tiles, sum Np] f32: scratch from the caller, read by dw_finish_launch.
extern "C" int render_bwd_launch(const float* pts, const float* nrm,
                                 const float* dirs, const float* feat,
                                 const float* g, float* d_pts, float* d_nrm,
                                 float* d_dirs, float* d_feat, int n,
                                 const void* W, const float* B,
                                 const long long* meta, void* acts, void* dels,
                                 float* dbpart, void* stream) {
  Plan p;
  if (read_plan(meta, &p) || n <= 0 || render_bwd_schedule(&p)) return (int)cudaErrorInvalidValue;
  p.e_a = p.freqs_a > 0 ? 3 * (1 + 2 * p.freqs_a) : 3;
  const size_t smem = sizeof(bf16) * ((size_t)K3Ring::kStages * kSlab + (size_t)kRows * p.lda) +
                      sizeof(uint32_t) * (size_t)(p.n_layers - 1) * 2 * kThreads +
                      sizeof(float) * ((size_t)4 * kMaxOut + (size_t)kRows * p.e_a);
  int err = prepare(render_bwd_kernel, smem);
  if (err) return err;
  render_bwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem, (cudaStream_t)stream>>>(
      pts, nrm, dirs, feat, g, d_pts, d_nrm, d_dirs, d_feat, n,
      reinterpret_cast<const bf16*>(W), B, p,
      reinterpret_cast<bf16*>(acts), reinterpret_cast<bf16*>(dels), dbpart);
  return (int)cudaGetLastError();
}

// meta packed by fused_mlp._nerf_meta, W its packed weights, img their ring
// image and sched the passes (fused_mlp._nerf_ring); smem: the dynamic shared
// memory of fused_mlp.nerf_launch_plan
extern "C" int nerf_fwd_launch(const float* pts, const float* views,
                               float* alpha, float* rgb, float* dpt, int n,
                               const void* W, const void* img, const float* B,
                               const long long* meta, const long long* sched, int smem,
                               void* stream) {
  Plan p;
  if (read_plan(meta, &p) || nerf_plan(&p, sched) || smem <= 0 || smem % 16)
    return (int)cudaErrorInvalidValue;
  int err = prepare(nerf_fwd_kernel, smem);
  if (err) return err;
  if (n == 0) return 0;
  nerf_fwd_kernel<<<(n + 127) / 128, kThreads, smem, (cudaStream_t)stream>>>(
      pts, views, alpha, rgb, dpt, n, reinterpret_cast<const bf16*>(W),
      reinterpret_cast<const bf16*>(img), B, p);
  return (int)cudaGetLastError();
}

// scratch as render_bwd_launch's (64-row tiles)
extern "C" int nerf_bwd_launch(const float* pts, const float* views,
                               const float* g_alpha, const float* g_rgb,
                               const float* g_dpt, float* d_pts, float* d_views,
                               int n, const void* img, const float* B,
                               const long long* meta, const long long* sched, int smem,
                               void* acts, void* dels, float* dbpart, void* stream) {
  Plan p;
  if (read_plan(meta, &p) || n <= 0 || nerf_plan(&p, sched) || smem <= 0 || smem % 16)
    return (int)cudaErrorInvalidValue;
  int err = prepare(nerf_bwd_kernel, smem);
  if (err) return err;
  nerf_bwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem, (cudaStream_t)stream>>>(
      pts, views, g_alpha, g_rgb, g_dpt, d_pts, d_views, n,
      reinterpret_cast<const bf16*>(img), B, p, reinterpret_cast<bf16*>(acts),
      reinterpret_cast<bf16*>(dels), dbpart);
  return (int)cudaGetLastError();
}

// The dW contraction and the reductions after a backward tile kernel (K3 or
// K5, same meta): part [splits, sum Kp*Np] f32 scratch; dW [sum Kp*Np], dB
// [sum Np] packed like W and B. rows_per_split: a multiple of 64 with
// splits * rows_per_split >= the padded rows.
extern "C" int dw_finish_launch(const long long* meta, int n, const void* acts,
                                const void* dels, const float* dbpart, float* part,
                                int splits, int rows_per_split, float* dW, float* dB,
                                void* stream) {
  Plan p;
  if (read_plan(meta, &p) || n <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + kRows - 1) / kRows;
  if (rows_per_split % kDwRows || (long long)splits * rows_per_split < (long long)n_tiles * kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DwPlan q{};
  q.n_layers = p.n_layers;
  q.tile0[0] = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const LayerDesc& d = p.L[l];
    q.Kp[l] = d.Kp;
    q.Np[l] = d.Np;
    q.aoff[l] = d.aoff;
    q.doff[l] = d.doff;
    q.woff[l] = d.woff;
    q.tile0[l + 1] = q.tile0[l] + ((d.Kp + kDwTile - 1) / kDwTile) * ((d.Np + kDwTile - 1) / kDwTile);
  }
  q.act_w = p.act_w;
  q.del_w = p.del_w;
  q.n_rows = n_tiles * kRows;
  q.rows_per_split = rows_per_split;
  q.total_w = p.total_w;
  const size_t smem = sizeof(bf16) * (size_t)kDwStages * 2 * kDwSlab;
  int err = prepare(dw_kernel, smem);
  if (err) return err;
  dw_kernel<<<dim3(q.tile0[p.n_layers], splits), kDwThreads, smem, st>>>(
      reinterpret_cast<const bf16*>(acts), reinterpret_cast<const bf16*>(dels), part, q);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long w_blocks = (p.total_w + 255) / 256;
  reduce_dw_kernel<<<(int)(w_blocks < 4096 ? w_blocks : 4096), 256, 0, st>>>(
      part, splits, p.total_w, dW);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_db_kernel<<<(p.total_b + 7) / 8, 256, 0, st>>>(dbpart, n_tiles, p.total_b, dB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the split-operand f32 mode (fused_mlp._SplitOps lists the launches)
// ---------------------------------------------------------------------------

// The dW contraction: probs, n_probs records of 21 int64 (fused_mlp._SplitOps.dw):
// A, lda, B, ldb, C, ldc, M, N, K, bias, epi, aux, ldaux, aux_n, n_store, C2,
// ldc2, n_store2, c_split, k_per_split, Cb (no bias, epilogue or C2); A
// stored [K, M], B [K, N], C = A^T B in `splits` row splits; ctas: the
// persistent grid's most CTAs (one an SM)
extern "C" int split_mm_launch(const long long* probs, int n_probs, int splits, int ctas,
                               void* stream) {
  SplitProbs P;
  if (splits < 1 || ctas < 1 || read_split_probs(probs, n_probs, splits, &P))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(SplitProbs) = split_gemm_kernel;
  const size_t smem = kSgSmem;
  int err = prepare(kernel, smem);
  if (err) return err;
  // setmaxnreg moves registers between the CTA's warpgroups: the kernel must
  // start with what they are given in all, or setmaxnreg.inc would wait
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  if (attr.numRegs * kSgThreads < kSgProducerRegs * 128 + kSgConsumerRegs * 256)
    return (int)cudaErrorInvalidConfiguration;
  const long long total = (long long)P.tile0[P.n] * splits;
  if (total == 0) return 0;
  kernel<<<(int)(total < ctas ? total : ctas), kSgThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// the kernel's shared memory and register check (as split_mm_launch's), once
// a device for each variant: the weight path launches a few dozen times a step
template <int BN>
int wmm_prepare() {
  static int ready = -1;  // the device it was prepared on
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || ready == dev) return err;
  void (*kernel)(SplitProbs) = split_gemm_kernel<BN>;
  err = prepare(kernel, WpShape<BN>::kSmem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  if (attr.numRegs * kWpThreads < kWpProducerRegs * 128 + kWpConsumerRegs * 256)
    return (int)cudaErrorInvalidConfiguration;
  ready = dev;
  return 0;
}

template <int BN>
int wmm_launch(const SplitProbs& P, int ctas, cudaStream_t stream) {
  void (*kernel)(SplitProbs) = split_gemm_kernel<BN>;
  const int err = wmm_prepare<BN>();
  if (err) return err;
  const int total = P.tile0[P.n];
  if (total == 0) return 0;
  kernel<<<total < ctas ? total : ctas, kWpThreads, WpShape<BN>::kSmem, stream>>>(P);
  return (int)cudaGetLastError();
}

// The weight products: probs, n_probs records of 17 int64
// (fused_mlp._SplitOps.mm): A, lda, image, C, ldc, M, N, K, bias, epi, aux,
// ldaux, aux_n, n_store, C2, ldc2, n_store2; A [M, K] row-major, the image of
// B [K, N] in tiles of bn columns (split_image_launch)
extern "C" int split_wmm_launch(const long long* probs, int n_probs, int bn, int ctas,
                                void* stream) {
  SplitProbs P;
  if (ctas < 1 || read_weight_probs(probs, n_probs, bn, &P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 16: return wmm_launch<16>(P, ctas, st);
    case 32: return wmm_launch<32>(P, ctas, st);
    case 64: return wmm_launch<64>(P, ctas, st);
    case 96: return wmm_launch<96>(P, ctas, st);
    case 128: return wmm_launch<128>(P, ctas, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The weight images of a call: recs, n records of 7 int64
// (fused_mlp._SplitOps.images): W, ldw, K, N, trans, bn, dst; dst holds
// image_words(K, N, bn) floats
extern "C" int split_image_launch(const long long* recs, int n, void* stream) {
  if (n < 1 || n > kWpMaxImages) return (int)cudaErrorInvalidValue;
  SplitImages I{};
  I.n = n;
  I.begin[0] = 0;
  for (int i = 0; i < n; ++i) {
    const long long* v = recs + 7 * i;
    SplitImage& im = I.im[i];
    im.W = reinterpret_cast<const float*>(v[0]);
    im.ldw = v[1];
    im.K = (int)v[2];
    im.N = (int)v[3];
    im.trans = (int)v[4];
    im.bn = (int)v[5];
    im.dst = reinterpret_cast<float*>(v[6]);
    const bool ok = im.W && im.dst && im.K > 0 && im.N > 0 && (im.trans == 0 || im.trans == 1) &&
                    im.ldw >= (im.trans ? im.K : im.N) &&
                    (im.bn == 16 || im.bn == 32 || im.bn == 64 || im.bn == 96 || im.bn == 128);
    if (!ok) return (int)cudaErrorInvalidValue;
    I.begin[i + 1] = I.begin[i] + image_words(im.K, im.N, im.bn) / 2;
  }
  split_gemm_kernel<<<grid_of_images(I.begin[n]), 256, 0, (cudaStream_t)stream>>>(I);
  return (int)cudaGetLastError();
}

static int grid_of(long long total) {
  const long long b = (total + 255) / 256;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

// dst[:, :width] (row stride ldd) <- the embedding of src [n, d] (row stride
// lds, `freqs` bands; 0 copies), zero past the embedding's width
extern "C" int split_embed_launch(const float* src, long long lds, int d, int freqs, int n,
                                  float* dst, long long ldd, int width, void* stream) {
  const int e = freqs > 0 ? d * (1 + 2 * freqs) : d;
  if (n < 0 || d < 1 || freqs < 0 || width < e || ldd < width || lds < d)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  split_embed_kernel<<<grid_of((long long)n * width), 256, 0, (cudaStream_t)stream>>>(
      src, lds, d, freqs, n, dst, ldd, width);
  return (int)cudaGetLastError();
}

// out [n, d] <- the embedding's VJP at x [n, d] of the sum of n_src
// cotangents, srcs = (pointer, row stride) per source
extern "C" int split_embed_vjp_launch(const long long* srcs, int n_src, const float* x, int d,
                                      int freqs, int n, float* out, void* stream) {
  if (n_src < 1 || n_src > 4 || n < 0 || d < 1 || freqs < 0) return (int)cudaErrorInvalidValue;
  SplitVjpSrc S{};
  S.n_src = n_src;
  for (int k = 0; k < n_src; ++k) {
    S.src[k] = reinterpret_cast<const float*>(srcs[2 * k]);
    S.ld[k] = srcs[2 * k + 1];
  }
  if (n == 0) return 0;
  split_embed_vjp_kernel<<<grid_of((long long)n * d), 256, 0, (cudaStream_t)stream>>>(
      S, x, d, freqs, n, out);
  return (int)cudaGetLastError();
}

// out [total] <- part [splits, total] summed over splits in split order
extern "C" int split_reduce_launch(const float* part, int splits, long long total, float* out,
                                   void* stream) {
  if (splits < 1 || total < 1) return (int)cudaErrorInvalidValue;
  reduce_dw_kernel<<<grid_of(total), 256, 0, (cudaStream_t)stream>>>(part, splits, total, out);
  return (int)cudaGetLastError();
}
