// The fused-MLP kernels for sm_90a: K2 (IDR colour head forward), K3 (its
// backward), K4 (background NeRF forward) and K5 (its backward).
//
// Replace vdnerf_tpu/ops/pallas/fused_mlp.py::render_net_fused (forward,
// _render_kernel_fwd; backward, _render_kernel_bwd) and ::nerf_fused
// (forward, _nerf_kernel_fwd; backward, _nerf_kernel_bwd).
//
// Numerics follow the Pallas kernels' _mm/_mm_dx/_mm_dw: every matmul
// operand is rounded to bf16 and products accumulate in f32; bias,
// activations, the heads' outputs, deltas before rounding, db and the input
// cotangents are f32. Because every consumer of an activation is a matmul,
// the tile's activations are kept in shared memory already rounded to bf16,
// which is exact with respect to that policy; the backward's relu masks read
// those stored bf16 activations, as the Pallas backward does.
//
// Bound: operations (a row is ~0.5-1 MFLOP of bf16 matmul forward, ~3x that
// backward, against ~1 KB of I/O). Forward design, simple first: one CTA of
// 8 warps per 64-row tile; the activation tile (bf16) and one f32 staging
// tile for the accumulators live in shared memory; each warp owns a set of
// 16-column output fragments and runs nvcuda::wmma 16x16x16 bf16 products
// over the 4 row fragments, reading the (zero-padded, [in, out] row-major,
// bf16) weights straight from global memory, where they stay in L2. The
// epilogue adds the bias, applies the activation and writes the next layer's
// bf16 input back into the tile.
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
//     and dx = delta @ W^T, applies the relu masks, unstitches the concats
//     and writes the input cotangents through the embedding VJP. K3's tile
//     kernel (render_bwd_kernel, redesigned) runs wgmma on operands staged in
//     shared memory (its note below); K5's (nerf_bwd_kernel) keeps the simple
//     wmma-from-L2 design of the forwards and reads its relu masks back from
//     `acts`;
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;

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
  int lda, lds;     // shared-memory strides (elements)
  int e_a, e_b;     // embedding widths
  int act_w, del_w; // backward: widths of `acts` (sum Kp) and `dels` (sum Np)
  int total_b;      // sum Np: packed bias length
  long long total_w;  // sum Kp * Np: packed weight length
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

// S[0:64, 0:Np] = A[0:64, 0:Kp] @ W[0:Kp, 0:Np]; bf16 in, f32 out.
__device__ void mm_tile(const bf16* A, int lda, int Kp,
                        const bf16* __restrict__ W, int Np, float* S,
                        int lds) {
  const int warp = threadIdx.x / 32;
  const int nfrags = Np / 16;
  for (int nf = warp; nf < nfrags; nf += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRows / 16];
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int k = 0; k < Kp; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + (size_t)k * Np + nf * 16, Np);
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + m * 16 * lda + k, lda);
        wmma::mma_sync(acc[m], a, b, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m)
      wmma::store_matrix_sync(S + m * 16 * lds + nf * 16, acc[m], lds,
                              wmma::mem_row_major);
  }
}

// S[0:64, 0:Kp] = D[0:64, 0:Np] @ W[0:Kp, 0:Np]^T (the dx product); W^T is
// read as a column-major B operand, no transpose is materialised.
__device__ void mm_tile_t(const bf16* D, int ldd, int Np,
                          const bf16* __restrict__ W, int Kp, float* S,
                          int lds) {
  const int warp = threadIdx.x / 32;
  const int nfrags = Kp / 16;
  for (int nf = warp; nf < nfrags; nf += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRows / 16];
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int k = 0; k < Np; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, W + (size_t)nf * 16 * Np + k, Np);
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, D + m * 16 * ldd + k, ldd);
        wmma::mma_sync(acc[m], a, b, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m)
      wmma::store_matrix_sync(S + m * 16 * lds + nf * 16, acc[m], lds,
                              wmma::mem_row_major);
  }
}

// A[:, col0:col0+N] = bf16(act(S[:, s0:s0+N] + bias)); act: 1 relu, 0 none
__device__ void epilogue(const float* S, int lds, int s0, int N,
                         const float* __restrict__ bias, int relu,
                         bf16* A, int lda, int col0) {
  for (int idx = threadIdx.x; idx < kRows * N; idx += kThreads) {
    const int r = idx / N;
    const int c = idx % N;
    float v = S[r * lds + s0 + c] + bias[c];
    if (relu) v = fmaxf(v, 0.0f);
    A[r * lda + col0 + c] = __float2bfloat16(v);
  }
}

__device__ void zero_cols(bf16* A, int lda, int c_begin, int c_end) {
  const int w = c_end - c_begin;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < kRows * w; idx += kThreads)
    A[(idx / w) * lda + c_begin + idx % w] = __float2bfloat16(0.0f);
}

// backward: the tile's bf16 layer input A[:, 0:width] -> acts[row0 + r, col]
__device__ void store_act(const bf16* A, int lda, int width, bf16* acts,
                          int act_w, int row0) {
  const int half = width / 2;
  for (int idx = threadIdx.x; idx < kRows * half; idx += kThreads) {
    const int r = idx / half;
    const int c = 2 * (idx % half);
    *reinterpret_cast<__nv_bfloat162*>(acts + (size_t)(row0 + r) * act_w + c) =
        *reinterpret_cast<const __nv_bfloat162*>(A + r * lda + c);
  }
}

// backward: S[:, s0:s0+width] *= (acts[row0 + r, a0 + c] > 0), the relu mask
// of the layer whose output is that stored activation
__device__ void relu_mask(float* S, int lds, int s0, int width,
                          const bf16* acts, int act_w, int a0, int row0) {
  for (int idx = threadIdx.x; idx < kRows * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx % width;
    const float a = __bfloat162float(acts[(size_t)(row0 + r) * act_w + a0 + c]);
    if (!(a > 0.0f)) S[r * lds + s0 + c] = 0.0f;
  }
}

// The f32 delta of one layer: S[:, s0 + c] for c < N, zero beyond. With
// `galpha` set (K5's [alpha | feature] layer), column 0 is the alpha
// cotangent and column c >= 1 is S[:, s0 + c - 1].
struct Delta {
  const float* S;
  int lds, s0, N;
  const float* galpha;
  int row0, n;
  __device__ __forceinline__ float at(int r, int c) const {
    if (c >= N) return 0.0f;
    if (galpha == nullptr) return S[r * lds + s0 + c];
    if (c > 0) return S[r * lds + s0 + c - 1];
    return row0 + r < n ? galpha[row0 + r] : 0.0f;
  }
};

// backward, one layer: db partial (f32 column sums over the tile, rows in
// order), the bf16 delta into D (shared, the dx product's operand) and into
// the global `dels` (the dW contraction's right operand)
__device__ void emit_delta(const Delta& d, const LayerDesc& L, const Plan& p,
                           bf16* D, int ldd, float* dbpart, bf16* dels) {
  const int row0 = d.row0;
  for (int c = threadIdx.x; c < L.Np; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += d.at(r, c);
    dbpart[(size_t)blockIdx.x * p.total_b + L.boff + c] = s;
  }
  for (int idx = threadIdx.x; idx < kRows * L.Np; idx += kThreads) {
    const int r = idx / L.Np;
    const int c = idx % L.Np;
    const bf16 v = __float2bfloat16(d.at(r, c));
    D[r * ldd + c] = v;
    dels[(size_t)(row0 + r) * p.del_w + L.doff + c] = v;
  }
}

// K2/K3 input tile: the mode's concat [pts | emb_view | normals | feat],
// element (r, c) stored at A[at(r, c)] (row-major for K2, the wgmma core
// layout for K3). The feature block, most of the row, is read with 16-byte
// loads, all of a thread's rows unrolled so that their loads are in flight
// together; a warp per row covers the few other columns.
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

// K2/K3 forward over the tile; leaves the last layer's pre-activation
// (without bias) in S. With `acts` set, stores every layer's input there.
__device__ void render_forward(const Plan& p, const bf16* __restrict__ W,
                               const float* __restrict__ B, float* S, bf16* A,
                               bf16* acts, int row0) {
  for (int l = 0; l < p.n_layers; ++l) {
    const LayerDesc& d = p.L[l];
    if (acts) store_act(A, p.lda, d.Kp, acts + d.aoff, p.act_w, row0);
    mm_tile(A, p.lda, d.Kp, W + d.woff, d.Np, S, p.lds);
    __syncthreads();
    if (l + 1 < p.n_layers) {
      epilogue(S, p.lds, 0, d.N, B + d.boff, 1, A, p.lda, 0);
      zero_cols(A, p.lda, d.N, p.L[l + 1].Kp);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
render_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ dirs, const float* __restrict__ feat,
                  float* __restrict__ out, int n,
                  const bf16* __restrict__ W,
                  const float* __restrict__ B, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);       // [64, lds]
  bf16* A = reinterpret_cast<bf16*>(S + kRows * p.lds);  // [64, lda]

  const int row0 = blockIdx.x * kRows;
  render_input(p, pts, nrm, dirs, feat, n, row0, A,
               [&](int r, int c) { return r * p.lda + c; });
  __syncthreads();
  render_forward(p, W, B, S, A, nullptr, row0);
  const LayerDesc& d = p.L[p.n_layers - 1];
  for (int idx = threadIdx.x; idx < kRows * d.N; idx += kThreads) {
    const int r = idx / d.N;
    const int c = idx % d.N;
    const int gr = row0 + r;
    if (gr < n) {
      const float v = S[r * p.lds + c] + B[d.boff + c];
      out[(size_t)gr * d.N + c] =
          p.squeeze_out ? 1.0f / (1.0f + expf(-v)) : fmaxf(v, 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// K3 tile kernel: wgmma products on operands staged in shared memory
// ---------------------------------------------------------------------------
//
// Each product of the tile is [64, Kin] x [Kin, Wout] -> [64, Wout] f32:
// the forward layer l (A = the layer's bf16 input, B = W_l), then dx of layer
// l (A = the bf16 delta, B = W_l^T). A lives in shared memory (`Atile`), in
// wgmma's no-swizzle K-major layout: 8x8 core matrices of 128 contiguous
// bytes, the two core matrices of a k16 step 128 bytes apart (LBO), 8-row
// groups lda*16 bytes apart (SBO). B is the packed W_l ([Kp, Np], row-major)
// for both: the forward reads it MN-major (wgmma's transpose-B bit; a core
// matrix row is 8 output columns of one reduction row), dx K-major (a core
// matrix row is 8 reduction columns of one output row). Either way the core
// matrices of a slab sit at the same offsets, K-adjacent ones 128 bytes apart
// (LBO) and N-adjacent ones kKS*16 bytes apart (SBO), so one descriptor
// serves both. B streams through a
// 3-stage cp.async ring of kKS-row reduction slabs with 16-byte copies
// straight into the same core-matrix layout; the ring runs through all 2L
// products of the tile, so each product's first slabs load while the previous
// product finishes. Output columns are cut into 64-wide chunks, one
// m64n64k16 wgmma each; chunk c belongs to warpgroup c % 2 and stays in its
// registers until the epilogue. Two chunks per warpgroup (64 accumulator
// registers per thread, within the 128 that two CTAs per SM allow), so a
// product pass is at most 256 columns wide: layer 0's dx (the 304-wide
// input concat) runs as two passes. The wgmma issue between fence and wait
// is straight-line code per (chunks, k16 steps) variant, chosen by values the
// compiler sees as warpgroup-uniform; otherwise it serialises the wgmmas.
//
// A forward output column and a dx output column of the same width are owned
// by the same thread at the same register: the relu mask of every hidden
// layer is kept as one bit per accumulator register (maskw), with no reread of
// the stored activations. acts/dels go out with 16-byte stores from Atile;
// db column sums come from the registers (a fixed shuffle tree over the rows
// of a warp, then the four warps of the owning warpgroup in order).
//
// Not done here: wgmma's 128-byte-swizzled layouts with the weights fed by
// TMA into an mbarrier ring. This kernel keeps both operands in the
// no-swizzle core layout, whose 16-byte rows cp.async writes directly at
// their offsets; in that layout a TMA box covers only one 16-byte-wide
// column of core matrices, which is why the ring uses cp.async. A 128-byte
// swizzle (one box per slab, with cluster multicast halving the weights' L2
// traffic) needs Atile's epilogue writes and acts/dels stores rewritten for
// the swizzled addressing as well. Two CTAs
// share an SM (the launch bounds cap registers at 128; each CTA holds
// ~106 KB of shared memory), so one CTA's epilogues, stores and barriers
// overlap the other's products.

constexpr int kKS = 32;          // reduction rows per weight slab
constexpr int kRbStages = 3;
constexpr int kChunk = 64;       // output columns per wgmma
constexpr int kMaxChunks = 2;    // per warpgroup
constexpr int kMaxOut = 2 * kMaxChunks * kChunk;  // widest product pass: 256
constexpr int kSlab = kKS * kMaxOut;  // bf16 elements per ring stage
static_assert(kKS == 32, "rb_product issues one or two k16 steps per slab");

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
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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
  const bf16* B;  // mn: Kin rows of Wout contiguous bf16; else Wout rows of Kin
  int Kin, Wout;
  bool mn;
};

// product pass q of the tile: forward layers 0..L-1 (W_l read MN-major), dx
// of layers L-1..1 (all at most kMaxOut wide, checked by the launcher), then
// dx of layer 0 in passes of kMaxOut output columns (its width Kp_0 is the
// input concat's); dx reads W_l K-major
__device__ __forceinline__ RbProd rb_prod(const Plan& p, const bf16* W, int q) {
  const int L = p.n_layers;
  if (q < L) return {W + p.L[q].woff, p.L[q].Kp, p.L[q].Np, true};
  if (q < 2 * L - 1) {
    const LayerDesc& d = p.L[2 * L - 1 - q];
    return {W + d.woff, d.Np, d.Kp, false};
  }
  const int n0 = (q - (2 * L - 1)) * kMaxOut;
  const LayerDesc& d = p.L[0];
  return {W + d.woff + (size_t)n0 * d.Np, d.Np, min(kMaxOut, d.Kp - n0), false};
}

__device__ __forceinline__ int rb_passes0(const Plan& p) {
  return (p.L[0].Kp + kMaxOut - 1) / kMaxOut;
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
                       ok ? pr.B + (size_t)k * pr.Wout + n : pr.B, ok ? 16 : 0);
    } else {
      const int n = idx / kc_n;
      const int kc = idx % kc_n;
      const int k = k0 + kc * 8;
      const bool ok = n < pr.Wout && k < pr.Kin;
      cp_async16_zfill(dst + (n >> 3) * (kc_n * 64) + kc * 64 + (n & 7) * 8,
                       ok ? pr.B + (size_t)n * pr.Kin + k : pr.B, ok ? 16 : 0);
    }
  }
}

// The ring's producer side: the next slab to load, as (product pass q, slab
// i of it), advanced one slab per load
struct RbCursor {
  int q, i, n_prod;
  __device__ void load_next(const Plan& p, const bf16* W, bf16* dst) {
    if (q >= n_prod) return;
    const RbProd pr = rb_prod(p, W, q);
    rb_load(pr, i * kKS, dst);
    if (++i == rb_slabs(pr)) {
      ++q;
      i = 0;
    }
  }
};

// NK k16 steps of a slab into the calling warpgroup's NC chunks: straight-line
// code between the fence and the wait, so that the compiler keeps the
// wgmma instructions asynchronous
template <int NC, int NK, int TB>
__device__ __forceinline__ void rb_mma(float (&acc)[kMaxChunks][32], const bf16* Atile, int lda,
                                       int k0, const bf16* Bs, int wg) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t da = wg_desc(Atile + (((k0 + kk * 16) >> 3) << 6), 128, lda * 16);
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      const uint64_t db =
          wg_desc(Bs + (wg + 2 * ci) * 8 * (kKS / 8) * 64 + kk * 2 * 64, 128, kKS * 16);
      wgmma_64x64<TB>(acc[ci], da, db);
    }
  }
  wg_commit();
  wg_wait_all();
}

// the rb_mma variant for `mine` chunks of the calling warpgroup and a full
// (two k16 steps) or half slab
template <int TB>
__device__ __forceinline__ void rb_mma_pick(int mine, bool full, float (&acc)[kMaxChunks][32],
                                            const bf16* Atile, int lda, int k0, const bf16* Bs,
                                            int wg) {
  if (mine == 1) {
    if (full) rb_mma<1, 2, TB>(acc, Atile, lda, k0, Bs, wg);
    else rb_mma<1, 1, TB>(acc, Atile, lda, k0, Bs, wg);
  } else if (mine == 2) {
    if (full) rb_mma<2, 2, TB>(acc, Atile, lda, k0, Bs, wg);
    else rb_mma<2, 1, TB>(acc, Atile, lda, k0, Bs, wg);
  }
}

// one product pass of the tile into the calling warpgroup's chunks; `s` is
// the running slab index (its ring stage is s % kRbStages), `cur` loads the
// slab kRbStages - 1 ahead
__device__ __forceinline__ void rb_product(const Plan& p, const bf16* W, int q, int& s,
                                           RbCursor& cur, bf16* ring, const bf16* Atile, int lda,
                                           float (&acc)[kMaxChunks][32]) {
  const RbProd pr = rb_prod(p, W, q);
  const int ns = rb_slabs(pr);
  const int nch = (pr.Wout + kChunk - 1) / kChunk;
  // the warpgroup index through a shuffle, so the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int mine = (nch - wg + 1) / 2;  // chunks wg, wg + 2, ... below nch
#pragma unroll
  for (int ci = 0; ci < kMaxChunks; ++ci)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[ci][i] = 0.0f;
  for (int i = 0; i < ns; ++i, ++s) {
    cp_async_wait<kRbStages - 2>();
    fence_async_smem();
    __syncthreads();  // slab s landed; every warpgroup is done with slab s - 1
    cur.load_next(p, W, ring + ((s + kRbStages - 1) % kRbStages) * kSlab);
    cp_async_commit();
    const bf16* Bs = ring + (s % kRbStages) * kSlab;
    const int k0 = i * kKS;
    const bool full = pr.Kin - k0 >= kKS;
    if (pr.mn) rb_mma_pick<1>(mine, full, acc, Atile, lda, k0, Bs, wg);
    else rb_mma_pick<0>(mine, full, acc, Atile, lda, k0, Bs, wg);
  }
}

// Atile[:, 0:width] -> dst[row0 + r, 0:width] (row stride ld), 16-byte stores;
// a warp's lanes cover 8 rows x 4 column groups of 8
__device__ void store_tile(const bf16* Atile, int lda, int width, bf16* dst, int ld, int row0) {
  const int n_kg = width >> 3;
  for (int idx = threadIdx.x; idx < kRows * n_kg; idx += kThreads) {
    const int i8 = idx & 7;
    const int u = idx >> 3;
    const int kg = u % n_kg;
    const int m = (u / n_kg) * 8 + i8;
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + m) * ld + kg * 8) =
        *reinterpret_cast<const uint4*>(Atile + core_at(m, kg * 8, lda));
  }
}

// Loop over the accumulator registers of the calling thread that hold
// columns < width of a product's output: f(ci, i, row, col, value&)
template <typename F>
__device__ __forceinline__ void for_owned(float (&acc)[kMaxChunks][32], int width, F f) {
  const int wg = threadIdx.x >> 7;
  const int q4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ci = 0; ci < kMaxChunks; ++ci) {
    const int c0 = (wg + 2 * ci) * kChunk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j * 8 < width) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(ci, j * 4 + e, 16 * q4 + g + (e >> 1) * 8, c0 + j * 8 + 2 * t + (e & 1),
            acc[ci][j * 4 + e]);
      }
    }
  }
}

// backward, one layer's f32 delta in the registers: db partial column sums
// into `red`, the bf16 delta into Atile. The caller syncs, then calls
// emit_finish.
__device__ __forceinline__ void emit_regs(float (&acc)[kMaxChunks][32], int Np, bf16* Atile, int lda,
                          float* red) {
  const int wg = threadIdx.x >> 7;
  const int q4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ci = 0; ci < kMaxChunks; ++ci) {
    const int c0 = (wg + 2 * ci) * kChunk;
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

// after emit_regs and a barrier: db partial (the four warps in order) and the
// bf16 delta out to `dels`
__device__ void emit_finish(const Plan& p, const LayerDesc& d, const float* red,
                            const bf16* Atile, float* dbpart, bf16* dels, int row0) {
  for (int c = threadIdx.x; c < d.Np; c += kThreads)
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
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);               // [stages][kSlab]
  bf16* Atile = ring + kRbStages * kSlab;                        // [64, lda] core
  uint32_t* maskw = reinterpret_cast<uint32_t*>(Atile + kRows * p.lda);
  float* red = reinterpret_cast<float*>(maskw + (p.n_layers - 1) * kMaxChunks * kThreads);
  float* Sv = red + 4 * kMaxOut;                                 // [64, e_a]

  const int L = p.n_layers;
  const int row0 = blockIdx.x * kRows;
  const int n_prod = 2 * L - 1 + rb_passes0(p);
  RbCursor cur{0, 0, n_prod};
  for (int i = 0; i < kRbStages - 1; ++i) {
    cur.load_next(p, W, ring + i * kSlab);
    cp_async_commit();
  }
  render_input(p, pts, nrm, dirs, feat, n, row0, Atile,
               [&](int r, int c) { return core_at(r, c, p.lda); });
  fence_async_smem();
  __syncthreads();

  float acc[kMaxChunks][32];
  int s = 0;
  for (int l = 0; l < L; ++l) {
    const LayerDesc& d = p.L[l];
    store_tile(Atile, p.lda, d.Kp, acts + d.aoff, p.act_w, row0);
    rb_product(p, W, l, s, cur, ring, Atile, p.lda, acc);
    __syncthreads();  // every warpgroup is done reading Atile
    if (l + 1 == L) break;
    const float* bias = B + d.boff;
    uint32_t bits[kMaxChunks] = {0u, 0u};
    for_owned(acc, d.Np, [&](int ci, int i, int r, int c, float& v) {
      const bf16 h = __float2bfloat16(fmaxf(v + bias[c], 0.0f));
      Atile[core_at(r, c, p.lda)] = h;
      if (__bfloat162float(h) > 0.0f) bits[ci] |= 1u << i;
    });
#pragma unroll
    for (int ci = 0; ci < kMaxChunks; ++ci)
      maskw[(l * kMaxChunks + ci) * kThreads + threadIdx.x] = bits[ci];
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
    emit_finish(p, o, red, Atile, dbpart, dels, row0);
  }

  for (int l = L - 1; l >= 1; --l) {
    const LayerDesc& d = p.L[l];
    rb_product(p, W, 2 * L - 1 - l, s, cur, ring, Atile, p.lda, acc);
    __syncthreads();  // every warpgroup is done reading the delta in Atile
    for_owned(acc, d.Kp, [&](int ci, int i, int, int, float& v) {
      if (!((maskw[((l - 1) * kMaxChunks + ci) * kThreads + threadIdx.x] >> i) & 1u)) v = 0.0f;
    });
    emit_regs(acc, p.L[l - 1].Np, Atile, p.lda, red);
    fence_async_smem();
    __syncthreads();
    emit_finish(p, p.L[l - 1], red, Atile, dbpart, dels, row0);
  }

  // dx of layer 0, the cotangent of the input concat, in passes of kMaxOut
  // columns; split it by mode
  const int use_view = p.mode != 1;
  const int use_nrm = p.mode != 2;
  const int c_nrm = 3 + (use_view ? p.e_a : 0);
  const int c_feat = c_nrm + (use_nrm ? 3 : 0);
  const int K0 = p.L[0].K;
  for (int q = 2 * L - 1; q < n_prod; ++q) {
    const int n0 = (q - (2 * L - 1)) * kMaxOut;
    rb_product(p, W, q, s, cur, ring, Atile, p.lda, acc);
    for_owned(acc, min(kMaxOut, p.L[0].Kp - n0), [&](int, int, int r, int c, float& v) {
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

// K4/K5 input tiles: the point embedding (into A and Ea) and the view
// embedding (into Eb)
__device__ void nerf_input(const Plan& p, const float* __restrict__ pts,
                           const float* __restrict__ views, int n, int row0,
                           bf16* A, bf16* Ea, bf16* Eb) {
  const int lea = pad16(p.e_a);
  const int leb = pad16(p.e_b);
  for (int idx = threadIdx.x; idx < kRows * lea; idx += kThreads) {
    const int r = idx / lea;
    const int c = idx % lea;
    const int gr = row0 + r;
    float v = 0.0f;
    if (gr < n && c < p.e_a) v = embed_at(pts + (size_t)gr * p.d_a, p.d_a, c);
    const bf16 h = __float2bfloat16(v);
    Ea[idx] = h;
    A[r * p.lda + c] = h;
  }
  for (int idx = threadIdx.x; idx < kRows * leb; idx += kThreads) {
    const int r = idx / leb;
    const int c = idx % leb;
    const int gr = row0 + r;
    float v = 0.0f;
    if (gr < n && c < p.e_b) v = embed_at(views + gr * 3, 3, c);
    Eb[idx] = __float2bfloat16(v);
  }
  zero_cols(A, p.lda, lea, p.L[0].Kp);
}

// K4/K5 forward through the trunk and the [alpha | feature] product; leaves
// that product (without bias) in S and h in A. With `acts` set, stores every
// trunk layer's input and h.
__device__ void nerf_trunk(const Plan& p, const bf16* __restrict__ W,
                           const float* __restrict__ B, float* S, bf16* A,
                           const bf16* Ea, bf16* acts, int row0) {
  const int lea = pad16(p.e_a);
  // trunk: relu linears, [emb_pts, h] after every skip layer
  for (int i = 0; i < p.trunk; ++i) {
    const LayerDesc& d = p.L[i];
    if (acts) store_act(A, p.lda, d.Kp, acts + d.aoff, p.act_w, row0);
    mm_tile(A, p.lda, d.Kp, W + d.woff, d.Np, S, p.lds);
    __syncthreads();
    const int skip = (p.skips >> i) & 1u;
    const int col0 = skip ? p.e_a : 0;
    epilogue(S, p.lds, 0, d.N, B + d.boff, 1, A, p.lda, col0);
    if (skip) {
      for (int idx = threadIdx.x; idx < kRows * p.e_a; idx += kThreads)
        A[(idx / p.e_a) * p.lda + idx % p.e_a] = Ea[(idx / p.e_a) * lea + idx % p.e_a];
    }
    zero_cols(A, p.lda, col0 + d.N, p.L[i + 1].Kp);
    __syncthreads();
  }
  const LayerDesc& af = p.L[p.trunk];
  if (acts) store_act(A, p.lda, af.Kp, acts + af.aoff, p.act_w, row0);
  mm_tile(A, p.lda, af.Kp, W + af.woff, af.Np, S, p.lds);
  __syncthreads();
}

// K4/K5: A = [feature, emb_view] from the [alpha | feature] product in S
__device__ void nerf_views_input(const Plan& p, const float* __restrict__ B,
                                 const float* S, bf16* A, const bf16* Eb) {
  const int leb = pad16(p.e_b);
  const LayerDesc& af = p.L[p.trunk];
  const int wfeat = af.N - 1;
  epilogue(S, p.lds, 1, wfeat, B + af.boff + 1, 0, A, p.lda, 0);
  for (int idx = threadIdx.x; idx < kRows * p.e_b; idx += kThreads)
    A[(idx / p.e_b) * p.lda + wfeat + idx % p.e_b] = Eb[(idx / p.e_b) * leb + idx % p.e_b];
  zero_cols(A, p.lda, wfeat + p.e_b, p.L[p.trunk + 1].Kp);
}

// Layers: trunk 0..D-1, then [alpha | feature], views0, [rgb | dpt].
__global__ void __launch_bounds__(kThreads)
nerf_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                float* __restrict__ alpha, float* __restrict__ rgb,
                float* __restrict__ dpt, int n,
                const bf16* __restrict__ W,
                const float* __restrict__ B, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);
  bf16* A = reinterpret_cast<bf16*>(S + kRows * p.lds);
  bf16* Ea = A + kRows * p.lda;              // [64, pad16(e_a)]
  bf16* Eb = Ea + kRows * pad16(p.e_a);      // [64, pad16(e_b)]

  const int row0 = blockIdx.x * kRows;
  nerf_input(p, pts, views, n, row0, A, Ea, Eb);
  __syncthreads();
  nerf_trunk(p, W, B, S, A, Ea, nullptr, row0);

  // heads: alpha straight from the accumulators
  const LayerDesc& af = p.L[p.trunk];
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int gr = row0 + r;
    if (gr < n) alpha[gr] = S[r * p.lds] + B[af.boff];
  }
  nerf_views_input(p, B, S, A, Eb);
  __syncthreads();

  const LayerDesc& v0 = p.L[p.trunk + 1];
  mm_tile(A, p.lda, v0.Kp, W + v0.woff, v0.Np, S, p.lds);
  __syncthreads();
  const LayerDesc& rd = p.L[p.trunk + 2];
  epilogue(S, p.lds, 0, v0.N, B + v0.boff, 1, A, p.lda, 0);
  zero_cols(A, p.lda, v0.N, rd.Kp);
  __syncthreads();

  mm_tile(A, p.lda, rd.Kp, W + rd.woff, rd.Np, S, p.lds);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * rd.N; idx += kThreads) {
    const int r = idx / rd.N;
    const int c = idx % rd.N;
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float v = S[r * p.lds + c] + B[rd.boff + c];
    if (c < p.d_rgb)
      rgb[(size_t)gr * p.d_rgb + c] = v;
    else
      dpt[(size_t)gr * p.d_dpt + c - p.d_rgb] = v;
  }
}

// K5: recompute, then (g_alpha, g_rgb, g_dpt) -> d(pts), d(views) and the
// per-layer deltas (dW/db follow in dw_kernel and the reductions).
__global__ void __launch_bounds__(kThreads)
nerf_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                const float* __restrict__ g_alpha, const float* __restrict__ g_rgb,
                const float* __restrict__ g_dpt, float* __restrict__ d_pts,
                float* __restrict__ d_views, int n,
                const bf16* __restrict__ W, const float* __restrict__ B,
                Plan p, bf16* acts, bf16* dels, float* dbpart) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);
  bf16* A = reinterpret_cast<bf16*>(S + kRows * p.lds);
  bf16* Ea = A + kRows * p.lda;
  bf16* Eb = Ea + kRows * pad16(p.e_a);
  float* dE = reinterpret_cast<float*>(Eb + kRows * pad16(p.e_b));  // [64, e_a]

  const int row0 = blockIdx.x * kRows;
  const int T = p.trunk;
  nerf_input(p, pts, views, n, row0, A, Ea, Eb);
  __syncthreads();
  nerf_trunk(p, W, B, S, A, Ea, acts, row0);
  nerf_views_input(p, B, S, A, Eb);
  __syncthreads();
  const LayerDesc& af = p.L[T];
  const LayerDesc& v0 = p.L[T + 1];
  const LayerDesc& rd = p.L[T + 2];
  store_act(A, p.lda, v0.Kp, acts + v0.aoff, p.act_w, row0);
  mm_tile(A, p.lda, v0.Kp, W + v0.woff, v0.Np, S, p.lds);
  __syncthreads();
  epilogue(S, p.lds, 0, v0.N, B + v0.boff, 1, A, p.lda, 0);
  zero_cols(A, p.lda, v0.N, rd.Kp);
  __syncthreads();
  store_act(A, p.lda, rd.Kp, acts + rd.aoff, p.act_w, row0);
  for (int idx = threadIdx.x; idx < kRows * p.e_a; idx += kThreads)
    dE[idx] = 0.0f;

  // [rgb | dpt]: the delta is the cotangent itself
  for (int idx = threadIdx.x; idx < kRows * rd.Np; idx += kThreads) {
    const int r = idx / rd.Np;
    const int c = idx % rd.Np;
    const int gr = row0 + r;
    float v = 0.0f;
    if (gr < n) {
      if (c < p.d_rgb)
        v = g_rgb[(size_t)gr * p.d_rgb + c];
      else if (c < p.d_rgb + p.d_dpt)
        v = g_dpt[(size_t)gr * p.d_dpt + c - p.d_rgb];
    }
    S[r * p.lds + c] = v;
  }
  __syncthreads();
  emit_delta(Delta{S, p.lds, 0, rd.N, nullptr, row0, n}, rd, p, A, p.lda,
             dbpart, dels);
  __syncthreads();
  mm_tile_t(A, p.lda, rd.Np, W + rd.woff, rd.Kp, S, p.lds);
  __syncthreads();
  relu_mask(S, p.lds, 0, rd.Kp, acts, p.act_w, rd.aoff, row0);
  __syncthreads();

  // views0: d_h2 -> d[feature, emb_view]; the view part goes out now
  emit_delta(Delta{S, p.lds, 0, v0.N, nullptr, row0, n}, v0, p, A, p.lda,
             dbpart, dels);
  __syncthreads();
  mm_tile_t(A, p.lda, v0.Np, W + v0.woff, v0.Kp, S, p.lds);
  __syncthreads();
  const int wfeat = af.N - 1;
  for (int idx = threadIdx.x; idx < kRows * 3; idx += kThreads) {
    const int r = idx / 3;
    const int j = idx % 3;
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float* srow = S + r * p.lds + wfeat;
    d_views[gr * 3 + j] =
        embed_vjp([&](int c) { return srow[c]; }, views + gr * 3, 3, j, p.freqs_b);
  }

  // [alpha | feature]: the delta is [g_alpha | d_feature]
  emit_delta(Delta{S, p.lds, 0, af.N, g_alpha, row0, n}, af, p, A, p.lda,
             dbpart, dels);
  __syncthreads();
  mm_tile_t(A, p.lda, af.Np, W + af.woff, af.Kp, S, p.lds);
  __syncthreads();

  // trunk in reverse: S holds the cotangent of layer i+1's input; after a
  // skip layer that input is [emb, h_i], whose emb part accumulates in dE
  for (int i = T - 1; i >= 0; --i) {
    const LayerDesc& d = p.L[i];
    const int s0 = ((p.skips >> i) & 1u) ? p.e_a : 0;
    if (s0) {
      for (int idx = threadIdx.x; idx < kRows * p.e_a; idx += kThreads)
        dE[idx] += S[(idx / p.e_a) * p.lds + idx % p.e_a];
    }
    relu_mask(S, p.lds, s0, d.N, acts, p.act_w, p.L[i + 1].aoff + s0, row0);
    __syncthreads();
    emit_delta(Delta{S, p.lds, s0, d.N, nullptr, row0, n}, d, p, A, p.lda,
               dbpart, dels);
    __syncthreads();
    mm_tile_t(A, p.lda, d.Np, W + d.woff, d.Kp, S, p.lds);
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < kRows * p.d_a; idx += kThreads) {
    const int r = idx / p.d_a;
    const int j = idx % p.d_a;
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float* srow = S + r * p.lds;
    const float* erow = dE + r * p.e_a;
    d_pts[(size_t)gr * p.d_a + j] =
        embed_vjp([&](int c) { return erow[c] + srow[c]; },
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
  int lda = 0, lds = 0, aoff = 0, doff = 0;
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
    lds = lds > d.Np ? lds : d.Np;
  }
  p->lda = lda;
  p->lds = lds;
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

}  // namespace

extern "C" int render_fwd_launch(const float* pts, const float* nrm,
                                 const float* dirs, const float* feat,
                                 float* out, int n, const void* W,
                                 const float* B, const long long* meta,
                                 void* stream) {
  Plan p;
  if (read_plan(meta, &p)) return (int)cudaErrorInvalidValue;
  p.e_a = p.freqs_a > 0 ? 3 * (1 + 2 * p.freqs_a) : 3;
  const size_t smem = sizeof(float) * kRows * p.lds +
                      sizeof(bf16) * kRows * p.lda;
  int err = prepare(render_fwd_kernel, smem);
  if (err) return err;
  if (n == 0) return 0;
  render_fwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                      (cudaStream_t)stream>>>(
      pts, nrm, dirs, feat, out, n, reinterpret_cast<const bf16*>(W), B, p);
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
  if (read_plan(meta, &p) || n <= 0) return (int)cudaErrorInvalidValue;
  p.e_a = p.freqs_a > 0 ? 3 * (1 + 2 * p.freqs_a) : 3;
  // every product pass but layer 0's dx fits one pass of the warpgroups
  for (int l = 0; l < p.n_layers; ++l)
    if (p.L[l].Np > kMaxOut || (l > 0 && p.L[l].Kp > kMaxOut)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(bf16) * ((size_t)kRbStages * kSlab + (size_t)kRows * p.lda) +
                      sizeof(uint32_t) * (size_t)(p.n_layers - 1) * kMaxChunks * kThreads +
                      sizeof(float) * ((size_t)4 * kMaxOut + (size_t)kRows * p.e_a);
  int err = prepare(render_bwd_kernel, smem);
  if (err) return err;
  render_bwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem, (cudaStream_t)stream>>>(
      pts, nrm, dirs, feat, g, d_pts, d_nrm, d_dirs, d_feat, n,
      reinterpret_cast<const bf16*>(W), B, p,
      reinterpret_cast<bf16*>(acts), reinterpret_cast<bf16*>(dels), dbpart);
  return (int)cudaGetLastError();
}

extern "C" int nerf_fwd_launch(const float* pts, const float* views,
                               float* alpha, float* rgb, float* dpt, int n,
                               const void* W, const float* B,
                               const long long* meta, void* stream) {
  Plan p;
  if (read_plan(meta, &p)) return (int)cudaErrorInvalidValue;
  if (p.n_layers != p.trunk + 3) return (int)cudaErrorInvalidValue;
  p.e_a = p.freqs_a > 0 ? p.d_a * (1 + 2 * p.freqs_a) : p.d_a;
  p.e_b = p.freqs_b > 0 ? 3 * (1 + 2 * p.freqs_b) : 3;
  const size_t smem =
      sizeof(float) * kRows * p.lds +
      sizeof(bf16) * kRows * (p.lda + pad16(p.e_a) + pad16(p.e_b));
  int err = prepare(nerf_fwd_kernel, smem);
  if (err) return err;
  if (n == 0) return 0;
  nerf_fwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                    (cudaStream_t)stream>>>(
      pts, views, alpha, rgb, dpt, n, reinterpret_cast<const bf16*>(W), B, p);
  return (int)cudaGetLastError();
}

extern "C" int nerf_bwd_launch(const float* pts, const float* views,
                               const float* g_alpha, const float* g_rgb,
                               const float* g_dpt, float* d_pts, float* d_views,
                               int n, const void* W, const float* B,
                               const long long* meta, void* acts, void* dels,
                               float* dbpart, void* stream) {
  Plan p;
  if (read_plan(meta, &p) || n <= 0) return (int)cudaErrorInvalidValue;
  if (p.n_layers != p.trunk + 3) return (int)cudaErrorInvalidValue;
  p.e_a = p.freqs_a > 0 ? p.d_a * (1 + 2 * p.freqs_a) : p.d_a;
  p.e_b = p.freqs_b > 0 ? 3 * (1 + 2 * p.freqs_b) : 3;
  p.lds = p.lds > p.lda ? p.lds : p.lda;  // dx products are Kp wide
  const size_t smem =
      sizeof(float) * kRows * p.lds +
      sizeof(bf16) * kRows * (p.lda + pad16(p.e_a) + pad16(p.e_b)) +
      sizeof(float) * kRows * p.e_a;
  int err = prepare(nerf_bwd_kernel, smem);
  if (err) return err;
  nerf_bwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                    (cudaStream_t)stream>>>(
      pts, views, g_alpha, g_rgb, g_dpt, d_pts, d_views, n,
      reinterpret_cast<const bf16*>(W), B, p, reinterpret_cast<bf16*>(acts),
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
