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
// so that does not carry over. Each backward launch is three kernels, with no
// float atomics, so its gradients repeat bit for bit run to run:
//  1. a tile kernel (one CTA per 64 rows) recomputes the forward, stores every
//     layer's bf16 input row block (the dW contraction's left operand) to a
//     scratch `acts` [n_pad, sum Kp], walks the layers in reverse computing
//     the f32 delta, its per-tile column sum (db partial, scratch
//     [n_tiles, sum Np]), its bf16 rounding (scratch `dels` [n_pad, sum Np])
//     and dx = delta @ W^T, applies the relu masks from the stored
//     activations, unstitches the concats (K5's skip [emb, h] and
//     [feature, emb_view]; K2's input concat) and writes the input cotangents
//     through the embedding VJP;
//  2. a split-K contraction dW_l = acts_l^T @ dels_l, one CTA of 4 warps per
//     64x64 output tile and row split, wmma from global memory, partials to
//     scratch [splits, sum Kp*Np];
//  3. reductions over splits (dW) and over row tiles (db, one warp per
//     column), each in a fixed order.
// Scratch at this slice's shapes: K3 at 65,536 rows holds 174 MB of acts,
// 136 MB of dels, 4.3 MB of db partials and splits x 1.1 MB of dW partials;
// K5 at 16,896 rows 90 MB, 83 MB, 2.6 MB and splits x 2.5 MB. Padded rows
// carry a zero delta, so they add nothing to dW/db.

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
constexpr int kDwThreads = 128;  // 4 warps: one 64x64 dW output tile

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

// K2/K3 input tile: the mode's concat [pts | emb_view | normals | feat]
__device__ void render_input(const Plan& p, const float* __restrict__ pts,
                             const float* __restrict__ nrm,
                             const float* __restrict__ dirs,
                             const float* __restrict__ feat, int n, int row0,
                             bf16* A) {
  const int e_view = p.e_a;
  const int use_view = p.mode != 1;
  const int use_nrm = p.mode != 2;
  const int K0 = p.L[0].K;
  for (int idx = threadIdx.x; idx < kRows * p.L[0].Kp; idx += kThreads) {
    const int r = idx / p.L[0].Kp;
    int c = idx % p.L[0].Kp;
    const int gr = row0 + r;
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
    A[r * p.lda + idx % p.L[0].Kp] = __float2bfloat16(v);
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
  render_input(p, pts, nrm, dirs, feat, n, row0, A);
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

// K3: recompute, then g -> d(pts, normals, dirs, feat) and the per-layer
// deltas (dW/db follow in dw_kernel and the reductions).
__global__ void __launch_bounds__(kThreads)
render_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ dirs, const float* __restrict__ feat,
                  const float* __restrict__ g, float* __restrict__ d_pts,
                  float* __restrict__ d_nrm, float* __restrict__ d_dirs,
                  float* __restrict__ d_feat, int n,
                  const bf16* __restrict__ W, const float* __restrict__ B,
                  Plan p, bf16* acts, bf16* dels, float* dbpart) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);       // [64, lds]
  bf16* A = reinterpret_cast<bf16*>(S + kRows * p.lds);  // [64, lda]

  const int row0 = blockIdx.x * kRows;
  render_input(p, pts, nrm, dirs, feat, n, row0, A);
  __syncthreads();
  render_forward(p, W, B, S, A, acts, row0);

  // output delta: g * y * (1 - y) (sigmoid) or g * (y > 0) (relu)
  const LayerDesc& o = p.L[p.n_layers - 1];
  for (int idx = threadIdx.x; idx < kRows * o.Np; idx += kThreads) {
    const int r = idx / o.Np;
    const int c = idx % o.Np;
    const int gr = row0 + r;
    float v = 0.0f;
    if (c < o.N && gr < n) {
      const float z = S[r * p.lds + c] + B[o.boff + c];
      const float gv = g[(size_t)gr * o.N + c];
      if (p.squeeze_out) {
        const float y = 1.0f / (1.0f + expf(-z));
        v = gv * y * (1.0f - y);
      } else {
        v = z > 0.0f ? gv : 0.0f;
      }
    }
    S[r * p.lds + c] = v;
  }
  __syncthreads();

  for (int l = p.n_layers - 1; l >= 0; --l) {
    const LayerDesc& d = p.L[l];
    emit_delta(Delta{S, p.lds, 0, d.N, nullptr, row0, n}, d, p, A, p.lda,
               dbpart, dels);
    __syncthreads();
    mm_tile_t(A, p.lda, d.Np, W + d.woff, d.Kp, S, p.lds);
    __syncthreads();
    if (l > 0) {
      relu_mask(S, p.lds, 0, d.Kp, acts, p.act_w, d.aoff, row0);
      __syncthreads();
    }
  }

  // S holds the cotangent of the input concat; split it by mode
  const int use_view = p.mode != 1;
  const int use_nrm = p.mode != 2;
  const int c_nrm = 3 + (use_view ? p.e_a : 0);
  const int c_feat = c_nrm + (use_nrm ? 3 : 0);
  for (int idx = threadIdx.x; idx < kRows * 3; idx += kThreads) {
    const int r = idx / 3;
    const int j = idx % 3;
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float* srow = S + r * p.lds;
    d_pts[gr * 3 + j] = srow[j];
    d_nrm[gr * 3 + j] = use_nrm ? srow[c_nrm + j] : 0.0f;
    float dd = 0.0f;
    if (use_view)
      dd = embed_vjp([&](int c) { return srow[3 + c]; }, dirs + gr * 3, 3, j,
                     p.freqs_a);
    d_dirs[gr * 3 + j] = dd;
  }
  for (int idx = threadIdx.x; idx < kRows * p.d_feat; idx += kThreads) {
    const int r = idx / p.d_feat;
    const int c = idx % p.d_feat;
    const int gr = row0 + r;
    if (gr < n) d_feat[(size_t)gr * p.d_feat + c] = S[r * p.lds + c_feat + c];
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

// Split-K dW contraction over every layer: part[split][woff + k * Np + n] =
// sum over the split's rows of acts[row, aoff + k] * dels[row, doff + n].
struct DwPlan {
  int n_layers;
  int tile0[kMaxLayers + 1];  // first output tile of each layer
  int Kp[kMaxLayers], Np[kMaxLayers], aoff[kMaxLayers], doff[kMaxLayers];
  long long woff[kMaxLayers];
  int act_w, del_w, n_rows, rows_per_split;
  long long total_w;
};

__global__ void __launch_bounds__(kDwThreads)
dw_kernel(const bf16* __restrict__ acts, const bf16* __restrict__ dels,
          float* __restrict__ part, DwPlan q) {
  int t = blockIdx.x;
  int l = 0;
  while (t >= q.tile0[l + 1]) ++l;
  t -= q.tile0[l];
  const int Kp = q.Kp[l];
  const int Np = q.Np[l];
  const int n_tiles_n = (Np + 63) / 64;
  const int kf = (t / n_tiles_n) * 4 + threadIdx.x / 32;  // 16-row dW fragment
  const int nf0 = (t % n_tiles_n) * 4;                   // first 16-col fragment
  if (kf * 16 >= Kp) return;
  const int nfs = min(4, Np / 16 - nf0);
  const int r_begin = blockIdx.y * q.rows_per_split;
  const int r_end = min(q.n_rows, r_begin + q.rows_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int r = r_begin; r < r_end; r += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
    wmma::load_matrix_sync(a, acts + (size_t)r * q.act_w + q.aoff[l] + kf * 16,
                           q.act_w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nfs) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(
            b, dels + (size_t)r * q.del_w + q.doff[l] + (nf0 + j) * 16, q.del_w);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  float* out = part + (size_t)blockIdx.y * q.total_w + q.woff[l];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nfs)
      wmma::store_matrix_sync(out + (size_t)kf * 16 * Np + (nf0 + j) * 16,
                              acc[j], Np, wmma::mem_row_major);
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

// the dW contraction and the reductions after a backward tile kernel
int finish_backward(const Plan& p, int n, const bf16* acts, const bf16* dels,
                    const float* dbpart, float* part, int splits, float* dW,
                    float* dB, cudaStream_t stream) {
  const int n_tiles = (n + kRows - 1) / kRows;
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
    q.tile0[l + 1] = q.tile0[l] + ((d.Kp + 63) / 64) * ((d.Np + 63) / 64);
  }
  q.act_w = p.act_w;
  q.del_w = p.del_w;
  q.n_rows = n_tiles * kRows;
  q.rows_per_split = ((n_tiles + splits - 1) / splits) * kRows;
  q.total_w = p.total_w;
  dw_kernel<<<dim3(q.tile0[p.n_layers], splits), kDwThreads, 0, stream>>>(
      acts, dels, part, q);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long w_blocks = (p.total_w + 255) / 256;
  reduce_dw_kernel<<<(int)(w_blocks < 4096 ? w_blocks : 4096), 256, 0, stream>>>(
      part, splits, p.total_w, dW);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_db_kernel<<<(p.total_b + 7) / 8, 256, 0, stream>>>(dbpart, n_tiles, p.total_b, dB);
  return (int)cudaGetLastError();
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
// [n_tiles, sum Np] f32, part [splits, sum Kp*Np] f32: scratch from the
// caller; dW [sum Kp*Np], dB [sum Np]: packed like W and B.
extern "C" int render_bwd_launch(const float* pts, const float* nrm,
                                 const float* dirs, const float* feat,
                                 const float* g, float* d_pts, float* d_nrm,
                                 float* d_dirs, float* d_feat, int n,
                                 const void* W, const float* B,
                                 const long long* meta, void* acts, void* dels,
                                 float* dbpart, float* part, int splits,
                                 float* dW, float* dB, void* stream) {
  Plan p;
  if (read_plan(meta, &p) || n <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  p.e_a = p.freqs_a > 0 ? 3 * (1 + 2 * p.freqs_a) : 3;
  p.lds = p.lds > p.lda ? p.lds : p.lda;  // dx products are Kp wide
  const size_t smem = sizeof(float) * kRows * p.lds +
                      sizeof(bf16) * kRows * p.lda;
  int err = prepare(render_bwd_kernel, smem);
  if (err) return err;
  render_bwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                      (cudaStream_t)stream>>>(
      pts, nrm, dirs, feat, g, d_pts, d_nrm, d_dirs, d_feat, n,
      reinterpret_cast<const bf16*>(W), B, p, reinterpret_cast<bf16*>(acts),
      reinterpret_cast<bf16*>(dels), dbpart);
  err = (int)cudaGetLastError();
  if (err) return err;
  return finish_backward(p, n, reinterpret_cast<const bf16*>(acts),
                         reinterpret_cast<const bf16*>(dels), dbpart, part,
                         splits, dW, dB, (cudaStream_t)stream);
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
                               float* dbpart, float* part, int splits,
                               float* dW, float* dB, void* stream) {
  Plan p;
  if (read_plan(meta, &p) || n <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
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
  err = (int)cudaGetLastError();
  if (err) return err;
  return finish_backward(p, n, reinterpret_cast<const bf16*>(acts),
                         reinterpret_cast<const bf16*>(dels), dbpart, part,
                         splits, dW, dB, (cudaStream_t)stream);
}
