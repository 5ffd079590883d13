// K2 (IDR colour head forward) and K4 (background NeRF forward) for sm_90a.
//
// Replace vdnerf_tpu/ops/pallas/fused_mlp.py::render_net_fused (forward,
// _render_fwd_tile/_render_kernel_fwd) and ::nerf_fused (forward,
// _nerf_fwd_tile/_nerf_kernel_fwd).
//
// Numerics follow the Pallas kernels' _mm: every matmul operand is rounded
// to bf16 and products accumulate in f32; bias, activations and the heads'
// outputs are f32. Because every consumer of an activation is a matmul, the
// tile's activations are kept in shared memory already rounded to bf16,
// which is exact with respect to that policy.
//
// Bound: operations (a row is ~0.5-1 MFLOP of bf16 matmul against ~1 KB of
// I/O). Design, simple first: one CTA of 8 warps per 64-row tile; the
// activation tile (bf16) and one f32 staging tile for the accumulators live
// in shared memory; each warp owns a set of 16-column output fragments and
// runs nvcuda::wmma 16x16x16 bf16 products over the 4 row fragments, reading
// the (zero-padded, [in, out] row-major, bf16) weights straight from global
// memory, where they stay in L2. The epilogue adds the bias, applies the
// activation and writes the next layer's bf16 input back into the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;

struct LayerDesc {
  int K, N, Kp, Np;
  long long woff, boff;
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

// S[0:64, 0:Np] = A[0:64, 0:Kp] @ W[0:Kp, 0:Np]; bf16 in, f32 out.
__device__ void mm_tile(const __nv_bfloat16* A, int lda, int Kp,
                        const __nv_bfloat16* __restrict__ W, int Np, float* S,
                        int lds) {
  const int warp = threadIdx.x / 32;
  const int nfrags = Np / 16;
  for (int nf = warp; nf < nfrags; nf += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRows / 16];
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int k = 0; k < Kp; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + (size_t)k * Np + nf * 16, Np);
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
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

// A[:, col0:col0+N] = bf16(act(S[:, s0:s0+N] + bias)); act: 1 relu, 0 none
__device__ void epilogue(const float* S, int lds, int s0, int N,
                         const float* __restrict__ bias, int relu,
                         __nv_bfloat16* A, int lda, int col0) {
  for (int idx = threadIdx.x; idx < kRows * N; idx += kThreads) {
    const int r = idx / N;
    const int c = idx % N;
    float v = S[r * lds + s0 + c] + bias[c];
    if (relu) v = fmaxf(v, 0.0f);
    A[r * lda + col0 + c] = __float2bfloat16(v);
  }
}

__device__ void zero_cols(__nv_bfloat16* A, int lda, int c_begin, int c_end) {
  const int w = c_end - c_begin;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < kRows * w; idx += kThreads)
    A[(idx / w) * lda + c_begin + idx % w] = __float2bfloat16(0.0f);
}

__global__ void __launch_bounds__(kThreads)
render_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ dirs, const float* __restrict__ feat,
                  float* __restrict__ out, int n,
                  const __nv_bfloat16* __restrict__ W,
                  const float* __restrict__ B, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);                 // [64, lds]
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(S + kRows * p.lds);  // [64, lda]

  const int row0 = blockIdx.x * kRows;
  const int e_view = p.e_a;
  const int use_view = p.mode != 1;
  const int use_nrm = p.mode != 2;
  const int K0 = p.L[0].K;
  // concat by mode: [pts | emb_view | normals | feat]
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
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const LayerDesc& d = p.L[l];
    mm_tile(A, p.lda, d.Kp, W + d.woff, d.Np, S, p.lds);
    __syncthreads();
    if (l + 1 < p.n_layers) {
      epilogue(S, p.lds, 0, d.N, B + d.boff, 1, A, p.lda, 0);
      zero_cols(A, p.lda, d.N, p.L[l + 1].Kp);
    } else {
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
    __syncthreads();
  }
}

// Layers: trunk 0..D-1, then [alpha | feature], views0, [rgb | dpt].
__global__ void __launch_bounds__(kThreads)
nerf_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                float* __restrict__ alpha, float* __restrict__ rgb,
                float* __restrict__ dpt, int n,
                const __nv_bfloat16* __restrict__ W,
                const float* __restrict__ B, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(S + kRows * p.lds);
  __nv_bfloat16* Ea = A + kRows * p.lda;                 // [64, pad16(e_a)]
  __nv_bfloat16* Eb = Ea + kRows * pad16(p.e_a);         // [64, pad16(e_b)]
  const int lea = pad16(p.e_a);
  const int leb = pad16(p.e_b);

  const int row0 = blockIdx.x * kRows;
  for (int idx = threadIdx.x; idx < kRows * lea; idx += kThreads) {
    const int r = idx / lea;
    const int c = idx % lea;
    const int gr = row0 + r;
    float v = 0.0f;
    if (gr < n && c < p.e_a) v = embed_at(pts + (size_t)gr * p.d_a, p.d_a, c);
    const __nv_bfloat16 h = __float2bfloat16(v);
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
  __syncthreads();

  // trunk: relu linears, [emb_pts, h] after every skip layer
  for (int i = 0; i < p.trunk; ++i) {
    const LayerDesc& d = p.L[i];
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

  // heads: [alpha | feature] from h; alpha straight from the accumulators
  const LayerDesc& af = p.L[p.trunk];
  mm_tile(A, p.lda, af.Kp, W + af.woff, af.Np, S, p.lds);
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int gr = row0 + r;
    if (gr < n) alpha[gr] = S[r * p.lds] + B[af.boff];
  }
  const int wfeat = af.N - 1;
  epilogue(S, p.lds, 1, wfeat, B + af.boff + 1, 0, A, p.lda, 0);
  for (int idx = threadIdx.x; idx < kRows * p.e_b; idx += kThreads)
    A[(idx / p.e_b) * p.lda + wfeat + idx % p.e_b] = Eb[(idx / p.e_b) * leb + idx % p.e_b];
  const LayerDesc& v0 = p.L[p.trunk + 1];
  zero_cols(A, p.lda, wfeat + p.e_b, v0.Kp);
  __syncthreads();

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
  int lda = 0, lds = 0;
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
    lda = lda > d.Kp ? lda : d.Kp;
    lda = lda > pad16(d.N) ? lda : pad16(d.N);
    lds = lds > d.Np ? lds : d.Np;
  }
  p->lda = lda;
  p->lds = lds;
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
                      sizeof(__nv_bfloat16) * kRows * p.lda;
  int err = prepare(render_fwd_kernel, smem);
  if (err) return err;
  if (n == 0) return 0;
  render_fwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                      (cudaStream_t)stream>>>(
      pts, nrm, dirs, feat, out, n,
      reinterpret_cast<const __nv_bfloat16*>(W), B, p);
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
      sizeof(__nv_bfloat16) * kRows * (p.lda + pad16(p.e_a) + pad16(p.e_b));
  int err = prepare(nerf_fwd_kernel, smem);
  if (err) return err;
  if (n == 0) return 0;
  nerf_fwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                    (cudaStream_t)stream>>>(
      pts, views, alpha, rgb, dpt, n,
      reinterpret_cast<const __nv_bfloat16*>(W), B, p);
  return (int)cudaGetLastError();
}
