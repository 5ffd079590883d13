// The SDF block's elementwise stages, f32, for sm_90a: the softplus(100)
// trunk's activation, its spatial gradient's chain, and the two sweeps of
// that gradient's backward, each layer's stage in one pass over its rows.
//
// Replaces no TPU kernel: the JAX package runs the SDF value, gradient and
// feature as XLA's fusions of jax.grad under the outer grad. The port ran
// them as autograd's double-backward graph, whose softplus chain, its
// derivative and the derivative's derivative read and wrote a full
// [rows x 256] f32 tensor per op (some 40-50 passes a hidden layer).
// ops/sdf_block.py's SDFBlock writes the block out instead: the products stay
// f32 cuBLAS calls, and between them each layer's elementwise work is one of
// these kernels.
//
// Bound: bytes. Every stage does a few flops (one expf, one log1pf or one
// division) per 4-byte element it reads; at 3.35 TB/s a [49,152 x 256]
// tensor takes 15 us to read. Design: one CTA of 256 threads per 8 rows;
// thread t owns columns t, t + 256, ... of each row, so a warp reads 128
// contiguous bytes per tensor and row, and each thread first loads its 8
// rows of every input (8 loads in flight per tensor) before it computes and
// stores. Strides are arguments, so a stage reads and writes column slices in
// place: the skip layer's [h | emb] input, its gradient's split. No
// allocation, no atomics, no synchronisation: a launch on the caller's
// stream, captured into a CUDA graph as any other. The bias's gradient comes
// from the sweep down as each CTA's column sums, which the wrapper adds up
// (a 1/8-size reduction in place of one over the whole block). The
// embedding's stages (its Jacobian and the Jacobian's derivative, 39 columns
// a row) stage a CTA's rows in shared memory or take one thread per element,
// so that their loads stay coalesced.
//
// The sigmoid sigma(100 z) = softplus'(z) and its derivative
// 100 sigma (1 - sigma) are computed from e = exp(-|100 z|) as 1 / (1 + e)
// or e / (1 + e) and 100 e / (1 + e)^2, so neither loses its bits where sigma
// saturates (1 - sigma would).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows per CTA of the row stages
constexpr int kMaxTails = 4;
constexpr int kEmbRows = 32;  // rows per CTA of embed_grad
constexpr int kVjpRows = 16;  // of embed_vjp, which stages three blocks
constexpr int kMaxBands = 24;
constexpr float kBeta = 100.0f;

// softplus(100 z) / 100 in the stable form, as sdf_fwd.cu's softplus100 and
// the plain version run it (the division as a multiply by 0.01f, as torch
// runs a division by a Python float on a CUDA tensor)
__device__ __forceinline__ float softplus100(float z) {
  const float bz = kBeta * z;
  return (fmaxf(bz, 0.0f) + log1pf(expf(-fabsf(bz)))) * 0.01f;
}

// sigma(100 z) and d sigma(100 z) / dz
__device__ __forceinline__ void sigmoid100(float z, float& s, float& ds) {
  const float bz = kBeta * z;
  const float e = expf(-fabsf(bz));
  const float t = 1.0f / (1.0f + e);
  s = bz > 0.0f ? t : e * t;
  ds = kBeta * (e * t) * t;
}

__device__ __forceinline__ long long at(int row, int ld, int c) {
  return (long long)row * ld + c;
}

// h[:, :C] = coef softplus(z); h[:, C:C+T] = tcoef tail (the skip's embedding)
__global__ void __launch_bounds__(kThreads)
sdfb_act_kernel(const float* __restrict__ z, int ldz, float* __restrict__ h, int ldh, int n,
                int C, float coef, const float* __restrict__ tail, int ldt, int T, float tcoef) {
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int c = threadIdx.x; c < C + T; c += kThreads) {
    float v[kRows];
    const bool act = c < C;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows) v[i] = act ? z[at(row0 + i, ldz, c)] : tail[at(row0 + i, ldt, c - C)];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows) h[at(row0 + i, ldh, c)] = act ? coef * softplus100(v[i]) : tcoef * v[i];
  }
}

// The gradient's chain down one layer: r = p sigma(100 z), p = pcoef q or,
// below the last layer, the broadcast row pvec.
__global__ void __launch_bounds__(kThreads)
sdfb_tangent_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ pvec,
                    float pcoef, const float* __restrict__ z, int ldz, float* __restrict__ r,
                    int ldr, int n, int C) {
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float zv[kRows], pv[kRows];
    const float pc = pvec ? pvec[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) {
        zv[i] = z[at(row0 + i, ldz, c)];
        pv[i] = pvec ? pc : pcoef * q[at(row0 + i, ldq, c)];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) {
        float s, ds;
        sigmoid100(zv[i], s, ds);
        r[at(row0 + i, ldr, c)] = pv[i] * s;
      }
    }
  }
}

// The backward's sweep up one layer, carrying the gradient chain's cotangent:
// from rbar (the cotangent of r = p sigma), qbar[:, :C] = pcoef rbar sigma
// (p's, then q's), qbar[:, C:C+T] = tcoef tail (the embedding's share at a
// skip), and the second-order term s2 = rbar p 100 sigma (1 - sigma), which
// the sweep down adds to z's cotangent. With psum, each CTA also writes its
// rows' column sums of qbar[:, :C] to psum[blockIdx.x, :]; qbar may then be
// null (below the last layer its only use is that sum).
__global__ void __launch_bounds__(kThreads)
sdfb_up_kernel(const float* __restrict__ rbar, int ldrb, const float* __restrict__ q, int ldq,
               const float* __restrict__ pvec, float pcoef, const float* __restrict__ z, int ldz,
               float* __restrict__ qbar, int ldqb, float* __restrict__ s2, int lds2,
               float* __restrict__ psum, int n, int C, const float* __restrict__ tail, int ldt,
               int T, float tcoef) {
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float zv[kRows], pv[kRows], rb[kRows];
    const float pc = pvec ? pvec[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) {
        zv[i] = z[at(row0 + i, ldz, c)];
        rb[i] = rbar[at(row0 + i, ldrb, c)];
        pv[i] = pvec ? pc : pcoef * q[at(row0 + i, ldq, c)];
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) {
        float s, ds;
        sigmoid100(zv[i], s, ds);
        const float qb = pcoef * (rb[i] * s);
        if (qbar) qbar[at(row0 + i, ldqb, c)] = qb;
        sum += qb;
        s2[at(row0 + i, lds2, c)] = rb[i] * pv[i] * ds;
      }
    }
    if (psum) psum[at(blockIdx.x, C, c)] = sum;
  }
  for (int c = threadIdx.x; c < T; c += kThreads) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows) qbar[at(row0 + i, ldqb, C + c)] = tcoef * tail[at(row0 + i, ldt, c)];
  }
}

// The backward's sweep down one layer: z's cotangent
// zbar = acoef abar sigma(100 z) + s2 (zbar may be s2 itself), and each CTA's
// column sums of it in psum[blockIdx.x, :] (the bias's gradient, summed
// over the CTAs by the wrapper: no atomics, the same bits every launch).
__global__ void __launch_bounds__(kThreads)
sdfb_down_kernel(const float* __restrict__ abar, int ldab, float acoef, const float* z, int ldz,
                 const float* s2, int lds2, float* zbar, int ldzb, float* __restrict__ psum,
                 int n, int C) {
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float zv[kRows], ab[kRows], sv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) {
        zv[i] = z[at(row0 + i, ldz, c)];
        ab[i] = abar[at(row0 + i, ldab, c)];
        sv[i] = s2[at(row0 + i, lds2, c)];
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) {
        float s, ds;
        sigmoid100(zv[i], s, ds);
        const float zb = acoef * ab[i] * s + sv[i];
        zbar[at(row0 + i, ldzb, c)] = zb;
        sum += zb;
      }
    }
    psum[at(blockIdx.x, C, c)] = sum;
  }
}

// The embedding's cotangent sources: a base [n, d] block plus coef times each
// skip layer's tail block of the same width.
struct Tails {
  const float* p[kMaxTails];
  int ld[kMaxTails];
  int count;
  float coef;
};

__device__ __forceinline__ float gather(const float* base, int ldb, const Tails& t, int row,
                                        int i) {
  float v = base[at(row, ldb, i)];
  for (int k = 0; k < t.count; ++k) v += t.coef * t.p[k][at(row, t.ld[k], i)];
  return v;
}

// The embedding's layout: [x (3) | sin(f_0 x) (3) | cos(f_0 x) (3) | sin(f_1 x) ...],
// f_k = 2^k; e holds its values, whose sin and cos parts are the derivatives'.
__device__ __forceinline__ int sin_col(int k, int j) { return 3 + 6 * k + j; }
__device__ __forceinline__ int cos_col(int k, int j) { return 6 + 6 * k + j; }

// The spatial gradient: E = q0 + coef sum(tails) (the sdf's cotangent at the
// embedding), grad = scale E J(u) with u = scale pts; E is kept where Eout
// is given (the points' own gradient needs it). A CTA stages its kEmbRows
// rows of E and e in shared memory with coalesced loads (a row's d0 values
// are contiguous, and consecutive threads take consecutive values), then
// one thread per row and coordinate reads them there.
__global__ void __launch_bounds__(kThreads)
sdfb_embed_grad_kernel(const float* __restrict__ q0, int ldq, Tails tails,
                       const float* __restrict__ e, int lde, float* __restrict__ grad,
                       float* __restrict__ Eout, int n, int L, float scale) {
  extern __shared__ float smem[];
  const int d0 = 3 * (1 + 2 * L);
  float* Es = smem;                 // [kEmbRows, d0]
  float* es = smem + kEmbRows * d0;  // [kEmbRows, d0]
  const int row0 = blockIdx.x * kEmbRows;
  const int rows = min(kEmbRows, n - row0);
  for (int idx = threadIdx.x; idx < rows * d0; idx += kThreads) {
    const int r = idx / d0, i = idx - r * d0;
    const float v = gather(q0, ldq, tails, row0 + r, i);
    Es[idx] = v;
    es[idx] = e[at(row0 + r, lde, i)];
    if (Eout) Eout[at(row0 + r, d0, i)] = v;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows * 3) return;
  const int r = t / 3, j = t - 3 * r;
  const float* E = Es + r * d0;
  const float* x = es + r * d0;
  float g = E[j];
  for (int k = 0; k < L; ++k)
    g += (float)(1 << k) * (E[sin_col(k, j)] * x[cos_col(k, j)] - E[cos_col(k, j)] * x[sin_col(k, j)]);
  grad[at(row0, 3, t)] = scale * g;
}

// The gradient's cotangent at the embedding, Ebar = scale gbar J(u)^T: one
// thread per element of Ebar, so that its writes and the reads of e are
// coalesced.
__global__ void __launch_bounds__(kThreads)
sdfb_embed_cot_kernel(const float* __restrict__ gbar, const float* __restrict__ e, int lde,
                      float* __restrict__ Ebar, int ldeb, int n, int L, float scale) {
  const int d0 = 3 * (1 + 2 * L);
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)n * d0) return;
  const int row = (int)(idx / d0), i = (int)(idx - (long long)row * d0);
  float v;
  if (i < 3) {
    v = scale * gbar[at(row, 3, i)];
  } else {
    const int k = (i - 3) / 6, m = (i - 3) - 6 * k, j = m % 3;
    const float gf = scale * gbar[at(row, 3, j)] * (float)(1 << k);
    v = m < 3 ? gf * e[at(row, lde, cos_col(k, j))] : -gf * e[at(row, lde, sin_col(k, j))];
  }
  Ebar[at(row, ldeb, i)] = v;
}

// The points' cotangent: from the embedding's, ebar = abar0 + coef sum(tails),
// through J(u)^T, plus the gradient's own dependence on u through J (the
// embedding's second derivative: -scale gbar_j sum_k f_k^2 (E_sin sin + E_cos cos)),
// all times scale. Staged as embed_grad is, kVjpRows rows of ebar, e and E a
// CTA: a thread per row reading its row's strided values from memory would
// pull a 32-byte sector per 4-byte value once the blocks outgrow L2.
__global__ void __launch_bounds__(kThreads)
sdfb_embed_vjp_kernel(const float* __restrict__ abar0, int ldab, Tails tails,
                      const float* __restrict__ gbar, const float* __restrict__ E,
                      const float* __restrict__ e, int lde, float* __restrict__ out, int n, int L,
                      float scale) {
  extern __shared__ float smem[];
  const int d0 = 3 * (1 + 2 * L);
  float* Bs = smem;                      // [kVjpRows, d0] ebar
  float* Xs = smem + kVjpRows * d0;      // e
  float* Es = smem + 2 * kVjpRows * d0;  // E
  const int row0 = blockIdx.x * kVjpRows;
  const int rows = min(kVjpRows, n - row0);
  for (int idx = threadIdx.x; idx < rows * d0; idx += kThreads) {
    const int r = idx / d0, i = idx - r * d0;
    Bs[idx] = gather(abar0, ldab, tails, row0 + r, i);
    Xs[idx] = e[at(row0 + r, lde, i)];
    Es[idx] = E[at(row0 + r, d0, i)];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows * 3) return;
  const int r = t / 3, j = t - 3 * r;
  const float* b = Bs + r * d0;
  const float* x = Xs + r * d0;
  const float* Er = Es + r * d0;
  float u = b[j];
  float second = 0.0f;
  for (int k = 0; k < L; ++k) {
    const float f = (float)(1 << k);
    const float sn = x[sin_col(k, j)], cs = x[cos_col(k, j)];
    u += f * (b[sin_col(k, j)] * cs - b[cos_col(k, j)] * sn);
    second += f * f * (Er[sin_col(k, j)] * sn + Er[cos_col(k, j)] * cs);
  }
  u -= scale * gbar[at(row0, 3, t)] * second;
  out[at(row0, 3, t)] = scale * u;
}

int row_blocks(int n) { return (n + kRows - 1) / kRows; }

int tails_from(const long long* meta, float coef, Tails* t) {
  t->count = (int)meta[0];
  t->coef = coef;
  if (t->count < 0 || t->count > kMaxTails) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < t->count; ++k) {
    t->p[k] = reinterpret_cast<const float*>(meta[1 + 2 * k]);
    t->ld[k] = (int)meta[2 + 2 * k];
  }
  return 0;
}

}  // namespace

// Every launcher runs on `stream`, returns a cudaError_t (0 when the launch
// was taken), and takes f32 row-major blocks as (pointer, row stride in
// elements); n rows, C columns. A tails meta (int64): [count, then pointer,
// row stride of each], at most 4.

extern "C" int sdfb_act_launch(const float* z, int ldz, float* h, int ldh, int n, int C,
                               float coef, const float* tail, int ldt, int T, float tcoef,
                               void* stream) {
  if (C < 1 || T < 0 || (T > 0 && !tail)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  sdfb_act_kernel<<<row_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      z, ldz, h, ldh, n, C, coef, tail, ldt, T, tcoef);
  return (int)cudaGetLastError();
}

extern "C" int sdfb_tangent_launch(const float* q, int ldq, const float* pvec, float pcoef,
                                   const float* z, int ldz, float* r, int ldr, int n, int C,
                                   void* stream) {
  if (C < 1 || (!q && !pvec)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  sdfb_tangent_kernel<<<row_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      q, ldq, pvec, pcoef, z, ldz, r, ldr, n, C);
  return (int)cudaGetLastError();
}

extern "C" int sdfb_up_launch(const float* rbar, int ldrb, const float* q, int ldq,
                              const float* pvec, float pcoef, const float* z, int ldz,
                              float* qbar, int ldqb, float* s2, int lds2, float* psum, int n,
                              int C, const float* tail, int ldt, int T, float tcoef,
                              void* stream) {
  if (C < 1 || (!q && !pvec) || (!qbar && !psum) || T < 0 || (T > 0 && (!tail || !qbar)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  sdfb_up_kernel<<<row_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      rbar, ldrb, q, ldq, pvec, pcoef, z, ldz, qbar, ldqb, s2, lds2, psum, n, C, tail, ldt, T,
      tcoef);
  return (int)cudaGetLastError();
}

// psum: [ceil(n / 8), C], each CTA's column sums of zbar
extern "C" int sdfb_down_launch(const float* abar, int ldab, float acoef, const float* z, int ldz,
                                const float* s2, int lds2, float* zbar, int ldzb, float* psum,
                                int n, int C, void* stream) {
  if (C < 1 || !psum) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  sdfb_down_kernel<<<row_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      abar, ldab, acoef, z, ldz, s2, lds2, zbar, ldzb, psum, n, C);
  return (int)cudaGetLastError();
}

extern "C" int sdfb_embed_grad_launch(const float* q0, int ldq, const long long* tails,
                                      float tcoef, const float* e, int lde, float* grad,
                                      float* Eout, int n, int L, float scale, void* stream) {
  Tails t;
  int err = tails_from(tails, tcoef, &t);
  if (err || L < 0 || L > kMaxBands) return err ? err : (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // at most 2 x 32 x 147 floats (37.6 KB) at kMaxBands: under the 48 KB default
  const size_t smem = 2 * kEmbRows * 3 * (1 + 2 * L) * sizeof(float);
  sdfb_embed_grad_kernel<<<(n + kEmbRows - 1) / kEmbRows, kThreads, smem,
                           (cudaStream_t)stream>>>(q0, ldq, t, e, lde, grad, Eout, n, L, scale);
  return (int)cudaGetLastError();
}

extern "C" int sdfb_embed_cot_launch(const float* gbar, const float* e, int lde, float* Ebar,
                                     int ldeb, int n, int L, float scale, void* stream) {
  if (L < 0 || L > kMaxBands) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long total = (long long)n * 3 * (1 + 2 * L);
  sdfb_embed_cot_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(gbar, e, lde, Ebar, ldeb, n, L, scale);
  return (int)cudaGetLastError();
}

extern "C" int sdfb_embed_vjp_launch(const float* abar0, int ldab, const long long* tails,
                                     float tcoef, const float* gbar, const float* E,
                                     const float* e, int lde, float* out, int n, int L,
                                     float scale, void* stream) {
  Tails t;
  int err = tails_from(tails, tcoef, &t);
  if (err || L < 0 || L > kMaxBands) return err ? err : (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // at most 3 x 16 x 147 floats (28.2 KB) at kMaxBands
  const size_t smem = 3 * kVjpRows * 3 * (1 + 2 * L) * sizeof(float);
  sdfb_embed_vjp_kernel<<<(n + kVjpRows - 1) / kVjpRows, kThreads, smem,
                          (cudaStream_t)stream>>>(abar0, ldab, t, gbar, E, e, lde, out, n, L,
                                                  scale);
  return (int)cudaGetLastError();
}
