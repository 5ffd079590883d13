// K1: gradient-free SDF value trunk, f32 throughout, for sm_90a.
//
// Replaces vdnerf_tpu/ops/pallas/sdf_fwd.py::sdf_value_pallas (kernel body
// _make_kernel). Per row: positional encoding of scale*pts (L bands), the
// linear chain with softplus(100 x)/100 between layers, the skip concat
// [x, emb] * 1/sqrt(2) before every skip layer, and only the sdf column of
// the last layer, divided by scale.
//
// Bound: operations. At full width a row costs ~0.92 MFLOP against 16 bytes
// of I/O, far above the card's f32 ridge, and the f32 policy keeps it off the
// tensor cores. Design: one CTA of 256 threads per 64-row tile; the tile's
// activations live in shared memory (two f32 ping-pong buffers), weights
// stream through shared memory 32 input rows at a time (they stay in L2),
// and each thread accumulates an 8x8 register block with FMA. Within a warp
// all threads read the same activation row (broadcast) and consecutive
// weight columns (no bank conflicts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // rows per CTA
constexpr int kThreads = 256; // 8 row groups x 32 column lanes
constexpr int kColBlock = 256;
constexpr int kKChunk = 32;
constexpr int kMaxLayers = 16;

struct SdfPlan {
  int n_layers;
  int K[kMaxLayers];
  int N[kMaxLayers];
  long long woff[kMaxLayers];
  long long boff[kMaxLayers];
  unsigned skip_mask;
  int multires;
  int d_emb;
  int ldx;
  float scale;
};

__device__ __forceinline__ float softplus100(float x) {
  const float bx = 100.0f * x;
  return (fmaxf(bx, 0.0f) + log1pf(expf(-fabsf(bx)))) / 100.0f;
}

__global__ void __launch_bounds__(kThreads)
sdf_fwd_kernel(const float* __restrict__ pts, float* __restrict__ out, int n,
               const float* __restrict__ W, const float* __restrict__ B,
               SdfPlan p) {
  extern __shared__ float smem[];
  float* X = smem;                          // [kRows, ldx]
  float* Y = X + kRows * p.ldx;             // [kRows, ldx]
  float* E = Y + kRows * p.ldx;             // [kRows, d_emb]
  float* Wc = E + kRows * p.d_emb;          // [kKChunk, kColBlock]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * kRows;

  // positional encoding [x | sin(f0 x) | cos(f0 x) | ...], f = 2^i exactly
  for (int idx = tid; idx < kRows * p.d_emb; idx += kThreads) {
    const int r = idx / p.d_emb;
    const int c = idx % p.d_emb;
    const int gr = row0 + r;
    float v = 0.0f;
    if (gr < n) {
      if (c < 3) {
        v = pts[gr * 3 + c] * p.scale;
      } else {
        const int j = c - 3;
        const int band = j / 6;
        const int is_cos = (j / 3) & 1;
        const float x = pts[gr * 3 + (j % 3)] * p.scale * ldexpf(1.0f, band);
        v = is_cos ? cosf(x) : sinf(x);
      }
    }
    E[r * p.d_emb + c] = v;
    X[r * p.ldx + c] = v;
  }
  __syncthreads();

  const float inv_sqrt2 = 0.70710678118654752f;
  int width = p.d_emb;
  for (int l = 0; l < p.n_layers; ++l) {
    if ((p.skip_mask >> l) & 1u) {
      for (int idx = tid; idx < kRows * (width + p.d_emb); idx += kThreads) {
        const int r = idx / (width + p.d_emb);
        const int c = idx % (width + p.d_emb);
        const float v = c < width ? X[r * p.ldx + c] : E[r * p.d_emb + c - width];
        X[r * p.ldx + c] = v * inv_sqrt2;
      }
      width += p.d_emb;
      __syncthreads();
    }
    const int K = p.K[l];
    const int N = p.N[l];
    const float* Wl = W + p.woff[l];
    const float* Bl = B + p.boff[l];
    const bool last = l + 1 == p.n_layers;
    for (int c0 = 0; c0 < N; c0 += kColBlock) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += kKChunk) {
        for (int idx = tid; idx < kKChunk * kColBlock; idx += kThreads) {
          const int kk = idx / kColBlock;
          const int c = idx % kColBlock;
          const int k = k0 + kk;
          Wc[idx] = (k < K && c0 + c < N) ? Wl[(long long)k * N + c0 + c] : 0.0f;
        }
        __syncthreads();
        const int kmax = min(kKChunk, K - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float a[8], w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = X[(ty * 8 + i) * p.ldx + k0 + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) w[j] = Wc[kk * kColBlock + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < N) {
          const float b = Bl[c];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = acc[i][j] + b;
            Y[(ty * 8 + i) * p.ldx + c] = last ? v : softplus100(v);
          }
        }
      }
    }
    __syncthreads();
    float* t = X;
    X = Y;
    Y = t;
    width = N;
  }

  for (int r = tid; r < kRows; r += kThreads) {
    const int gr = row0 + r;
    if (gr < n) out[gr] = X[r * p.ldx] / p.scale;
  }
}

}  // namespace

// meta (int64): [n_layers, skip_mask, multires, then K_l, N_l, woff_l, boff_l
// for each layer]. Weights are effective [in, out] f32 matrices packed into W
// at woff_l; biases packed into B at boff_l. Returns a cudaError_t.
extern "C" int sdf_fwd_launch(const float* pts, float* out, int n,
                              const float* W, const float* B,
                              const long long* meta, float scale,
                              void* stream) {
  SdfPlan p{};
  p.n_layers = (int)meta[0];
  if (p.n_layers < 1 || p.n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  p.skip_mask = (unsigned)meta[1];
  p.multires = (int)meta[2];
  p.d_emb = 3 * (1 + 2 * p.multires);
  p.scale = scale;
  int ldx = p.d_emb;
  int width = p.d_emb;
  for (int l = 0; l < p.n_layers; ++l) {
    p.K[l] = (int)meta[3 + 4 * l];
    p.N[l] = (int)meta[4 + 4 * l];
    p.woff[l] = meta[5 + 4 * l];
    p.boff[l] = meta[6 + 4 * l];
    if ((p.skip_mask >> l) & 1u) width += p.d_emb;
    if (width != p.K[l]) return (int)cudaErrorInvalidValue;
    ldx = ldx > p.K[l] ? ldx : p.K[l];
    ldx = ldx > p.N[l] ? ldx : p.N[l];
    width = p.N[l];
  }
  p.ldx = ldx;
  const size_t smem =
      sizeof(float) * ((size_t)2 * kRows * ldx + (size_t)kRows * p.d_emb +
                       (size_t)kKChunk * kColBlock);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int grid = (n + kRows - 1) / kRows;
  sdf_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(pts, out, n, W, B, p);
  return (int)cudaGetLastError();
}
