// K1: gradient-free SDF value trunk, f32-accurate, for sm_90a.
//
// Replaces vdnerf_tpu/ops/pallas/sdf_fwd.py::sdf_value_pallas (kernel body
// _make_kernel). Per row: positional encoding of scale*pts (L bands), the
// linear chain with softplus(100 x)/100 between layers, the skip concat
// [x, emb] * 1/sqrt(2) before every skip layer, and only the sdf column of
// the last layer, divided by scale.
//
// Bound: operations. A full-width row is ~0.92 MFLOP against 16 bytes of I/O.
// In plain f32 FMA the card's 67 TFLOP/s set the bound (3.59 ms at 262,144
// rows); an f32-SIMT loop fed from shared memory also spends one shared load
// per few FMAs. This design moves the products onto the tensor cores without
// giving up f32 accuracy, by 3xTF32 (the idiom of CUTLASS's
// OpMultiplyAddFastF32): each operand x is split in registers into
// big = tf32(x) and small = tf32(x - big) (with integer adds and masks, see
// split_tf32), and the products
// small*big + big*small + big*big accumulate in f32 through
// mma.sync.m16n8k8.tf32; the dropped small*small term is below 2^-21 of the
// product. The tensor cores' f32 accumulation does not round to nearest, so
// each 32-deep slab sums from zero in the tensor cores and the slab sums add
// into the row's accumulators with ordinary f32 adds: over 256 inputs that
// keeps the error within ~2e-6 of the output's scale. Its bound is 3x the
// operations over the TF32 dense peak (495 TFLOP/s): 1.46 ms at 262,144 rows.
//
// Design: one CTA of 8 warps per tile of R rows (R = 64, or 32 when 64-row
// tiles would not give every SM two CTAs; the wrapper picks R from n). The
// tile's activations live in one f32 shared-memory buffer (row stride = 4 mod
// 32 words, so the A-fragment loads are conflict-free) and are overwritten in
// place by each layer's epilogue, after a barrier: the whole layer output is
// held in the accumulators (warp w owns columns 32w..32w+31 for all R rows;
// layers are at most 256 wide). The weights, packed by the wrapper as
// zero-padded [Kp, Np] f32 (Kp a multiple of 32, Np a multiple of 32),
// stream through a 2-stage cp.async ring of 32-row slabs with 16-byte copies;
// the ring runs across layer boundaries, so the next layer's first slab
// loads during this layer's last. A slab row has a stride of 264 words (8 mod
// 32), which makes the B-fragment loads conflict-free. The last layer (one output
// column) is a per-row dot product in f32 FMA, reduced over the warp by a
// fixed shuffle tree. The softplus is the plain version's stable
// max(bx,0)+log1p(exp(-|bx|)), which has no identity cut-off
// (softplus100). No atomics: two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;        // weight rows per slab
constexpr int kStages = 2;
constexpr int kMaxCols = 256;  // widest hidden layer: 8 warps x 32 columns
constexpr int kLdw = kMaxCols + 8;
constexpr int kMaxLayers = 16;

struct SdfPlan {
  int n_layers;
  int K[kMaxLayers];
  int N[kMaxLayers];
  int Kp[kMaxLayers];
  int Np[kMaxLayers];
  long long woff[kMaxLayers];
  long long boff[kMaxLayers];
  int slab0[kMaxLayers + 1];  // first ring slab of each hidden layer
  unsigned skip_mask;
  int d_emb;
  int ldx;
  float scale;
};

// the stable softplus(100 x) / 100 of the plain version, step for step as
// torch runs it on a CUDA tensor: there a true division by a Python float is
// a multiply by the f32 reciprocal, 0.01f (chip_smoke.py holds the two bit
// for bit). An IEEE division would be a long instruction sequence that, 2,048
// times per row, took more time than the products.
__device__ __forceinline__ float softplus100(float x) {
  const float bx = 100.0f * x;
  return (fmaxf(bx, 0.0f) + log1pf(expf(-fabsf(bx)))) * 0.01f;
}

// x = big + small + e with big = tf32(x) rounded to nearest (ties away, as
// cvt.rna.tf32.f32 does), small = x - big truncated to tf32 and
// |e| <= 2^-22 |x|. Integer adds and masks, not cvt: conversions run at a
// fraction of the FP32 rate and would be the split's bottleneck.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ring slab s (of the hidden layers' weights) into stage buffer `dst`
__device__ void load_slab(const SdfPlan& p, const float* __restrict__ W, int s,
                          float* dst) {
  int l = 0;
  while (s >= p.slab0[l + 1]) ++l;
  const int k0 = (s - p.slab0[l]) * kKC;
  const int Np = p.Np[l];
  const int vec_row = Np / 4;
  const float* src = W + p.woff[l] + (long long)k0 * Np;
  for (int idx = threadIdx.x; idx < kKC * vec_row; idx += kThreads) {
    const int r = idx / vec_row;
    const int c = (idx % vec_row) * 4;
    cp_async16(dst + r * kLdw + c, src + (long long)r * Np + c);
  }
}

// X[:, 0:width + d_emb] = [X[:, 0:width], E] / sqrt(2) in place -> new width
template <int R>
__device__ int skip_concat(float* X, const float* E, const SdfPlan& p, int width) {
  const float inv_sqrt2 = 0.70710678118654752f;
  const int w = width + p.d_emb;
  for (int idx = threadIdx.x; idx < R * w; idx += kThreads) {
    const int r = idx / w;
    const int c = idx % w;
    const float v = c < width ? X[r * p.ldx + c] : E[r * p.d_emb + c - width];
    X[r * p.ldx + c] = v * inv_sqrt2;
  }
  __syncthreads();
  return w;
}

template <int R>
__global__ void __launch_bounds__(kThreads, R == 32 ? 2 : 1)
sdf_fwd_kernel(const float* __restrict__ pts, float* __restrict__ out, int n,
               const float* __restrict__ W, const float* __restrict__ B,
               SdfPlan p) {
  constexpr int MT = R / 16;  // 16-row m tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* Wst = smem;                        // [kStages][kKC][kLdw]
  float* X = Wst + kStages * kKC * kLdw;    // [R][ldx]
  float* E = X + R * p.ldx;                 // [R][d_emb]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * R;
  const int n_hidden = p.n_layers - 1;
  const int n_slabs = p.slab0[n_hidden];

  if (n_slabs > 0) load_slab(p, W, 0, Wst);
  cp_async_commit();

  // zero the tile (columns past a layer's width meet zero weight rows, and
  // must be finite), then the positional encoding [x | sin f0 x | cos f0 x..]
  for (int idx = tid; idx < R * p.ldx; idx += kThreads) X[idx] = 0.0f;
  __syncthreads();
  for (int idx = tid; idx < R * p.d_emb; idx += kThreads) {
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

  int width = p.d_emb;
  int s = 0;
  for (int l = 0; l < n_hidden; ++l) {
    if ((p.skip_mask >> l) & 1u) width = skip_concat<R>(X, E, p, width);
    const int Np = p.Np[l];
    const int nb = warp * 32;  // this warp's first output column
    const bool active = nb < Np;
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    for (; s < p.slab0[l + 1]; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slab s landed; every warp is done with slab s - 1
      if (s + 1 < n_slabs) load_slab(p, W, s + 1, Wst + ((s + 1) % kStages) * kKC * kLdw);
      cp_async_commit();
      if (!active) continue;
      const float* Ws = Wst + (s % kStages) * kKC * kLdw;
      const int k0 = (s - p.slab0[l]) * kKC;
      // the tensor cores' f32 accumulation truncates: a slab's products sum
      // from zero there, and the slab sums add into acc in round-to-nearest
      float part[MT][4][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_tf32(Ws[(kk + t) * kLdw + nb + j * 8 + g], bb[j][0], bs[j][0]);
          split_tf32(Ws[(kk + t + 4) * kLdw + nb + j * 8 + g], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* xr = X + (i * 16 + g) * p.ldx + k0 + kk + t;
          uint32_t ab[4], as[4];
          split_tf32(xr[0], ab[0], as[0]);
          split_tf32(xr[8 * p.ldx], ab[1], as[1]);
          split_tf32(xr[4], ab[2], as[2]);
          split_tf32(xr[8 * p.ldx + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_tf32(part[i][j], as, bb[j][0], bb[j][1]);
            mma_tf32(part[i][j], ab, bs[j][0], bs[j][1]);
            mma_tf32(part[i][j], ab, bb[j][0], bb[j][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    __syncthreads();  // every warp has read this layer's input
    if (active) {
      const float* Bl = B + p.boff[l];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb + j * 8 + 2 * t;
        const float b0 = Bl[c], b1 = Bl[c + 1];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float* x0 = X + (i * 16 + g) * p.ldx + c;
          float* x1 = x0 + 8 * p.ldx;
          x0[0] = softplus100(acc[i][j][0] + b0);
          x0[1] = softplus100(acc[i][j][1] + b1);
          x1[0] = softplus100(acc[i][j][2] + b0);
          x1[1] = softplus100(acc[i][j][3] + b1);
        }
      }
    }
    __syncthreads();
    width = p.N[l];
  }

  // last layer: the sdf column, a per-row dot product over K in a fixed order
  const int L = n_hidden;
  if ((p.skip_mask >> L) & 1u) skip_concat<R>(X, E, p, width);
  const int K = p.K[L];
  const float* wl = W + p.woff[L];
  const int ldl = p.Np[L];
  const float bias = B[p.boff[L]];
  for (int r = warp; r < R; r += kWarps) {
    float v = 0.0f;
    for (int k = lane; k < K; k += 32) v = fmaf(X[r * p.ldx + k], __ldg(wl + (long long)k * ldl), v);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int gr = row0 + r;
    if (lane == 0 && gr < n) out[gr] = (v + bias) / p.scale;
  }
}

template <int R>
int launch(const float* pts, float* out, int n, const float* W, const float* B,
           const SdfPlan& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kStages * kKC * kLdw +
                                       (size_t)R * p.ldx + (size_t)R * p.d_emb);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sdf_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sdf_fwd_kernel<R><<<(n + R - 1) / R, kThreads, smem, stream>>>(pts, out, n, W, B, p);
  return (int)cudaGetLastError();
}

}  // namespace

// meta (int64): [n_layers, skip_mask, multires, rows_per_cta, then K_l, N_l,
// Kp_l, Np_l, woff_l, boff_l per layer]. Weights are effective [in, out] f32
// matrices zero-padded to [Kp_l, Np_l] and packed into W at woff_l; biases
// zero-padded to Np_l and packed into B at boff_l. Hidden layers need
// Kp_l % 32 == 0, Np_l % 32 == 0 and Np_l <= 256. Returns a cudaError_t.
extern "C" int sdf_fwd_launch(const float* pts, float* out, int n,
                              const float* W, const float* B,
                              const long long* meta, float scale,
                              void* stream) {
  SdfPlan p{};
  p.n_layers = (int)meta[0];
  if (p.n_layers < 1 || p.n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  p.skip_mask = (unsigned)meta[1];
  const int multires = (int)meta[2];
  const int rows = (int)meta[3];
  p.d_emb = 3 * (1 + 2 * multires);
  p.scale = scale;
  int ldx = p.d_emb;
  int width = p.d_emb;
  p.slab0[0] = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const long long* m = meta + 4 + 6 * l;
    p.K[l] = (int)m[0];
    const int N = (int)m[1];
    p.N[l] = N;
    p.Kp[l] = (int)m[2];
    p.Np[l] = (int)m[3];
    p.woff[l] = m[4];
    p.boff[l] = m[5];
    if ((p.skip_mask >> l) & 1u) width += p.d_emb;
    if (width != p.K[l] || p.Kp[l] < p.K[l] || p.Np[l] < N) return (int)cudaErrorInvalidValue;
    if (p.woff[l] % 4) return (int)cudaErrorInvalidValue;
    if (l + 1 < p.n_layers) {
      if (p.Kp[l] % kKC || p.Np[l] % 32 || p.Np[l] > kMaxCols) return (int)cudaErrorInvalidValue;
      p.slab0[l + 1] = p.slab0[l] + p.Kp[l] / kKC;
      ldx = ldx > p.Np[l] ? ldx : p.Np[l];
    }
    ldx = ldx > p.Kp[l] ? ldx : p.Kp[l];
    width = N;
  }
  p.ldx = (ldx + 31) / 32 * 32 + 4;
  if (rows == 64) return launch<64>(pts, out, n, W, B, p, (cudaStream_t)stream);
  if (rows == 32) return launch<32>(pts, out, n, W, B, p, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
