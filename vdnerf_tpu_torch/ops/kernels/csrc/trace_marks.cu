// Device marks of the program's spans (vdnerf_tpu_torch/utils/trace.py).
//
// One empty one-thread kernel per span edge and per backward point, each
// named after what it marks, so that a profiler's device trace says where a
// span began and ended on the device's own clock, and a reader needs only
// the kernels' names: vdn_mark_begin_<span>, vdn_mark_end_<span> and
// vdn_mark_at_<point>, each '.' of the name written as "__". extern "C"
// keeps the names unmangled. A mark does no work; launched into a stream it
// runs when the work before it has run, and captured into a CUDA graph it is
// a node of the graph.
//
// The lists below are trace.SPANS and trace.POINTS, in their order (a test
// holds them equal); a mark is launched by its list and its index.

#include <cuda_runtime.h>

#define VDN_SPANS(X)                                                          \
  X(step) X(step__loss) X(step__backward) X(step__allreduce) X(step__adam)    \
  X(render__rays) X(render__ladder) X(render__nerf) X(render__sdf)            \
  X(render__depth_head) X(render__colour_head) X(render__composite)           \
  X(serve__frame) X(serve__rays) X(serve__chunk) X(serve__outputs)            \
  X(serve__to_host)                                                           \
  X(data__sample) X(data__gather_feats)                                       \
  X(dispatch__upload) X(dispatch__replay) X(dispatch__eager)                  \
  X(dispatch__capture) X(dispatch__read)                                      \
  X(setup__scene) X(setup__features) X(setup__model) X(setup__optimizer)      \
  X(build__nvcc) X(build__load)                                               \
  X(mesh__grid) X(mesh__to_host) X(mesh__marching) X(mesh__ply)

#define VDN_POINTS(X) \
  X(bwd__colour_head) X(bwd__depth_head) X(bwd__sdf) X(bwd__nerf)

#define VDN_BEGIN(n) extern "C" __global__ void vdn_mark_begin_##n() {}
#define VDN_END(n) extern "C" __global__ void vdn_mark_end_##n() {}
#define VDN_AT(n) extern "C" __global__ void vdn_mark_at_##n() {}
VDN_SPANS(VDN_BEGIN)
VDN_SPANS(VDN_END)
VDN_POINTS(VDN_AT)

#define VDN_BEGIN_PTR(n) reinterpret_cast<const void*>(&vdn_mark_begin_##n),
#define VDN_END_PTR(n) reinterpret_cast<const void*>(&vdn_mark_end_##n),
#define VDN_AT_PTR(n) reinterpret_cast<const void*>(&vdn_mark_at_##n),
static const void* const kBegin[] = {VDN_SPANS(VDN_BEGIN_PTR)};
static const void* const kEnd[] = {VDN_SPANS(VDN_END_PTR)};
static const void* const kAt[] = {VDN_POINTS(VDN_AT_PTR)};
static const int kSpans = sizeof(kBegin) / sizeof(kBegin[0]);
static const int kPoints = sizeof(kAt) / sizeof(kAt[0]);

static const void* mark_fn(int kind, int id) {
  if (kind == 0 && id >= 0 && id < kSpans) return kBegin[id];
  if (kind == 1 && id >= 0 && id < kSpans) return kEnd[id];
  if (kind == 2 && id >= 0 && id < kPoints) return kAt[id];
  return nullptr;
}

// The number of spans (kind 0 and 1) or points (kind 2).
extern "C" int vdn_mark_count(int kind) { return kind == 2 ? kPoints : kSpans; }

// Loads every mark's module now (CUDA loads a module at its first use), so
// that no first launch happens inside a graph capture.
extern "C" int vdn_mark_prepare() {
  cudaFuncAttributes attr;
  for (int kind = 0; kind < 3; ++kind) {
    for (int id = 0; id < vdn_mark_count(kind); ++id) {
      cudaError_t err = cudaFuncGetAttributes(&attr, mark_fn(kind, id));
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// One mark on `stream`: kind 0 a span's begin, 1 its end, 2 a point.
extern "C" int vdn_mark_launch(int kind, int id, void* stream) {
  const void* fn = mark_fn(kind, id);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(fn, dim3(1), dim3(1), nullptr, 0,
                               static_cast<cudaStream_t>(stream));
}
