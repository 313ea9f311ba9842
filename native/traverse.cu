// BVH traversal on the GPU: closest-hit and any-hit, one thread per ray.
//
// The semantics are those of snail/ops/traverse_ref.py, step for step,
// so the two agree up to floating-point contraction:
//   - pop a node, slab-test it against the ray's current best distance;
//   - a leaf tests its triangles in order (single-sided Moller rule for
//     shadows, both sides for closest hit);
//   - an inner node pushes far then near, near = child + (first_node ^ sign)
//     with sign = (dir[axis] < 0);
//   - misses report BIG, masked rays (tmax < 0) report -BIG;
//   - any-hit stops a ray at its first occluder.
//
// Layout (packed by snail/ops/traverse_cuda.py inside the jitted call):
//   nodes f32[N, 8]  = lo.xyz, child (int bits) | hi.xyz, meta (int bits)
//                      meta = count << 3 | first_node << 2 | axis
//   tris  f32[T, 12] = a.xyz, 0 | ba.xyz, 0 | ca.xyz, 0
// Node rows (32 B) and triangle rows (48 B) are read as float4 through the
// read-only path; the reads are data-dependent, so they are left to L1/L2
// and nothing is staged in shared memory. The per-ray stack lives in local
// memory (it is indexed dynamically).
//
// Build: snail/ops/traverse_cuda.py (nvcc for sm_90a, -fmad=false).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackCap = 66;   // traverse_ref.STACK_CAP
constexpr float kBig = 3.4e37f; // core/vecmath.BIG
constexpr int kBlock = 128;

struct RayIn {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ RayIn load_ray(const float* __restrict__ orig,
                                          int orig_stride,
                                          const float* __restrict__ dirn,
                                          int64_t i) {
  RayIn r;
  const float* o = orig + i * orig_stride;
  r.ox = o[0];
  r.oy = o[1];
  r.oz = o[2];
  r.dx = dirn[3 * i + 0];
  r.dy = dirn[3 * i + 1];
  r.dz = dirn[3 * i + 2];
  // SafeInv, as traverse_ref: 1 / (d + 1e-8)
  r.ix = 1.0f / (r.dx + 1e-8f);
  r.iy = 1.0f / (r.dy + 1e-8f);
  r.iz = 1.0f / (r.dz + 1e-8f);
  return r;
}

// Slab test; returns whether the ray's segment [0, limit) meets the box.
__device__ __forceinline__ bool box_hit(const RayIn& r, float4 lo, float4 hi,
                                        float limit) {
  float t1x = (lo.x - r.ox) * r.ix, t2x = (hi.x - r.ox) * r.ix;
  float t1y = (lo.y - r.oy) * r.iy, t2y = (hi.y - r.oy) * r.iy;
  float t1z = (lo.z - r.oz) * r.iz, t2z = (hi.z - r.oz) * r.iz;
  float tnear = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                      fminf(t1z, t2z));
  float tfar = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                     fmaxf(t1z, t2z));
  return (tnear <= tfar) && (tfar > 0.0f) && (tnear < limit);
}

// Moller terms of traverse_ref: det = d.n, u = d.(t x ca), v = d.(ba x t),
// tmul = -(t.n) with n = ba x ca and t = o - a.
struct TriTerms {
  float det, u, v, tmul;
};

__device__ __forceinline__ TriTerms tri_terms(const RayIn& r,
                                              const float4* __restrict__ tris,
                                              int tid) {
  const float4* p = tris + 3 * static_cast<int64_t>(tid);
  float4 a = __ldg(p), ba = __ldg(p + 1), ca = __ldg(p + 2);
  float nx = ba.y * ca.z - ba.z * ca.y;
  float ny = ba.z * ca.x - ba.x * ca.z;
  float nz = ba.x * ca.y - ba.y * ca.x;
  float tx = r.ox - a.x, ty = r.oy - a.y, tz = r.oz - a.z;
  // t x ca and ba x t
  float qx = ty * ca.z - tz * ca.y;
  float qy = tz * ca.x - tx * ca.z;
  float qz = tx * ca.y - ty * ca.x;
  float px = ba.y * tz - ba.z * ty;
  float py = ba.z * tx - ba.x * tz;
  float pz = ba.x * ty - ba.y * tx;
  TriTerms t;
  t.det = r.dx * nx + r.dy * ny + r.dz * nz;
  t.u = r.dx * qx + r.dy * qy + r.dz * qz;
  t.v = r.dx * px + r.dy * py + r.dz * pz;
  t.tmul = -(tx * nx + ty * ny + tz * nz);
  return t;
}

__device__ __forceinline__ void push_children(const RayIn& r, int child,
                                              int meta, int* stack,
                                              int& ptr) {
  int axis = meta & 3;
  float dax = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  int fn = ((meta >> 2) & 1) ^ (dax < 0.0f ? 1 : 0);
  int p0 = min(ptr, kStackCap - 2);
  stack[p0] = child + (1 - fn);  // far
  stack[p0 + 1] = child + fn;    // near, popped first
  ptr = p0 + 2;
}

__global__ void __launch_bounds__(kBlock)
    closest_kernel(const float4* __restrict__ nodes,
                   const float4* __restrict__ tris,
                   const float* __restrict__ orig, int orig_stride,
                   const float* __restrict__ dirn,
                   const float* __restrict__ tmax, int64_t n,
                   float* __restrict__ out_dist, int* __restrict__ out_tri,
                   float2* __restrict__ out_bary) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RayIn r = load_ray(orig, orig_stride, dirn, i);
  float tm = tmax[i];
  bool active = tm >= 0.0f;
  float init = fminf(tm, kBig);
  float best = active ? init : -kBig;
  int tri = 0;
  float bu = 0.0f, bv = 0.0f;

  int stack[kStackCap];
  int ptr = 0;
  if (active) stack[ptr++] = 0;
  while (ptr > 0) {
    int node = stack[--ptr];
    float4 lo = __ldg(nodes + 2 * static_cast<int64_t>(node));
    float4 hi = __ldg(nodes + 2 * static_cast<int64_t>(node) + 1);
    if (!box_hit(r, lo, hi, best)) continue;
    int child = __float_as_int(lo.w);
    int meta = __float_as_int(hi.w);
    int cnt = meta >> 3;
    if (cnt > 0) {
      for (int k = 0; k < cnt; ++k) {
        TriTerms t = tri_terms(r, tris, child + k);
        float duv = t.det - t.u - t.v;
        bool side = (fmaxf(t.u, fmaxf(t.v, duv)) <= 0.0f) ||
                    (fminf(t.u, fminf(t.v, duv)) >= 0.0f);
        float idet = 1.0f / (t.det == 0.0f ? 1e-30f : t.det);
        float dist = t.tmul * idet;
        if (side && t.det != 0.0f && dist > 0.0f && dist < best) {
          best = dist;
          tri = child + k;
          bu = t.u * idet;
          bv = t.v * idet;
        }
      }
    } else {
      push_children(r, child, meta, stack, ptr);
    }
  }
  out_dist[i] = active ? (best < init ? best : kBig) : -kBig;
  out_tri[i] = tri;
  out_bary[i] = make_float2(bu, bv);
}

__global__ void __launch_bounds__(kBlock)
    any_kernel(const float4* __restrict__ nodes,
               const float4* __restrict__ tris,
               const float* __restrict__ orig, int orig_stride,
               const float* __restrict__ dirn,
               const float* __restrict__ tmax, int64_t n,
               bool* __restrict__ out_blocked) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RayIn r = load_ray(orig, orig_stride, dirn, i);
  float tm = tmax[i];
  bool blocked = false;

  int stack[kStackCap];
  int ptr = 0;
  if (tm >= 0.0f) stack[ptr++] = 0;
  while (ptr > 0 && !blocked) {
    int node = stack[--ptr];
    float4 lo = __ldg(nodes + 2 * static_cast<int64_t>(node));
    float4 hi = __ldg(nodes + 2 * static_cast<int64_t>(node) + 1);
    if (!box_hit(r, lo, hi, tm)) continue;
    int child = __float_as_int(lo.w);
    int meta = __float_as_int(hi.w);
    int cnt = meta >> 3;
    if (cnt > 0) {
      for (int k = 0; k < cnt && !blocked; ++k) {
        TriTerms t = tri_terms(r, tris, child + k);
        blocked = (fminf(t.u, t.v) >= 0.0f) && (t.u + t.v <= t.det) &&
                  (t.tmul > 0.0f) && (t.tmul < tm * t.det);
      }
    } else {
      push_children(r, child, meta, stack, ptr);
    }
  }
  out_blocked[i] = blocked;
}

// Shared checks of the operand shapes; returns the origin stride (3 for
// one origin per ray, 0 for one origin shared by all rays).
ffi::Error check_operands(const ffi::Buffer<ffi::F32>& nodes,
                          const ffi::Buffer<ffi::F32>& tris,
                          const ffi::Buffer<ffi::F32>& orig,
                          const ffi::Buffer<ffi::F32>& dirn, int64_t n,
                          int* orig_stride) {
  if (nodes.element_count() == 0 || nodes.element_count() % 8 != 0)
    return ffi::Error::InvalidArgument("nodes must be f32[N, 8], N > 0");
  if (tris.element_count() % 12 != 0)
    return ffi::Error::InvalidArgument("tris must be f32[T, 12]");
  if (static_cast<int64_t>(dirn.element_count()) != 3 * n)
    return ffi::Error::InvalidArgument("dirn must be f32[R, 3]");
  if (static_cast<int64_t>(orig.element_count()) == 3 * n)
    *orig_stride = 3;
  else if (orig.element_count() == 3)
    *orig_stride = 0;
  else
    return ffi::Error::InvalidArgument("orig must be f32[R, 3] or f32[3]");
  return ffi::Error::Success();
}

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("traversal launch failed: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error ClosestHitImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                          ffi::Buffer<ffi::F32> tris,
                          ffi::Buffer<ffi::F32> orig,
                          ffi::Buffer<ffi::F32> dirn,
                          ffi::Buffer<ffi::F32> tmax,
                          ffi::ResultBuffer<ffi::F32> dist,
                          ffi::ResultBuffer<ffi::S32> tri,
                          ffi::ResultBuffer<ffi::F32> bary) {
  const int64_t n = tmax.element_count();
  int orig_stride = 3;
  ffi::Error e = check_operands(nodes, tris, orig, dirn, n, &orig_stride);
  if (e.failure()) return e;
  if (n == 0) return ffi::Error::Success();
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  closest_kernel<<<blocks, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), orig.typed_data(),
      orig_stride, dirn.typed_data(), tmax.typed_data(), n,
      dist->typed_data(), tri->typed_data(),
      reinterpret_cast<float2*>(bary->typed_data()));
  return launch_status();
}

ffi::Error AnyHitImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                      ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> orig,
                      ffi::Buffer<ffi::F32> dirn, ffi::Buffer<ffi::F32> tmax,
                      ffi::ResultBuffer<ffi::PRED> blocked) {
  const int64_t n = tmax.element_count();
  int orig_stride = 3;
  ffi::Error e = check_operands(nodes, tris, orig, dirn, n, &orig_stride);
  if (e.failure()) return e;
  if (n == 0) return ffi::Error::Success();
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  any_kernel<<<blocks, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), orig.typed_data(),
      orig_stride, dirn.typed_data(), tmax.typed_data(), n,
      blocked->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SnailClosestHit, ClosestHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // orig
                                  .Arg<ffi::Buffer<ffi::F32>>()  // dirn
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmax
                                  .Ret<ffi::Buffer<ffi::F32>>()  // dist
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()  // bary
);

XLA_FFI_DEFINE_HANDLER_SYMBOL(SnailAnyHit, AnyHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()   // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()   // orig
                                  .Arg<ffi::Buffer<ffi::F32>>()   // dirn
                                  .Arg<ffi::Buffer<ffi::F32>>()   // tmax
                                  .Ret<ffi::Buffer<ffi::PRED>>()  // blocked
);
