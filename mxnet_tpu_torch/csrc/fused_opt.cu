// Fused optimizer updates (K2): SGD with momentum and Adam, sm_90a.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_sgd_mom_kernel` and
// `_adam_kernel` (both launched by `_fused_opt_call`, exposed as
// `fused_sgd_mom` and `fused_adam`, reached from the update ops
// `sgd_mom_update` / `adam_update` of ops/optimizer_ops.py).
//
// sgd_mom, per element:
//   g    = clip(rescale * grad)                (clip < 0: no clip)
//   mom' = mu * mom - lr*wd * w - lr * g
//   w'   = w + mom'
// adam, per element (no bias correction: the caller folds it into lr):
//   g    = clip(rescale * grad + wd * w)
//   m'   = b1 * m + (1 - b1) * g
//   v'   = b2 * v + (1 - b2) * g * g
//   w'   = w - lr * m' / (sqrt(v') + eps)
//
// Numerics: bitwise equal to the plain versions (`sgd_mom_plain`,
// `adam_plain` in ops/fused_opt.py), which are bitwise equal to the JAX
// package's jitted `sgd_mom_update` / `adam_update` on the CPU. That
// program is what XLA makes of the jnp formulas: constant hyperparameters
// folded (lr * rescale into one f32 factor when there is no clip; a
// multiply by a factor of exactly 1 dropped), and the first remaining
// product of each sum or difference contracted with it into one fused
// multiply-add (measured bitwise on the CPU; see ops/fused_opt.py). Every
// product, sum, FMA, square root and quotient here is an explicit nearest
// intrinsic (__fmul_rn, __fadd_rn, __fmaf_rn, __fsqrt_rn, __fdiv_rn), so
// ptxas can neither contract nor reassociate any of them; the host passes
// the folded factors, already rounded to f32 where XLA rounds them.
//
// Bound on this card: device-memory bytes. SGD-momentum reads w, g, mom and
// writes w', mom' (20 B per element); Adam reads w, g, m, v and writes w',
// m', v' (28 B per element); both do a dozen flops per element, far under
// the 67 TFLOP/s fp32 rate. At 3.35 TB/s the 25,557,032 values of
// ResNet-50 v1 take at least 0.153 ms per SGD-momentum step and 0.214 ms
// per Adam step.
//
// Design against that bound:
//  - a grid-stride loop over the flat arrays; each step of a thread loads
//    four values of every input as one 16-byte float4 and stores four of
//    every output the same way, so each warp moves 512 contiguous bytes
//    per array per step, fully coalesced;
//  - a scalar tail loop for the last n % 4 elements (and a scalar-only
//    launch when a pointer is not 16-byte aligned), so any size runs: the
//    TPU kernel needed rows of 128 and at least 1024 elements, so BN's
//    64-value gamma took the jnp fallback there; here every tensor takes
//    the kernel;
//  - updates may run in place (w' over w, mom' over mom): each thread reads
//    its elements before it writes them and no pointer is __restrict__;
//  - the hyperparameters are f32 kernel arguments, so a launch needs no
//    device scalar and the wrapper never syncs the host.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

struct SgdMomArgs {
  float mu;       // momentum
  float lr_wd;    // f32(lr * wd), the product taken on the host in f64
  float lr_g;     // f32(lr) with a clip; f32(f32(lr) * f32(rescale)) without
  float rescale;  // f32(rescale), applied before the clip only
  float clip;     // < 0: no clip
  int mu_is_one;  // XLA drops a multiply by 1: mom - lr*wd*w contracts
};

struct AdamArgs {
  float lr, b1, c1, b2, c2, eps, wd, rescale, clip;  // c1 = f32(1 - b1) ...
  int rescale_is_one;  // XLA drops a multiply by 1: g = fma(w, wd, grad)
};

// jnp.clip(x, -c, c); a NaN passes through as it does in the plain version
__device__ __forceinline__ float clip_to(float x, float c) {
  return x < -c ? -c : (x > c ? c : x);
}

__device__ __forceinline__ void sgd_mom_one(float w, float g, float m,
                                            const SgdMomArgs& a, float* w_out,
                                            float* m_out) {
  if (a.clip >= 0.0f) g = clip_to(__fmul_rn(g, a.rescale), a.clip);
  const float inner = a.mu_is_one ? __fmaf_rn(-w, a.lr_wd, m)
                                  : __fmaf_rn(m, a.mu, -__fmul_rn(w, a.lr_wd));
  const float mom = __fmaf_rn(-g, a.lr_g, inner);
  *m_out = mom;
  *w_out = __fadd_rn(w, mom);
}

__device__ __forceinline__ void adam_one(float w, float g, float m, float v,
                                         const AdamArgs& a, float* w_out,
                                         float* m_out, float* v_out) {
  g = a.rescale_is_one ? __fmaf_rn(w, a.wd, g)
                       : __fmaf_rn(g, a.rescale, __fmul_rn(w, a.wd));
  if (a.clip >= 0.0f) g = clip_to(g, a.clip);
  const float mean = __fmaf_rn(m, a.b1, __fmul_rn(g, a.c1));
  const float var = __fmaf_rn(v, a.b2, __fmul_rn(__fmul_rn(g, g), a.c2));
  *m_out = mean;
  *v_out = var;
  *w_out = __fsub_rn(w, __fdiv_rn(__fmul_rn(mean, a.lr),
                                  __fadd_rn(__fsqrt_rn(var), a.eps)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    sgd_mom(const float* w, const float* g, const float* mom, float* w_out,
            float* mom_out, int64_t n, SgdMomArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = kVec ? n / 4 : 0;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 w4 = reinterpret_cast<const float4*>(w)[i];
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    const float4 m4 = reinterpret_cast<const float4*>(mom)[i];
    float4 ow, om;
    sgd_mom_one(w4.x, g4.x, m4.x, a, &ow.x, &om.x);
    sgd_mom_one(w4.y, g4.y, m4.y, a, &ow.y, &om.y);
    sgd_mom_one(w4.z, g4.z, m4.z, a, &ow.z, &om.z);
    sgd_mom_one(w4.w, g4.w, m4.w, a, &ow.w, &om.w);
    reinterpret_cast<float4*>(w_out)[i] = ow;
    reinterpret_cast<float4*>(mom_out)[i] = om;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    sgd_mom_one(w[i], g[i], mom[i], a, w_out + i, mom_out + i);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    adam(const float* w, const float* g, const float* mean, const float* var,
         float* w_out, float* mean_out, float* var_out, int64_t n,
         AdamArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = kVec ? n / 4 : 0;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 w4 = reinterpret_cast<const float4*>(w)[i];
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    const float4 m4 = reinterpret_cast<const float4*>(mean)[i];
    const float4 v4 = reinterpret_cast<const float4*>(var)[i];
    float4 ow, om, ov;
    adam_one(w4.x, g4.x, m4.x, v4.x, a, &ow.x, &om.x, &ov.x);
    adam_one(w4.y, g4.y, m4.y, v4.y, a, &ow.y, &om.y, &ov.y);
    adam_one(w4.z, g4.z, m4.z, v4.z, a, &ow.z, &om.z, &ov.z);
    adam_one(w4.w, g4.w, m4.w, v4.w, a, &ow.w, &om.w, &ov.w);
    reinterpret_cast<float4*>(w_out)[i] = ow;
    reinterpret_cast<float4*>(mean_out)[i] = om;
    reinterpret_cast<float4*>(var_out)[i] = ov;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    adam_one(w[i], g[i], mean[i], var[i], a, w_out + i, mean_out + i,
             var_out + i);
  }
}

unsigned grid_for(int64_t n, bool vec) {
  int64_t blocks = ((vec ? n / 4 : n) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

}  // namespace

// All arrays: n contiguous float32 on `device`; outputs may alias the
// corresponding inputs. Returns the CUDA error of the launch (0 on success).
extern "C" int mxt_sgd_mom(const float* w, const float* g, const float* mom,
                           float* w_out, float* mom_out, int64_t n, float mu,
                           float lr_wd, float lr_g, float rescale, float clip,
                           int mu_is_one, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const SgdMomArgs a{mu, lr_wd, lr_g, rescale, clip, mu_is_one};
  const bool vec = aligned16({w, g, mom, w_out, mom_out});
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    sgd_mom<true><<<grid_for(n, true), kThreads, 0, s>>>(w, g, mom, w_out,
                                                         mom_out, n, a);
  } else {
    sgd_mom<false><<<grid_for(n, false), kThreads, 0, s>>>(w, g, mom, w_out,
                                                           mom_out, n, a);
  }
  return cudaGetLastError();
}

extern "C" int mxt_adam(const float* w, const float* g, const float* mean,
                        const float* var, float* w_out, float* mean_out,
                        float* var_out, int64_t n, float lr, float b1,
                        float c1, float b2, float c2, float eps, float wd,
                        float rescale, int rescale_is_one, float clip,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const AdamArgs a{lr, b1, c1, b2, c2, eps, wd, rescale, clip,
                   rescale_is_one};
  const bool vec = aligned16({w, g, mean, var, w_out, mean_out, var_out});
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    adam<true><<<grid_for(n, true), kThreads, 0, s>>>(
        w, g, mean, var, w_out, mean_out, var_out, n, a);
  } else {
    adam<false><<<grid_for(n, false), kThreads, 0, s>>>(
        w, g, mean, var, w_out, mean_out, var_out, n, a);
  }
  return cudaGetLastError();
}
