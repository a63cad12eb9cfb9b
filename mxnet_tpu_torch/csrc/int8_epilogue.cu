// INT8 requantize epilogue of a quantized convolution, sm_90a.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_int8_epilogue_kernel`
// (launched by `_int8_epilogue_call`, exposed as `int8_conv_epilogue` and,
// with its range bookkeeping, `quantized_conv_epilogue`).
//
// out[i] = clip(rint(f32(acc[i]) * in_scale * out_scale), -127, 127) as int8,
// then max(out[i], 0) when relu, over every element of an int32 tensor of
// any size. in_scale is one int32 step in real units, out_scale 127 over the
// calibrated output range (requantize-inl.h's convention).
//
// Numerics: bitwise equal to the plain version (`int8_conv_epilogue_plain`
// in ops/int8.py) and to the JAX reference. The two products round to f32
// one at a time and in the reference's order (__fmul_rn, so no FMA or
// reassociation can change them), rintf rounds half to even as jnp.rint
// does, and the clamp and relu act on integral values.
//
// Bound on this card: device-memory bytes. Each element reads 4 bytes and
// writes 1 and costs a handful of instructions, so the least time is
// 5 bytes per element over 3.35 TB/s (0.15 ms for the largest ResNet-50
// accumulator at batch 128, 102,760,448 elements).
//
// Design against that bound:
//  - a grid-stride loop over the flat array; each step of a thread loads
//    four accumulators as one 16-byte int4 and stores four results as one
//    4-byte char4, so a warp moves 512 contiguous bytes in and 128 out per
//    step, fully coalesced;
//  - the elements past the last multiple of 4 take a scalar tail loop, so
//    any size works (the TPU kernel needed rows of 128; a card has no such
//    tiling);
//  - the two scales are read once per thread from device memory: they are
//    computed on the device from the weight ranges, so passing them by
//    pointer spares the host a synchronisation per launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ int8_t requant(int32_t a, float s_in, float s_out,
                                          bool relu) {
  float x = __fmul_rn(__fmul_rn(__int2float_rn(a), s_in), s_out);
  float q = fminf(fmaxf(rintf(x), -127.0f), 127.0f);
  if (relu) q = fmaxf(q, 0.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__global__ void __launch_bounds__(kThreads)
    int8_epilogue_kernel(const int32_t* __restrict__ acc,
                         int8_t* __restrict__ out, int64_t n,
                         const float* __restrict__ in_scale,
                         const float* __restrict__ out_scale, bool relu) {
  const float s_in = __ldg(in_scale);
  const float s_out = __ldg(out_scale);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = n / 4;
  const int4* acc4 = reinterpret_cast<const int4*>(acc);
  char4* out4 = reinterpret_cast<char4*>(out);
  for (int64_t i = first; i < n4; i += stride) {
    const int4 a = __ldg(acc4 + i);
    char4 q;
    q.x = requant(a.x, s_in, s_out, relu);
    q.y = requant(a.y, s_in, s_out, relu);
    q.z = requant(a.z, s_in, s_out, relu);
    q.w = requant(a.w, s_in, s_out, relu);
    out4[i] = q;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    out[i] = requant(__ldg(acc + i), s_in, s_out, relu);
  }
}

}  // namespace

// acc: n int32, contiguous and 16-byte aligned; out: n int8, 4-byte
// aligned; in_scale, out_scale: one float each in device memory. Returns
// the CUDA error of the launch (0 on success).
extern "C" int mxt_int8_epilogue(const int32_t* acc, int8_t* out, int64_t n,
                                 const float* in_scale,
                                 const float* out_scale, int relu, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  int8_epilogue_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      acc, out, n, in_scale, out_scale, relu != 0);
  return cudaGetLastError();
}
