// Blockwise (flash) attention forward, fp32, sm_90a.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_flash_kernel` (launched by
// `_flash_call`, exposed as `flash_attention`), forward only.
//
// out[b, h] = softmax(scale * Q K^T [causal]) V for Q (Tq, D) and K, V
// (Tk, D), without writing the (Tq, Tk) score matrix to device memory.
//
// Bound on this card: arithmetic. Q, K, V and O are read or written once
// (4 * T * D * 4 bytes per head) while the two products do 4 * Tq * Tk * D
// flops (about half of that when causal), i.e. T/4 flops per byte: at the
// prompt lengths of the serving path (16..512) that is 4..128 flops per
// byte, above the fp32 balance of ~20 from T = 80 on. This kernel uses the
// fp32 FMA pipes (67 TFLOP/s peak), no tensor cores; wgmma/TMA is later
// work.
//
// Design:
//  - one CTA of 256 threads per (64-row Q tile, head, batch); the TPU grid
//    runs programs in sequence, here tiles run in parallel and the K/V walk
//    is a loop inside the CTA;
//  - 64-row K and V tiles are staged through shared memory (rows padded by
//    one float so a column walk hits 32 distinct banks) and zero-filled past
//    Tk, so any T works: the TPU kernel needs T % block == 0;
//  - each thread owns a 4x4 micro-tile of the 64x64 score tile (rows
//    ty + 16i, keys tx + 16j) and 4 x D/16 outputs, so every shared-memory
//    load feeds 2 FMAs;
//  - online softmax per row in fp32 (row max and sum reduced over the 16
//    threads of a half-warp by shuffles); NEG_INF is -1e30 as in the TPU
//    kernel, so a fully masked row never computes -inf - -inf;
//  - causal: K tiles strictly above the diagonal are skipped (Tq == Tk).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int Tq, int Tk,
                           int64_t q_sb, int64_t q_sh, int64_t q_st,
                           int64_t k_sb, int64_t k_sh, int64_t k_st,
                           int64_t v_sb, int64_t v_sh, int64_t v_st,
                           int64_t o_sb, int64_t o_sh, int64_t o_st,
                           float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * D;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kBQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float* obase = o + b * o_sb + h * o_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, t = q0 + r;
    sQ[r * DP + c] = t < Tq ? qb[t * q_st + c] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk_all = (Tk + kBK - 1) / kBK;
  const int nk = causal ? min(qt + 1, nk_all) : nk_all;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, t = k0 + r;
      const bool in = t < Tk;
      sK[r * DP + c] = in ? kb[t * k_st + c] : 0.f;
      sV[r * D + c] = in ? vb[t * v_st + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Tk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[row * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < Tq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        obase[t * o_st + tx + 16 * c] = acc[i][c] * inv;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int Tq, int Tk, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o: (B, H, T, D) fp32 with element strides (batch, head, token) in
// `strides` = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb,
// o_sh, o_st} and unit stride along D. Causal needs Tq == Tk (checked by the
// caller). Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported head size.
extern "C" int mxt_flash_attention_f32(const float* q, const float* k,
                                       const float* v, float* o, int B, int H,
                                       int Tq, int Tk, int D,
                                       const int64_t* strides, float scale,
                                       int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, Tq, Tk, strides, scale, causal, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, Tq, Tk, strides, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, Tq, Tk, strides, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, Tq, Tk, strides, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
