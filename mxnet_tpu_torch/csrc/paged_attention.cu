// Paged single-query attention for the decode step, fp32, sm_90a.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_paged_kernel` (launched by
// `_paged_call`, exposed as `paged_attention`).
//
// out[b, h, :] = softmax_{t < seq_len[b]}(scale * q[b, h] . K[t, h]) V[t, h]
// where token t of sequence b lives in pool block tables[b, t / BT] at
// slot t % BT of k_cache/v_cache (num_blocks, BT, H, D).
//
// Bound on this card: device-memory bytes. Each (sequence, head) reads its
// live K and V rows once (D*4 bytes each per token) and does 4*D flops per
// token, a quarter of a flop per byte, far below the H100's ~20 fp32
// flops/byte balance. The least time is the live K/V bytes of the step over
// 3.35 TB/s.
//
// Design against that bound:
//  - one CTA per (sequence, head); the CTA reads its own block ids from the
//    table in device memory (the TPU kernel's scalar prefetch) and walks only
//    the ceil(seq_len / BT) live blocks, not the table's full width;
//  - each warp takes U tokens at a time and issues all 2*U row loads before
//    it reduces any of them, so every warp keeps U K rows and U V rows in
//    flight; a lane holds D/32 consecutive floats of a row, so a row load is
//    one coalesced D*4-byte transaction;
//  - online softmax in fp32 per warp, then the warps' (max, sum, acc)
//    partials merge through shared memory. NEG_INF is -1e30 as in the TPU
//    kernel: -inf - -inf would be NaN;
//  - a row with seq_len 0 (batch padding) writes zeros.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kUnroll = 4;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* r) { r[0] = __ldg(p); }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* r) {
    float2 x = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = x.x;
    r[1] = x.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* r) {
    float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  }
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const float* __restrict__ q, int64_t q_sb,
                           int64_t q_sh, const float* __restrict__ kc,
                           const float* __restrict__ vc,
                           const int* __restrict__ tables,
                           const int* __restrict__ seq_lens,
                           float* __restrict__ out, int H, int NB, int BT,
                           int W, float scale) {
  constexpr int V = D / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ob = out + (static_cast<int64_t>(b) * H + h) * D;

  int len = seq_lens[b];
  len = min(len, W * BT);  // positions past the table do not exist
  if (len <= 0) {
    for (int d = threadIdx.x; d < D; d += kWarps * 32) ob[d] = 0.f;
    return;
  }

  float qv[V];
  const float* qp = q + b * q_sb + h * q_sh + lane * V;
#pragma unroll
  for (int i = 0; i < V; ++i) qv[i] = qp[i] * scale;

  const int* trow = tables + static_cast<int64_t>(b) * W;
  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  const int64_t head_off = static_cast<int64_t>(h) * D + lane * V;

  float m = kNegInf, l = 0.f, acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float kr[kUnroll][V], vr[kUnroll][V];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      live[u] = t < len;
      const int tc = live[u] ? t : t0;  // t0 < len: always a real token
      int blk = __ldg(trow + tc / BT);
      blk = min(max(blk, 0), NB - 1);  // never read outside the pool
      const int64_t off =
          (static_cast<int64_t>(blk) * BT + tc % BT) * tok_stride + head_off;
      Vec<V>::load(kc + off, kr[u]);
      Vec<V>::load(vc + off, vr[u]);
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) x = fmaf(qv[i], kr[u][i], x);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      s[u] = live[u] ? x : kNegInf;
    }
    float mx = s[0];
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, s[u]);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float p[kUnroll], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = expf(s[u] - m_new);
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vr[u][i], a);
      acc[i] = a;
    }
    m = m_new;
  }

  __shared__ float sm[kWarps], sl[kWarps], sacc[kWarps][D];
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sacc[warp][lane * V + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float M = sm[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sm[w]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w] - M);  // an idle warp has l = acc = 0
      L = fmaf(sl[w], f, L);
      a = fmaf(sacc[w][d], f, a);
    }
    ob[d] = a / fmaxf(L, 1e-30f);
  }
}

template <int D>
cudaError_t launch(const float* q, int64_t q_sb, int64_t q_sh,
                   const float* kc, const float* vc, const int* tables,
                   const int* seq_lens, float* out, int B, int H, int NB,
                   int BT, int W, float scale, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_attention_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      q, q_sb, q_sh, kc, vc, tables, seq_lens, out, H, NB, BT, W, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, D) with strides (q_sb, q_sh, 1) in elements; k_cache/v_cache:
// (NB, BT, H, D) contiguous and 16-byte aligned; tables: (B, W) int32;
// seq_lens: (B,) int32; out: (B, H, D) contiguous. Returns the CUDA error
// of the launch (0 on success), or cudaErrorInvalidValue for an unsupported
// head size.
extern "C" int mxt_paged_attention_f32(const float* q, int64_t q_sb,
                                       int64_t q_sh, const float* k_cache,
                                       const float* v_cache,
                                       const int* tables, const int* seq_lens,
                                       float* out, int B, int H, int D, int NB,
                                       int BT, int W, float scale, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens,
                        out, B, H, NB, BT, W, scale, s);
    case 64:
      return launch<64>(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens,
                        out, B, H, NB, BT, W, scale, s);
    case 128:
      return launch<128>(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens,
                         out, B, H, NB, BT, W, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
