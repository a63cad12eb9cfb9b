// Paged single-query attention for the decode step, f32 queries over f32 or
// bf16 caches, f32 out, sm_90a: split-KV
// (flash decoding), one kernel for the chunks and one to merge them.
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
// 3.35 TB/s (11.0 us for the 8,971 live tokens of the B 32 timing shape at
// H 8, D 64).
//
// Reaching it takes bytes in flight: about 25 KB per SM to cover HBM's
// latency at 3.35 TB/s. One CTA per (sequence, head) walking its whole
// sequence, as the TPU kernel's sequential grid does, keeps a few KB in
// flight and waits one round trip per few tokens: the longest sequence
// sets the time. So the sequence is split:
//  - `paged_attention_kernel`: grid (split, head, sequence), one CTA of 128
//    threads per 64-token chunk. The grid is sized from the table width W
//    (ceil(W * BT / 64) splits), never from seq_lens, which stays on the
//    device: a CTA whose chunk starts at or past its sequence's length
//    exits at once, and the merge never reads its slot. The CTA reads its
//    block ids from the table in device memory (the TPU kernel's scalar
//    prefetch), clamps them into the pool, and issues every K and V row of
//    its chunk as 16-byte cp.async copies before it waits for any (32 KB at
//    D 64; K and V in two commit groups, so the scores start while V is
//    still arriving). A token's block and slot come from its own position,
//    so chunk edges need not fall on block edges. At D 64 six CTAs fit on
//    an SM: some 190 KB in flight per SM.
//  - each CTA computes its chunk's scores (two threads per token, one
//    shuffle), the chunk's max m and sum l of exp(s - m), and acc[d] =
//    sum exp(s - m) v[d], and writes (m, l, acc) to scratch the wrapper
//    allocates (B, H, splits) x (2 + D floats);
//  - `paged_attention_merge_kernel`: grid (head, sequence), D threads,
//    combines the live splits' partials, out = sum acc_s e^(m_s - M) /
//    sum l_s e^(m_s - M). A row with seq_len 0 (batch padding) writes
//    zeros there.
// bf16 caches (`mxt_paged_attention_bf16`, the bf16 decoder's pool; the TPU
// kernel casts each block to f32): the same kernels templated on the cache
// type. A 16-byte cp.async carries 8 values, rows are padded by 16 bytes,
// scores read the K row as bf16 pairs converted to f32; q, the softmax,
// the accumulators, the scratch and the output stay f32. The cache bytes
// halve: at phase 5's B 32 with 9,536 live tokens the bound falls from
// 11.7 us to about 5.9 us (2 * 9,536 * 8 * 64 * 2 bytes over 3.35 TB/s).
//
// The merge costs one more launch per layer per decode step: the wrapper
// issues both from one C call, so the host pays one cudaLaunchKernel (some
// 2-3 us; 8 layers x 68 steps of the serving burst: about 1.5 ms of host
// time over a burst of ~15 s), and the device one small kernel (256 CTAs at
// B 32) behind the first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kChunk = 64;               // tokens per split CTA
constexpr int kWarps = kThreads / 32;

// f32 scratch first (q, p, reduction, accumulators), then the K and V
// chunks in the cache's type, rows padded by 16 bytes
template <int D>
__host__ __device__ constexpr int scratch_floats() {
  return D + kChunk + 2 * kWarps + kThreads;
}

template <int D, typename T>
constexpr int smem_bytes() {
  return scratch_floats<D>() * 4 +
         2 * kChunk * (D + 16 / sizeof(T)) * sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q . k over n values: fp32 cache rows four at a time, bf16 two at a time
template <int N>
__device__ __forceinline__ float dot(const float* kr, const float* qr) {
  float s = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  const float4* q4 = reinterpret_cast<const float4*>(qr);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 a = k4[j], x = q4[j];
    s = fmaf(a.x, x.x, s);
    s = fmaf(a.y, x.y, s);
    s = fmaf(a.z, x.z, s);
    s = fmaf(a.w, x.w, s);
  }
  return s;
}

template <int N>
__device__ __forceinline__ float dot(const __nv_bfloat16* kr,
                                     const float* qr) {
  float s = 0.f;
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(kr);
  const float2* q2 = reinterpret_cast<const float2*>(qr);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float2 a = __bfloat1622float2(k2[j]), x = q2[j];
    s = fmaf(a.x, x.x, s);
    s = fmaf(a.y, x.y, s);
  }
  return s;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const float* __restrict__ q, int64_t q_sb,
                           int64_t q_sh, const T* __restrict__ kc,
                           const T* __restrict__ vc,
                           const int* __restrict__ tables,
                           const int* __restrict__ seq_lens,
                           float* __restrict__ part_ml,
                           float* __restrict__ part_acc, int H, int NB,
                           int BT, int W, int S, float scale) {
  constexpr int E16 = 16 / sizeof(T);   // values per 16-byte copy
  constexpr int P = D + E16;             // padded row, in T
  constexpr int Q4 = D / E16;            // 16-byte copies per row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sP = sQ + D;
  float* sRed = sP + kChunk;             // [2][kWarps]
  float* sAcc = sRed + 2 * kWarps;       // [kThreads]
  T* sK = reinterpret_cast<T*>(smem + scratch_floats<D>());
  T* sV = sK + kChunk * P;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(seq_lens[b], W * BT);  // positions past the table do not exist
  const int t0 = split * kChunk;
  if (t0 >= len) return;                 // the merge reads only live splits
  const int n = min(kChunk, len - t0);

  const int* trow = tables + static_cast<int64_t>(b) * W;
  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  const int64_t head_off = static_cast<int64_t>(h) * D;
  // every row of the chunk in flight at once: K, then V
  for (int e = threadIdx.x; e < n * Q4; e += kThreads) {
    const int i = e / Q4, c = (e % Q4) * E16, tok = t0 + i;
    int blk = __ldg(trow + tok / BT);
    blk = min(max(blk, 0), NB - 1);       // never read outside the pool
    const int64_t off =
        (static_cast<int64_t>(blk) * BT + tok % BT) * tok_stride + head_off + c;
    cp16(sK + i * P + c, kc + off);
  }
  cp_commit();
  for (int e = threadIdx.x; e < n * Q4; e += kThreads) {
    const int i = e / Q4, c = (e % Q4) * E16, tok = t0 + i;
    int blk = __ldg(trow + tok / BT);
    blk = min(max(blk, 0), NB - 1);
    const int64_t off =
        (static_cast<int64_t>(blk) * BT + tok % BT) * tok_stride + head_off + c;
    cp16(sV + i * P + c, vc + off);
  }
  cp_commit();
  const float* qp = q + b * q_sb + h * q_sh;
  for (int d = threadIdx.x; d < D; d += kThreads) sQ[d] = qp[d] * scale;
  cp_wait<1>();
  __syncthreads();

  // scores: two threads per token, half of D each
  const int i = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = dot<D / 2>(sK + i * P + half * (D / 2), sQ + half * (D / 2));
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  const bool live = i < n;
  s = live ? s : kNegInf;
  float mx = s;
#pragma unroll
  for (int off = 16; off > 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) sRed[warp] = mx;
  __syncthreads();
  float m = sRed[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sRed[w]);
  const float p = live ? expf(s - m) : 0.f;
  float ps = half == 0 ? p : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ps += __shfl_xor_sync(0xffffffffu, ps, off);
  if (lane == 0) sRed[kWarps + warp] = ps;
  if (half == 0) sP[i] = p;
  cp_wait<0>();
  __syncthreads();

  // acc[d] = sum_i p_i v_i[d]: D columns x (kThreads / D) token ranges
  constexpr int PARTS = kThreads / D;
  constexpr int PER = kChunk / PARTS;
  const int d = threadIdx.x % D, part = threadIdx.x / D;
  float a = 0.f;
  const int lo = part * PER, hi = min(lo + PER, n);
  for (int j = lo; j < hi; ++j) a = fmaf(sP[j], to_f32(sV[j * P + d]), a);
  const int64_t slot = (static_cast<int64_t>(b) * H + h) * S + split;
  if (PARTS > 1) {
    sAcc[threadIdx.x] = a;
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int r = 1; r < PARTS; ++r) a += sAcc[r * D + d];
    }
  }
  if (part == 0) part_acc[slot * D + d] = a;
  if (threadIdx.x == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += sRed[kWarps + w];
    part_ml[2 * slot] = m;
    part_ml[2 * slot + 1] = l;
  }
}

template <int D>
__global__ void __launch_bounds__(D)
    paged_attention_merge_kernel(const float* __restrict__ part_ml,
                                 const float* __restrict__ part_acc,
                                 const int* __restrict__ seq_lens,
                                 float* __restrict__ out, int H, int BT,
                                 int W, int S) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const int len = min(seq_lens[b], W * BT);
  if (len <= 0) {
    out[row * D + d] = 0.f;
    return;
  }
  const int ns = (len + kChunk - 1) / kChunk;
  const float* ml = part_ml + 2 * row * S;
  float M = ml[0];
  for (int s = 1; s < ns; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float f = expf(ml[2 * s] - M);
    L = fmaf(ml[2 * s + 1], f, L);
    A = fmaf(part_acc[(row * S + s) * D + d], f, A);
  }
  out[row * D + d] = A / fmaxf(L, 1e-30f);
}

template <int D, typename T>
cudaError_t launch(const float* q, int64_t q_sb, int64_t q_sh,
                   const T* kc, const T* vc, const int* tables,
                   const int* seq_lens, float* out, float* scratch, int B,
                   int H, int NB, int BT, int W, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, T>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int S = (W * BT + kChunk - 1) / kChunk;
  float* part_ml = scratch;
  float* part_acc = scratch + 2 * static_cast<int64_t>(B) * H * S;
  paged_attention_kernel<D, T><<<dim3(S, H, B), kThreads, smem, stream>>>(
      q, q_sb, q_sh, kc, vc, tables, seq_lens, part_ml, part_acc, H, NB, BT,
      W, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_merge_kernel<D><<<dim3(H, B), D, 0, stream>>>(
      part_ml, part_acc, seq_lens, out, H, BT, W, S);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const float* q, int64_t q_sb, int64_t q_sh, const T* k_cache,
             const T* v_cache, const int* tables, const int* seq_lens,
             float* out, float* scratch, int B, int H, int D, int NB, int BT,
             int W, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens,
                        out, scratch, B, H, NB, BT, W, scale, s);
    case 64:
      return launch<64>(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens,
                        out, scratch, B, H, NB, BT, W, scale, s);
    case 128:
      return launch<128>(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens,
                         out, scratch, B, H, NB, BT, W, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Tokens per split CTA: the wrapper sizes the scratch from it.
extern "C" int mxt_paged_attention_chunk() { return kChunk; }

// q: (B, H, D) f32 with strides (q_sb, q_sh, 1) in elements; k_cache/v_cache:
// (NB, BT, H, D) contiguous and 16-byte aligned, f32 (`_f32`) or bf16
// (`_bf16`, read into f32); tables: (B, W) int32; seq_lens: (B,) int32;
// out: (B, H, D) f32 contiguous; scratch: (B, H, S) x (2 + D) floats for
// S = ceil(W * BT / chunk). Returns the CUDA error of the launches (0 on
// success), or cudaErrorInvalidValue for an unsupported head size.
extern "C" int mxt_paged_attention_f32(const float* q, int64_t q_sb,
                                       int64_t q_sh, const float* k_cache,
                                       const float* v_cache,
                                       const int* tables, const int* seq_lens,
                                       float* out, float* scratch, int B,
                                       int H, int D, int NB, int BT, int W,
                                       float scale, int device,
                                       void* stream) {
  return dispatch(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens, out,
                  scratch, B, H, D, NB, BT, W, scale, device, stream);
}

extern "C" int mxt_paged_attention_bf16(const float* q, int64_t q_sb,
                                        int64_t q_sh,
                                        const __nv_bfloat16* k_cache,
                                        const __nv_bfloat16* v_cache,
                                        const int* tables,
                                        const int* seq_lens, float* out,
                                        float* scratch, int B, int H, int D,
                                        int NB, int BT, int W, float scale,
                                        int device, void* stream) {
  return dispatch(q, q_sb, q_sh, k_cache, v_cache, tables, seq_lens, out,
                  scratch, B, H, D, NB, BT, W, scale, device, stream);
}
