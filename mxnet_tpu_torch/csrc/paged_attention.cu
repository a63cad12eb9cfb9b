// Paged single-query attention for the decode step, f32 queries over f32 or
// bf16 caches, f32 out, sm_90a: split-KV (flash decoding).
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
// sets the time. So the sequence is split into chunks, one CTA each; the
// grid (split, head, sequence) is sized from the table width W (ceil(W *
// BT / chunk) splits), never from seq_lens, which stays on the device: a
// CTA whose chunk starts at or past its sequence's length exits at once,
// and no merge reads its slot. The CTA reads its block ids from the table
// in device memory (the TPU kernel's scalar prefetch), clamps them into
// the pool, and issues every K and V row of its chunk as 16-byte cp.async
// copies before it waits for any (K and V in two commit groups, so the
// scores start while V is still arriving). A token's block and slot come
// from its own position, so chunk edges need not fall on block edges.
//
// f32 caches (`mxt_paged_attention_f32`):
//  - `paged_attention_kernel`: one CTA of 128 threads per 64-token chunk
//    (32 KB in flight at D 64, six CTAs an SM: some 190 KB in flight per
//    SM); the chunk's scores (two threads per token, one shuffle), its
//    max m and sum l of exp(s - m), and acc[d] = sum exp(s - m) v[d],
//    written to scratch the wrapper allocates, (B, H, splits) x (2 + D)
//    floats;
//  - `paged_attention_merge_kernel`: grid (head, sequence), D threads,
//    combines the live splits' partials, out = sum acc_s e^(m_s - M) /
//    sum l_s e^(m_s - M). A row with seq_len 0 (batch padding) writes
//    zeros there. One more launch a call (issued from the same C call),
//    about 3.4 us of device time at B 32.
//
// bf16 caches (`mxt_paged_attention_bf16`, the bf16 decoder's pool; the
// TPU kernel casts each block to f32): `paged_attention_bf16_kernel`, one
// launch a call. The cache bytes halve: at phase 5's B 32 with 9,536 live
// tokens the bound is 5.9 us (2 * 9,536 * 8 * 64 * 2 bytes over 3.35
// TB/s), against which the f32 design's fixed cost (table reads,
// cp.async round trip, two block reductions, the merge launch) weighs
// twice as much. So:
//  - tokens per CTA are chosen by the wrapper from B, H, D, W and the
//    cache type and the card's SM count (`ops/attention.py`
//    `_paged_chunk`, which chooses the f32 kernel's 64 too) and passed
//    in: 128 at D 64 (the f32 design's 32 KB in flight a CTA; at B 32, H
//    8 some 700 live CTAs, one wave of six an SM), 64 where that would
//    leave the grid under two CTAs an SM (B 1) or at D 128;
//  - K rows are read as 16-byte vectors of 8 bf16 by one thread a token
//    (two at 64-token chunks). The tiles are unpadded; piece c of K row
//    r sits at c ^ swz(r), so the 8 rows a quarter warp reads fall on
//    distinct bank groups (33.6 KB of shared memory at D 64: six CTAs an
//    SM). V is read along its rows as bf16 pairs. q, the softmax, the
//    accumulators, the scratch and the output stay f32. The copies ask
//    L2 for 128-byte lines (a row at D 64) rather than its default;
//  - the merge is in the kernel: a row whose sequence fits one chunk
//    writes its output at once. Otherwise each live CTA writes its (m, l,
//    acc) to the scratch and, after a block barrier, thread 0 increments
//    the (row, head) counter with an acq_rel atomic (its release
//    publishes the block's partial; a __threadfence() in every thread,
//    an SC fence, cost more); the CTA that brings the count to the row's
//    number of live splits merges them in split order, as the merge
//    kernel does, writes `out` and resets the counter to 0. Its loads
//    are issued together, 16 splits' a batch (a row longer than 16
//    chunks rescales its sums to each batch's maximum): one L2 round
//    trip after another per split cost more than the merge launch. The
//    counters are an int32 buffer the wrapper keeps per (device,
//    stream), zeroed once (B * H of them), so no launch clears them and
//    calls in flight on two streams never share one;
//  - a row with seq_len 0 has no live split: split 0's CTA writes its
//    zeros.
// What is left between this kernel and its bound: the 128-byte pieces
// the (NB, BT, H, D) pool scatters a head's rows into arrive at well
// under the HBM's peak rate, all of one wave's loads start together and
// arrive over most of the call, and then come the merging CTA's count
// and loads, each an L2 round trip under the wave's load. A ticket taken
// at the start (so the merging CTA may wait for the others) and partials
// tagged with the call's epoch (no count to wait for) cost as much on
// this card as the count they would replace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// f32 scratch first (q, p, reduction, accumulators), then the K and V
// chunks of CHUNK tokens in the cache's type, rows padded by 16 bytes
template <int D, int CHUNK>
__host__ __device__ constexpr int scratch_floats() {
  return D + CHUNK + 2 * kWarps + kThreads;
}

template <int D, typename T, int CHUNK>
constexpr int smem_bytes() {
  return scratch_floats<D, CHUNK>() * 4 +
         2 * CHUNK * (D + 16 / sizeof(T)) * sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

// q . k over n values: fp32 cache rows four at a time
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

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 16 bytes with a 128-byte L2 fetch: the piece's whole 128-byte line (a bf16
// row at D 64) comes in one request
__device__ __forceinline__ void cp16_l2(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
                   s),
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

template <int D, typename T, int CHUNK>
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
  float* sRed = sP + CHUNK;              // [2][kWarps]
  float* sAcc = sRed + 2 * kWarps;       // [kThreads]
  T* sK = reinterpret_cast<T*>(smem + scratch_floats<D, CHUNK>());
  T* sV = sK + CHUNK * P;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(seq_lens[b], W * BT);  // positions past the table do not exist
  const int t0 = split * CHUNK;
  if (t0 >= len) return;                 // the merge reads only live splits
  const int n = min(CHUNK, len - t0);

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
  constexpr int PER = CHUNK / PARTS;
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

template <int D, int CHUNK>
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
  const int ns = (len + CHUNK - 1) / CHUNK;
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

template <int D, int CHUNK>
cudaError_t launch_f32(const float* q, int64_t q_sb, int64_t q_sh,
                       const float* kc, const float* vc, const int* tables,
                       const int* seq_lens, float* out, float* scratch, int B,
                       int H, int NB, int BT, int W, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, float, CHUNK>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<D, float, CHUNK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int S = (W * BT + CHUNK - 1) / CHUNK;
  float* part_ml = scratch;
  float* part_acc = scratch + 2 * static_cast<int64_t>(B) * H * S;
  paged_attention_kernel<D, float, CHUNK>
      <<<dim3(S, H, B), kThreads, smem, stream>>>(
          q, q_sb, q_sh, kc, vc, tables, seq_lens, part_ml, part_acc, H, NB,
          BT, W, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_merge_kernel<D, CHUNK><<<dim3(H, B), D, 0, stream>>>(
      part_ml, part_acc, seq_lens, out, H, BT, W, S);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 caches: one launch, the chunk chosen by the wrapper, in-kernel merge
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D, int CHUNK>
constexpr int bf16_smem_bytes() {
  // q, p, the reductions (f32), then the K and V chunks, unpadded
  return (D + CHUNK + 2 * kWarps) * 4 + 2 * CHUNK * D * 2;
}

// where 16-byte piece c of K row r is stored: rows of D bf16 are 64, 128
// or 256 bytes, so a quarter warp reading one piece of 8 rows (or two
// pieces of 4) would hit one bank group; XOR the piece index with the
// row's place among the rows that share 128 bytes of banks
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = D / 8;                    // pieces a row
  constexpr int ROWS = C >= 8 ? 1 : 8 / C;    // rows a 128-byte line holds
  constexpr int MASK = (C >= 8 ? 8 : C) - 1;
  return c ^ ((r / ROWS) & MASK);
}

// *p += 1 with acquire and release semantics at GPU scope; the old value
__device__ __forceinline__ int atom_add_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// q . k over 8 values: a 16-byte piece of a bf16 K row and f32 q
__device__ __forceinline__ float dot8(const uint4& k, const float* q,
                                      float s) {
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k.y));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k.z));
  const float2 d =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k.w));
  s = fmaf(a.x, q0.x, s);
  s = fmaf(a.y, q0.y, s);
  s = fmaf(b.x, q0.z, s);
  s = fmaf(b.y, q0.w, s);
  s = fmaf(c.x, q1.x, s);
  s = fmaf(c.y, q1.y, s);
  s = fmaf(d.x, q1.z, s);
  s = fmaf(d.y, q1.w, s);
  return s;
}

template <int D, int CHUNK>
__global__ void __launch_bounds__(kThreads)
    paged_attention_bf16_kernel(const float* __restrict__ q, int64_t q_sb,
                                int64_t q_sh, const bf16* __restrict__ kc,
                                const bf16* __restrict__ vc,
                                const int* __restrict__ tables,
                                const int* __restrict__ seq_lens,
                                float* __restrict__ out,
                                float2* __restrict__ part_ml,
                                float* __restrict__ part_acc,
                                int* __restrict__ counters, int H, int NB,
                                int BT, int W, int S, float scale) {
  constexpr int C = D / 8;                  // 16-byte pieces a row
  constexpr int TPT = kThreads / CHUNK;     // threads a token: 1 or 2
  constexpr int PAIRS = D / 2;              // column pairs of V
  constexpr int PARTS = kThreads / PAIRS;   // token ranges of P V
  constexpr int TPP = CHUNK / PARTS;        // tokens a range
  constexpr int MERGE = 16;                 // splits' partials a merge batch
  static_assert(TPT * CHUNK == kThreads && C % TPT == 0, "chunk");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sP = sQ + D;
  float* sRed = sP + CHUNK;                 // [2][kWarps]
  bf16* sK = reinterpret_cast<bf16*>(sRed + 2 * kWarps);
  bf16* sV = sK + CHUNK * D;
  float* sAcc = reinterpret_cast<float*>(sK);   // [PARTS][D], once K is read
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const int len = min(seq_lens[b], W * BT);  // positions past the table do not exist
  if (len <= 0) {                          // batch padding: no live split
    if (split == 0)
      for (int d = threadIdx.x; d < D; d += kThreads) out[row * D + d] = 0.f;
    return;
  }
  const int t0 = split * CHUNK;
  if (t0 >= len) return;                   // nothing reads this slot
  const int n = min(CHUNK, len - t0);
  const int ns = (len + CHUNK - 1) / CHUNK;  // the row's live splits

  const int* trow = tables + static_cast<int64_t>(b) * W;
  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  const int64_t head_off = static_cast<int64_t>(h) * D;
  // every row of the chunk in flight at once: K, then V
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int i = e / C, c = e % C, tok = t0 + i;
    int blk = __ldg(trow + tok / BT);
    blk = min(max(blk, 0), NB - 1);       // never read outside the pool
    const int64_t off = (static_cast<int64_t>(blk) * BT + tok % BT) *
                            tok_stride + head_off + 8 * c;
    cp16_l2(sK + i * D + 8 * swz<D>(i, c), kc + off);
  }
  cp_commit();
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int i = e / C, c = e % C, tok = t0 + i;
    int blk = __ldg(trow + tok / BT);
    blk = min(max(blk, 0), NB - 1);
    const int64_t off = (static_cast<int64_t>(blk) * BT + tok % BT) *
                            tok_stride + head_off + 8 * c;
    cp16_l2(sV + i * D + 8 * c, vc + off);
  }
  cp_commit();
  const float* qp = q + b * q_sb + h * q_sh;
  for (int d = threadIdx.x; d < D; d += kThreads) sQ[d] = qp[d] * scale;
  cp_wait<1>();
  __syncthreads();

  // scores: TPT threads a token, C / TPT pieces each
  const int i = threadIdx.x / TPT, sub = threadIdx.x % TPT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f;
#pragma unroll
  for (int cc = 0; cc < C / TPT; ++cc) {
    const int c = sub * (C / TPT) + cc;
    s = dot8(*reinterpret_cast<const uint4*>(sK + i * D + 8 * swz<D>(i, c)),
             sQ + 8 * c, s);
  }
  if (TPT == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
  const bool live = i < n;
  s = live ? s : kNegInf;
  float mx = s;
#pragma unroll
  for (int off = 16; off >= TPT; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) sRed[warp] = mx;
  __syncthreads();
  float m = sRed[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sRed[w]);
  const float p = live ? expf(s - m) : 0.f;
  float ps = sub == 0 ? p : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ps += __shfl_xor_sync(0xffffffffu, ps, off);
  if (lane == 0) sRed[kWarps + warp] = ps;
  if (sub == 0) sP[i] = p;
  cp_wait<0>();
  __syncthreads();

  // acc[d] = sum_i p_i v_i[d]: column pairs x PARTS token ranges
  const int pr = threadIdx.x % PAIRS, part = threadIdx.x / PAIRS;
  float a0 = 0.f, a1 = 0.f;
  const int lo = part * TPP, hi = min(lo + TPP, n);
  for (int j = lo; j < hi; ++j) {
    const float pj = sP[j];
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(sV + j * D + 2 * pr));
    a0 = fmaf(pj, v.x, a0);
    a1 = fmaf(pj, v.y, a1);
  }
  sAcc[part * D + 2 * pr] = a0;
  sAcc[part * D + 2 * pr + 1] = a1;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += sRed[kWarps + w];
  const int d = threadIdx.x;               // kThreads >= D
  float acc = 0.f;
  if (d < D) {
#pragma unroll
    for (int r = 0; r < PARTS; ++r) acc += sAcc[r * D + d];
  }
  if (ns == 1) {                           // the row's only split
    if (d < D) out[row * D + d] = acc / fmaxf(l, 1e-30f);
    return;
  }

  const int64_t slot = row * S + split;
  if (d < D) part_acc[slot * D + d] = acc;
  if (threadIdx.x == 0) part_ml[slot] = make_float2(m, l);
  // the partial before the count: the barrier orders the block's stores
  // before thread 0's count, an acq_rel atomic at GPU scope, whose
  // release makes them visible with it (CUTLASS's semaphores count so)
  // and whose acquire orders the merging CTA's loads after it
  __syncthreads();
  if (threadIdx.x == 0) last = atom_add_acq_rel(counters + row) == ns - 1;
  __syncthreads();
  if (!last) return;
  // the last live split merges every split's partials in split order, as
  // paged_attention_merge_kernel does (the loads go to L2, __ldcg, so no
  // stale L1 line). Each L2 round trip under the kernel's load costs the
  // better part of a microsecond, so the loads are issued together, MERGE
  // splits (all of serving's) a batch. Past the first batch the sums so
  // far are rescaled to the new maximum, as the online softmax does; on
  // the first, M starts at kNegInf and the rescale is by 0
  if (d < D) {
    const float2* ml = part_ml + row * S;
    const float* pa = part_acc + row * S * D + d;
    float M = kNegInf, L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < ns; s0 += MERGE) {
      float2 mlv[MERGE];
      float av[MERGE];
#pragma unroll
      for (int j = 0; j < MERGE; ++j) {
        const bool in = s0 + j < ns;
        mlv[j] = in ? __ldcg(ml + s0 + j) : make_float2(kNegInf, 0.f);
        av[j] = in ? __ldcg(pa + (s0 + j) * D) : 0.f;
      }
      float Mb = M;
#pragma unroll
      for (int j = 0; j < MERGE; ++j) Mb = fmaxf(Mb, mlv[j].x);
      const float r = expf(M - Mb);
      L *= r;
      A *= r;
#pragma unroll
      for (int j = 0; j < MERGE; ++j) {
        if (s0 + j >= ns) break;
        const float f = expf(mlv[j].x - Mb);
        L = fmaf(mlv[j].y, f, L);
        A = fmaf(av[j], f, A);
      }
      M = Mb;
    }
    out[row * D + d] = A / fmaxf(L, 1e-30f);
  }
  if (threadIdx.x == 0) counters[row] = 0;  // ready for the next call
}

template <int D, int CHUNK>
cudaError_t launch_bf16(const float* q, int64_t q_sb, int64_t q_sh,
                        const bf16* kc, const bf16* vc, const int* tables,
                        const int* seq_lens, float* out, float* scratch,
                        int* counters, int B, int H, int NB, int BT, int W,
                        float scale, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<D, CHUNK>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_bf16_kernel<D, CHUNK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int S = (W * BT + CHUNK - 1) / CHUNK;
  float2* part_ml = reinterpret_cast<float2*>(scratch);
  float* part_acc = scratch + 2 * static_cast<int64_t>(B) * H * S;
  paged_attention_bf16_kernel<D, CHUNK>
      <<<dim3(S, H, B), kThreads, smem, stream>>>(
          q, q_sb, q_sh, kc, vc, tables, seq_lens, out, part_ml, part_acc,
          counters, H, NB, BT, W, S, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t chunk_bf16(int chunk, const float* q, int64_t q_sb, int64_t q_sh,
                       const bf16* kc, const bf16* vc, const int* tables,
                       const int* seq_lens, float* out, float* scratch,
                       int* counters, int B, int H, int NB, int BT, int W,
                       float scale, cudaStream_t stream) {
  switch (chunk) {
    case 64:
      return launch_bf16<D, 64>(q, q_sb, q_sh, kc, vc, tables, seq_lens, out,
                                scratch, counters, B, H, NB, BT, W, scale,
                                stream);
    case 128:
      return launch_bf16<D, 128>(q, q_sb, q_sh, kc, vc, tables, seq_lens, out,
                                 scratch, counters, B, H, NB, BT, W, scale,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, D) f32 with strides (q_sb, q_sh, 1) in elements; k_cache/v_cache:
// (NB, BT, H, D) contiguous and 16-byte aligned, f32 (`_f32`) or bf16
// (`_bf16`, read into f32); tables: (B, W) int32; seq_lens: (B,) int32;
// out: (B, H, D) f32 contiguous; scratch: (B, H, S) x (2 + D) floats for
// S = ceil(W * BT / chunk). `chunk`: tokens per split CTA as the wrapper
// chose it, 64 for `_f32`, 64 or 128 for `_bf16` (the chunks built here).
// counters (`_bf16`): B * H int32, zero, left zero, used by one stream.
// Returns the CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for an unsupported head size or chunk.
extern "C" int mxt_paged_attention_f32(const float* q, int64_t q_sb,
                                       int64_t q_sh, const float* k_cache,
                                       const float* v_cache,
                                       const int* tables, const int* seq_lens,
                                       float* out, float* scratch, int B,
                                       int H, int D, int NB, int BT, int W,
                                       int chunk, float scale, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // the split and merge kernels are built for 64-token chunks only
  if (chunk != 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_f32<32, 64>(q, q_sb, q_sh, k_cache, v_cache, tables,
                                seq_lens, out, scratch, B, H, NB, BT, W,
                                scale, s);
    case 64:
      return launch_f32<64, 64>(q, q_sb, q_sh, k_cache, v_cache, tables,
                                seq_lens, out, scratch, B, H, NB, BT, W,
                                scale, s);
    case 128:
      return launch_f32<128, 64>(q, q_sb, q_sh, k_cache, v_cache, tables,
                                 seq_lens, out, scratch, B, H, NB, BT, W,
                                 scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mxt_paged_attention_bf16(
    const float* q, int64_t q_sb, int64_t q_sh, const __nv_bfloat16* k_cache,
    const __nv_bfloat16* v_cache, const int* tables, const int* seq_lens,
    float* out, float* scratch, int* counters, int B, int H, int D, int NB,
    int BT, int W, int chunk, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return chunk_bf16<32>(chunk, q, q_sb, q_sh, k_cache, v_cache, tables,
                            seq_lens, out, scratch, counters, B, H, NB, BT, W,
                            scale, s);
    case 64:
      return chunk_bf16<64>(chunk, q, q_sb, q_sh, k_cache, v_cache, tables,
                            seq_lens, out, scratch, counters, B, H, NB, BT, W,
                            scale, s);
    case 128:
      return chunk_bf16<128>(chunk, q, q_sb, q_sh, k_cache, v_cache, tables,
                             seq_lens, out, scratch, counters, B, H, NB, BT,
                             W, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
