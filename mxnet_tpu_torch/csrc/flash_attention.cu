// Blockwise (flash) attention forward on the tensor cores, sm_90a: fp32 in
// and out (3xTF32), or bf16 in and out with f32 inside (bf16 products).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_flash_kernel` (launched by
// `_flash_call`, exposed as `flash_attention`), forward only; the backward
// is csrc/flash_attention_bwd.cu.
//
// out[b, h] = softmax(scale * Q K^T [causal]) V for Q (Tq, D) and K, V
// (Tk, D), without writing the (Tq, Tk) score matrix to device memory.
// When the caller passes an `lse` buffer (training), the kernel also
// writes each row's log-sum-exp m + log(l) of the scaled scores, f32
// (B, H, Tq) contiguous, which the backward uses to recompute P; serving
// passes null and the kernel writes nothing more than the output.
//
// Bound on this card. Q, K, V and O are read or written once (4 * T * D * 4
// bytes per head) while the two products do 4 * Tq * Tk * D flops (about
// half of that when causal). Both products run here as 3xTF32 on the
// tensor cores, three TF32 products each, so the least time is
//   max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s);
// at the serving path's largest prefill (causal, B 1, H 8, T 512, D 64)
// that is max(1.25, 1.63) us = 1.63 us, bound by operations. On the fp32
// FMA pipes (67 TFLOP/s) the same work could take no less than 4.01 us.
//
// Why 3xTF32. Plain TF32 keeps 10 mantissa bits and misses the fp32
// tolerance (1e-4 against the plain version). Each operand x is split into
// big = tf32(x) and small = tf32(x - big) (both `cvt.rna`); a product is
// a_small*b_big + a_big*b_small + a_big*b_big (a_small*b_small, under 2^-22
// of the product, is dropped). The small cross terms go into a zeroed f32
// fragment first and the big product last, and each k-step's fragment is
// added to the running f32 sum with an ordinary FADD, so whatever rounding
// the tensor core's internal accumulation does touches one k-step's partial
// sum, never the running one.
//
// Why mma.sync.m16n8k8.tf32 and not wgmma. wgmma takes TF32 operands only
// K-major from shared memory, so V (stored keys x D, reduced over keys)
// would have to be staged transposed, and the big/small halves of every
// operand would have to be written to shared memory before the product.
// With mma.sync each warp builds its fragments in registers: K and V are
// split as they are read, and P, which the softmax leaves in the
// accumulator layout, feeds the second product as its A operand without a
// trip through shared memory (the key index of P's fragment and of V's is
// permuted the same way: thread t holds keys 2t and 2t+1, not t and t+4).
// At these sizes the kernel is bound by latency and the number of CTAs
// in flight, not by the tensor cores' peak, so wgmma's extra rate would
// not show.
//
// Design:
//  - one CTA of 4 warps per (16-row Q tile, head, batch): 16 rows are one
//    m16 tile, and small tiles put enough CTAs on the 132 SMs at B 1, H 8.
//    The grid is 1-D and ordered heaviest first (the last causal Q tile of
//    every head, then the one before, ...), so the tiles that walk the most
//    keys start first and the light ones fill in behind them. Grid per
//    prefill bucket at B 1, H 8: T 16 -> 8 CTAs, 32 -> 16, 64 -> 32,
//    128 -> 64, 256 -> 128, 512 -> 256;
//  - keys advance in 64-key stages, double-buffered in shared memory with
//    cp.async (16 bytes a thread, zero-filled past Tk): stage s + 1 loads
//    while stage s computes. Q, K and V rows are padded to D + 4 floats, so
//    every fragment read hits 32 distinct banks;
//  - the four warps split each stage's 64 keys, 16 each, all over the same
//    16 query rows; a warp skips a chunk no row of the tile can see (above
//    the causal diagonal, or past Tk). Each warp keeps its own online
//    softmax (row max, row sum, 16 x D accumulator), and the four partials
//    merge through shared memory at the end;
//  - masked scores get p = 0 explicitly. NEG_INF is -1e30 as in the TPU
//    kernel: a row no key has reached yet keeps m = -1e30 and alpha = 1;
//  - q, k, v are strided views (token stride e.g. 3 * d_model for the
//    prefill's fused projection); the wrapper checks the 16-byte alignment
//    cp.async needs. The output is written with its own strides, laid out
//    (B, T, H, D) by the wrapper.
//
// The bf16 kernel (`flash_attention_bf16_kernel`, `mxt_flash_attention_bf16`)
// is the TPU kernel's bf16 case: q, k, v bf16, everything inside f32, the
// output written in bf16. Bound at the decoder-LM training shape (causal,
// B 8, H 12, T 2048, D 64): bytes q, k, v, o in bf16 plus the f32 lse,
// 4 * 96 * 2048 * 64 * 2 + 96 * 2048 * 4 = 101.4 MB, 0.030 ms at 3.35 TB/s;
// operations 4 * D flops per visible pair, 96 * 2048 * 2049 / 2 = 201.4M
// pairs, 51.6 GFLOP, 0.052 ms at 989 TFLOP/s bf16: bound 0.052 ms, by
// operations. Design, the fp32 kernel's skeleton with:
//  - mma.sync.m16n8k16.bf16 with f32 accumulators, one product per k16
//    step (the fp32 kernel does three TF32 products per k8 step). bf16
//    operands multiply exactly in f32, and the scale is applied to S in
//    f32, so q is never rounded again;
//  - rows of D + 8 bf16 in shared memory: 32-bit fragment loads of Q and
//    K hit 32 distinct banks; cp.async moves 8 values a copy;
//  - Q's A fragments are read into registers once;
//  - P needs no key permutation: the m16n8k16 accumulator layout of the
//    warp's two S tiles, (row g, keys 2t, 2t + 1) and (row g + 8, the
//    same) then keys + 8, is the A fragment layout of the P V product. P
//    is rounded to bf16 (nearest even) for that product, as the TPU's MXU
//    rounds it at default precision; the row sums use the f32 P. V's B
//    fragment pairs keys 2t and 2t + 1 of one column from two rows;
//  - the four warps' partials merge in f32 (the stage area reused) and
//    each output is rounded once to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16;                  // query rows per CTA: one m16 tile
constexpr int kBK = 64;                  // keys per pipeline stage
constexpr int kChunk = kBK / kWarps;     // keys per warp per stage
constexpr int kNJ = kChunk / 8;          // n8 tiles of S per warp and stage
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  // Q big and small parts, then two stages of (K, V); the final merge
  // reuses the stage area
  return 2 * kBQ * (D + 4) + 2 * 2 * kBK * (D + 4);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a * b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the small cross terms first, the big product last
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(c, ab, bb);
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o,
                           float* __restrict__ lse, int H, int BH, int n_qt,
                           int Tq, int Tk, int64_t q_sb, int64_t q_sh,
                           int64_t q_st, int64_t k_sb, int64_t k_sh,
                           int64_t k_st, int64_t v_sb, int64_t v_sh,
                           int64_t v_st, int64_t o_sb, int64_t o_sh,
                           int64_t o_st, float scale, int causal) {
  constexpr int P = D + 4;       // padded row, in floats
  constexpr int KS = D / 8;      // k-steps of S = Q K^T
  constexpr int NT = D / 8;      // n-tiles of O
  constexpr int Q4 = D / 4;      // 16-byte pieces per row
  extern __shared__ __align__(16) float smem[];
  float* sQb = smem;
  float* sQs = sQb + kBQ * P;
  float* sKV = sQs + kBQ * P;    // stage buffer i: K at i * 2 * kBK * P, V after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // heaviest causal tile first, across every (batch, head)
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float* obase = o + b * o_sb + h * o_sh;

  // keys any row of this tile can see: [0, kv_end)
  const int kv_end = causal ? min(q0 + kBQ, Tk) : Tk;
  const int n_st = (kv_end + kBK - 1) / kBK;

  for (int e = threadIdx.x; e < kBQ * Q4; e += kThreads) {
    const int r = e / Q4, c = (e % Q4) * 4, tok = q0 + r;
    const bool in = tok < Tq;
    cp16(sQb + r * P + c, qb + (in ? tok : 0) * q_st + c, in);
  }
  auto load_kv = [&](int stage) {
    float* sK = sKV + (stage & 1) * 2 * kBK * P;
    float* sV = sK + kBK * P;
    for (int e = threadIdx.x; e < kBK * Q4; e += kThreads) {
      const int r = e / Q4, c = (e % Q4) * 4, tok = stage * kBK + r;
      const bool in = tok < Tk;
      const int64_t src = in ? tok : 0;
      cp16(sK + r * P + c, kb + src * k_st + c, in);
      cp16(sV + r * P + c, vb + src * v_st + c, in);
    }
  };
  load_kv(0);
  cp_commit();

  // this thread's rows of the tile: g and g + 8
  const int row0 = q0 + g, row1 = q0 + g + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st) {
      load_kv(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
      // scale Q and split it into its TF32 big and small parts, once
      for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
        const int r = e / D, c = e % D;
        uint32_t big, small;
        split(sQb[r * P + c] * scale, big, small);
        sQb[r * P + c] = __uint_as_float(big);
        sQs[r * P + c] = __uint_as_float(small);
      }
      __syncthreads();
    }
    const float* sK = sKV + (s & 1) * 2 * kBK * P + warp * kChunk * P;
    const float* sV = sK + kBK * P;
    const int c0 = s * kBK + warp * kChunk;   // this warp's first key
    if (c0 < kv_end) {
      // S = (scale Q) K^T over the warp's keys, kNJ n8 tiles
      float sc[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 8 + t;
        const uint32_t ab[4] = {bits(sQb[g * P + c]), bits(sQb[(g + 8) * P + c]),
                                bits(sQb[g * P + c + 4]),
                                bits(sQb[(g + 8) * P + c + 4])};
        const uint32_t as[4] = {bits(sQs[g * P + c]), bits(sQs[(g + 8) * P + c]),
                                bits(sQs[g * P + c + 4]),
                                bits(sQs[(g + 8) * P + c + 4])};
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float* kr = sK + (8 * j + g) * P + c;
          uint32_t bb[2], bs[2];
          split(kr[0], bb[0], bs[0]);
          split(kr[4], bb[1], bs[1]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(part, ab, as, bb, bs);
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] += part[i];
        }
      }

      // online softmax; sc[j][i] is (row g or g + 8, key c0 + 8j + 2t + i%2)
      float p[kNJ][4];
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = c0 + 8 * j + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          const bool ok = key < Tk && (!causal || key <= row);
          p[j][i] = ok ? 1.f : 0.f;     // the mask, until p is computed
          sc[j][i] = ok ? sc[j][i] : kNegInf;
          if (i < 2)
            mx0 = fmaxf(mx0, sc[j][i]);
          else
            mx1 = fmaxf(mx1, sc[j][i]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = p[j][i] != 0.f
                              ? expf(sc[j][i] - (i < 2 ? mn0 : mn1))
                              : 0.f;
          p[j][i] = e;
          if (i < 2)
            rs0 += e;
          else
            rs1 += e;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      }
      l0 = fmaf(l0, al0, rs0);
      l1 = fmaf(l1, al1, rs1);
      m0 = mn0;
      m1 = mn1;

      // O = diag(alpha) O + P V. P's A fragment straight from the
      // accumulator layout: logical k = t is key 2t, k = t + 4 is key 2t + 1
      uint32_t pb[kNJ][4], ps[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        split(p[j][0], pb[j][0], ps[j][0]);
        split(p[j][2], pb[j][1], ps[j][1]);
        split(p[j][1], pb[j][2], ps[j][2]);
        split(p[j][3], pb[j][3], ps[j][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float* vr = sV + (8 * j + 2 * t) * P + 8 * n + g;
          uint32_t bb[2], bs[2];
          split(vr[0], bb[0], bs[0]);
          split(vr[P], bb[1], bs[1]);
          mma3(part, pb[j], ps[j], bb, bs);
        }
        acc[n][0] = fmaf(acc[n][0], al0, part[0]);
        acc[n][1] = fmaf(acc[n][1], al0, part[1]);
        acc[n][2] = fmaf(acc[n][2], al1, part[2]);
        acc[n][3] = fmaf(acc[n][3], al1, part[3]);
      }
    }
    __syncthreads();   // the next iteration's load overwrites this buffer
  }

  // merge the four warps' partials through shared memory
  float* sM = sKV;                       // [kWarps][kBQ]
  float* sL = sM + kWarps * kBQ;         // [kWarps][kBQ]
  float* sA = sL + kWarps * kBQ;         // [kWarps][kBQ][P]
  if (t == 0) {
    sM[warp * kBQ + g] = m0;
    sM[warp * kBQ + g + 8] = m1;
    sL[warp * kBQ + g] = l0;
    sL[warp * kBQ + g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* a0 = sA + (warp * kBQ + g) * P + 8 * n + 2 * t;
    a0[0] = acc[n][0];
    a0[1] = acc[n][1];
    a0[8 * P] = acc[n][2];
    a0[8 * P + 1] = acc[n][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, tok = q0 + r;
    if (tok >= Tq) continue;
    float M = sM[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sM[w * kBQ + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w * kBQ + r] - M);   // a warp that saw no key: 0
      L = fmaf(sL[w * kBQ + r], f, L);
      A = fmaf(sA[(w * kBQ + r) * P + c], f, A);
    }
    obase[tok * o_st + c] = A / fmaxf(L, 1e-30f);
    if (lse != nullptr && c == 0)
      lse[static_cast<int64_t>(bh) * Tq + tok] = M + logf(fmaxf(L, 1e-30f));
  }
}


// ---------------------------------------------------------------------------
// bf16 in and out, f32 inside (the TPU kernel's `.astype(jnp.float32)`)
// ---------------------------------------------------------------------------

template <int D>
constexpr int bf16_smem_bytes() {
  // Q, then two stages of (K, V), rows of D + 8 bf16; the final merge
  // reuses the stage area as f32 (row maxima, row sums, 4 x 16 x (D + 4))
  constexpr int q = kBQ * (D + 8) * 2;
  constexpr int stages = 2 * 2 * kBK * (D + 8) * 2;
  constexpr int merge = (2 * kWarps * kBQ + kWarps * kBQ * (D + 4)) * 4;
  return q + (stages > merge ? stages : merge);
}

// c += a * b on one m16n8k16 bf16 tile, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two consecutive bf16 of shared memory as one fragment register
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// {lo, hi} as a fragment register: lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// two f32 rounded to nearest even into one bf16x2 register
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int H, int BH,
                                int n_qt, int Tq, int Tk, int64_t q_sb,
                                int64_t q_sh, int64_t q_st, int64_t k_sb,
                                int64_t k_sh, int64_t k_st, int64_t v_sb,
                                int64_t v_sh, int64_t v_st, int64_t o_sb,
                                int64_t o_sh, int64_t o_st, float scale,
                                int causal) {
  constexpr int P = D + 8;       // padded row, in bf16 (16 bytes of padding)
  constexpr int KS = D / 16;     // k-steps of S = Q K^T
  constexpr int NT = D / 8;      // n-tiles of O
  constexpr int C8 = D / 8;      // 16-byte pieces per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + kBQ * P;   // stage i: K at i * 2 * kBK * P, V after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* obase = o + b * o_sb + h * o_sh;

  const int kv_end = causal ? min(q0 + kBQ, Tk) : Tk;
  const int n_st = (kv_end + kBK - 1) / kBK;

  for (int e = threadIdx.x; e < kBQ * C8; e += kThreads) {
    const int r = e / C8, c = (e % C8) * 8, tok = q0 + r;
    const bool in = tok < Tq;
    cp16(sQ + r * P + c, qb + (in ? tok : 0) * q_st + c, in);
  }
  auto load_kv = [&](int stage) {
    __nv_bfloat16* sK = sKV + (stage & 1) * 2 * kBK * P;
    __nv_bfloat16* sV = sK + kBK * P;
    for (int e = threadIdx.x; e < kBK * C8; e += kThreads) {
      const int r = e / C8, c = (e % C8) * 8, tok = stage * kBK + r;
      const bool in = tok < Tk;
      const int64_t src = in ? tok : 0;
      cp16(sK + r * P + c, kb + src * k_st + c, in);
      cp16(sV + r * P + c, vb + src * v_st + c, in);
    }
  };
  load_kv(0);
  cp_commit();

  const int row0 = q0 + g, row1 = q0 + g + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  uint32_t qa[KS][4];   // Q's A fragments, read once after the first wait

  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st) {
      load_kv(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 16 + 2 * t;
        qa[kk][0] = ld2(sQ + g * P + c);
        qa[kk][1] = ld2(sQ + (g + 8) * P + c);
        qa[kk][2] = ld2(sQ + g * P + c + 8);
        qa[kk][3] = ld2(sQ + (g + 8) * P + c + 8);
      }
    }
    const __nv_bfloat16* sK = sKV + (s & 1) * 2 * kBK * P + warp * kChunk * P;
    const uint16_t* sV =
        reinterpret_cast<const uint16_t*>(sK + kBK * P);
    const int c0 = s * kBK + warp * kChunk;   // this warp's first key
    if (c0 < kv_end) {
      // S = Q K^T over the warp's 16 keys (two n8 tiles), f32, then scaled
      float sc[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const __nv_bfloat16* kr = sK + (8 * j + g) * P + kk * 16 + 2 * t;
          const uint32_t bk[2] = {ld2(kr), ld2(kr + 8)};
          mma_bf16(sc[j], qa[kk], bk);
        }
      }

      // online softmax in f32; sc[j][i] is (row g or g + 8, key
      // c0 + 8j + 2t + i%2)
      float p[kNJ][4];
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = c0 + 8 * j + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          const bool ok = key < Tk && (!causal || key <= row);
          p[j][i] = ok ? 1.f : 0.f;
          sc[j][i] = ok ? sc[j][i] * scale : kNegInf;
          if (i < 2)
            mx0 = fmaxf(mx0, sc[j][i]);
          else
            mx1 = fmaxf(mx1, sc[j][i]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = p[j][i] != 0.f
                              ? expf(sc[j][i] - (i < 2 ? mn0 : mn1))
                              : 0.f;
          p[j][i] = e;
          if (i < 2)
            rs0 += e;
          else
            rs1 += e;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      }
      l0 = fmaf(l0, al0, rs0);
      l1 = fmaf(l1, al1, rs1);
      m0 = mn0;
      m1 = mn1;

      // O = diag(alpha) O + P V with P rounded to bf16. The m16n8k16 A
      // fragment of P is the accumulator layout of the two S tiles as it
      // stands: (row g, keys 2t, 2t+1), (row g + 8, same), then keys + 8
      const uint32_t pa[4] = {
          pack_rn(p[0][0], p[0][1]), pack_rn(p[0][2], p[0][3]),
          pack_rn(p[1][0], p[1][1]), pack_rn(p[1][2], p[1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* vc = sV + 2 * t * P + 8 * n + g;   // key 2t, column
        const uint32_t bv[2] = {pack(vc[0], vc[P]), pack(vc[8 * P], vc[9 * P])};
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, pa, bv);
        acc[n][0] = fmaf(acc[n][0], al0, part[0]);
        acc[n][1] = fmaf(acc[n][1], al0, part[1]);
        acc[n][2] = fmaf(acc[n][2], al1, part[2]);
        acc[n][3] = fmaf(acc[n][3], al1, part[3]);
      }
    }
    __syncthreads();   // the next iteration's load overwrites this buffer
  }

  // merge the four warps' partials through shared memory (f32)
  float* sM = reinterpret_cast<float*>(sKV);   // [kWarps][kBQ]
  float* sL = sM + kWarps * kBQ;               // [kWarps][kBQ]
  float* sA = sL + kWarps * kBQ;               // [kWarps][kBQ][D + 4]
  constexpr int PA = D + 4;
  if (t == 0) {
    sM[warp * kBQ + g] = m0;
    sM[warp * kBQ + g + 8] = m1;
    sL[warp * kBQ + g] = l0;
    sL[warp * kBQ + g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* a0 = sA + (warp * kBQ + g) * PA + 8 * n + 2 * t;
    a0[0] = acc[n][0];
    a0[1] = acc[n][1];
    a0[8 * PA] = acc[n][2];
    a0[8 * PA + 1] = acc[n][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, tok = q0 + r;
    if (tok >= Tq) continue;
    float M = sM[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sM[w * kBQ + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w * kBQ + r] - M);
      L = fmaf(sL[w * kBQ + r], f, L);
      A = fmaf(sA[(w * kBQ + r) * PA + c], f, A);
    }
    obase[tok * o_st + c] = __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
    if (lse != nullptr && c == 0)
      lse[static_cast<int64_t>(bh) * Tq + tok] = M + logf(fmaxf(L, 1e-30f));
  }
}
// the f32 kernel for float, the bf16 one for __nv_bfloat16
template <int D>
auto kernel_for(const float*) { return flash_attention_kernel<D>; }
template <int D>
auto kernel_for(const __nv_bfloat16*) { return flash_attention_bf16_kernel<D>; }

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, float* lse,
                   int B, int H, int Tq, int Tk, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  constexpr size_t smem = bf16 ? bf16_smem_bytes<D>()
                               : smem_floats<D>() * sizeof(float);
  const auto kernel = kernel_for<D>(q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(n_qt) * B * H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, o, lse, H, B * H, n_qt, Tq, Tk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, float* lse, int B,
             int H, int Tq, int Tk, int D, const int64_t* strides,
             float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, causal, s);
    case 32:
      return launch<32>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o: (B, H, T, D) with element strides (batch, head, token) in
// `strides` = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb,
// o_sh, o_st} and unit stride along D; q, k and v 16-byte aligned with
// strides of 16 bytes' multiples (checked by the caller). Causal needs
// Tq == Tk (checked by the caller). `lse`: null, or f32 (B, H, Tq)
// contiguous for the rows' log-sum-exp. Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported head
// size. `_f32` takes and writes fp32; `_bf16` takes and writes bf16.
extern "C" int mxt_flash_attention_f32(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int B, int H,
                                       int Tq, int Tk, int D,
                                       const int64_t* strides, float scale,
                                       int causal, int device, void* stream) {
  return dispatch(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale, causal,
                  device, stream);
}

extern "C" int mxt_flash_attention_bf16(const __nv_bfloat16* q,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v,
                                        __nv_bfloat16* o, float* lse, int B,
                                        int H, int Tq, int Tk, int D,
                                        const int64_t* strides, float scale,
                                        int causal, int device, void* stream) {
  return dispatch(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale, causal,
                  device, stream);
}
