// Blockwise (flash) attention forward on the tensor cores, sm_90a: fp32 in
// and out (3xTF32), or bf16 in and out with f32 inside (bf16 products).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_flash_kernel` (launched by
// `_flash_call`, exposed as `flash_attention`), forward only; the backward
// is csrc/flash_attention_bwd.cu.
//
// out[b, h] = softmax(scale * Q K^T [causal]) V for Q (Tq, D) and K, V
// (Tk, D), without writing the (Tq, Tk) score matrix to device memory.
// Causal takes Tq <= Tk with the queries as the last Tq key positions (the
// JAX reference's decoder convention): query row i sees keys
// j <= i + (Tk - Tq), the diagonal shifted by `shift` = Tk - Tq.
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
// operations. Design, for Hopper's warpgroup products:
//  - one CTA per (128-row Q tile, head, batch): two consumer warpgroups of
//    64 rows each and one producer warp. Each consumer walks every key its
//    own rows can see, in 64-key stages, with one online softmax per row:
//    no split of the keys over warps and no merge. Each K/V byte staged in
//    shared memory serves 128 rows. Grid heaviest first, as the fp32
//    kernel's; causal, a stage above a warpgroup's diagonal is never
//    loaded or walked, and only the diagonal stage (and one past Tk) is
//    masked;
//  - the producer warp's one thread loads Q once and K/V stages into a
//    ring of two by TMA (`cp.async.bulk.tensor`, (D, T, H, B) tensor maps
//    built on the host with cuTensorMapEncodeTiled, found at run time
//    through cudaGetDriverEntryPoint so the library needs no -lcuda),
//    each stage signalled through a `full` mbarrier with its byte count;
//    consumers release it through an `empty` mbarrier. TMA writes the
//    tiles in column chunks of min(D, 64) values with the 128/64/32-byte
//    swizzle wgmma reads (D 128: two chunks), zero past T, so q, k, v are
//    read as the strided views they are (16-byte alignment is checked by
//    the wrapper);
//  - S = Q K^T is `wgmma.m64n64k16` with Q and K from shared memory, both
//    K-major; the scale is applied to S in f32, so q is never rounded
//    again;
//  - P = exp(S - m) in f32 (on the SFU: `ex2.approx` of S log2(e) - m
//    log2(e), one FMA and one SFU instruction), the row sums from the f32
//    P, P rounded once to bf16 (nearest even) for O += P V, as the TPU's
//    MXU rounds it at default precision. That product is `wgmma.m64nDk16` with P from
//    registers: the accumulator layout of S's n8 tiles 2kk and 2kk + 1 is
//    the A fragment of k-step kk as it stands. V's (keys x D) tile is the
//    MN-major B operand (wgmma's transposed-B mode for bf16), so it is not
//    staged transposed;
//  - the output is rounded once to bf16, and lse = m + log(l) in f32.
// The softmax of one warpgroup does not overlap its own products; the
// other warpgroup's, and a second CTA's on the SM for D <= 64, fill in.
//
// Head size 256 (Gemma-7B's heads; instances of both kernels, the same
// function and the same order of work as at the other sizes):
//  - fp32: the 16 x 256 accumulator is 128 registers a thread, and two
//    K/V stages would need 293 KB of shared memory, so K and V take one
//    stage (163 KB): a stage loads after the last one is read, with no
//    overlap of copy and product;
//  - bf16: Q's 128 rows and two K/V stages are 193 KB (four 64-column
//    TMA chunks a tile); O += P V is two m64n128k16 products a k-step,
//    one for each half of V's columns, into the halves of the 128-register
//    accumulator (wgmma's N is at most 256, but one n128 product a half
//    keeps the fragment code of D 128).
#include <cuda.h>
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

// stages of (K, V) in shared memory: two (the next loads while this one
// computes) up to D 128; one at D 256, where two would take 293 KB of the
// 227 KB a block may have (one stage: 163 KB). The order of work, and so
// the arithmetic, is the same either way
template <int D>
__host__ __device__ constexpr int kv_stages() {
  return D > 128 ? 1 : 2;
}

template <int D>
constexpr int smem_floats() {
  // Q big and small parts, then the stages of (K, V); the final merge
  // reuses the stage area
  return 2 * kBQ * (D + 4) + kv_stages<D>() * 2 * kBK * (D + 4);
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
  constexpr int NS = kv_stages<D>();
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
  const int shift = causal ? Tk - Tq : 0;
  const int kv_end = causal ? min(q0 + kBQ + shift, Tk) : Tk;
  const int n_st = (kv_end + kBK - 1) / kBK;

  for (int e = threadIdx.x; e < kBQ * Q4; e += kThreads) {
    const int r = e / Q4, c = (e % Q4) * 4, tok = q0 + r;
    const bool in = tok < Tq;
    cp16(sQb + r * P + c, qb + (in ? tok : 0) * q_st + c, in);
  }
  auto load_kv = [&](int stage) {
    float* sK = sKV + (stage % NS) * 2 * kBK * P;
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

  // this thread's rows of the tile, g and g + 8, as key positions (row +
  // shift: the last key each sees when causal)
  const int row0 = q0 + g + shift, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int s = 0; s < n_st; ++s) {
    if (NS == 2 && s + 1 < n_st) {
      load_kv(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      if (NS == 1 && s > 0) {   // one stage: the last stage's readers are done
        load_kv(s);
        cp_commit();
      }
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
    const float* sK = sKV + (s % NS) * 2 * kBK * P + warp * kChunk * P;
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
// bf16 in and out, f32 inside (the TPU kernel's `.astype(jnp.float32)`):
// wgmma on 64-row warpgroup tiles, K/V by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kRows = 64;                 // query rows per consumer warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kBQ = kConsumers * kRows;   // query rows per CTA
constexpr int kBK = 64;                   // keys per stage
constexpr int kStages = 2;
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp

// a tile is stored in column chunks of CW = min(D, 64) values (one TMA box
// each), rows of CW * 2 bytes swizzled as TMA's SWIZZLE_{32,64,128}B writes
// them; chunk c of an R-row tile at c * R * CW * 2 bytes
template <int D>
struct Layout {
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int RB = CW * 2;           // row bytes: 32, 64 or 128
  static constexpr int NCH = D / CW;
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = kBK * D * 2;
  // wgmma's layout type for the swizzle: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t SWZ = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  // Q, then kStages of (K, V), then the barriers; +1024 to align the base
  static constexpr int SMEM = 1024 + Q_BYTES + kStages * 2 * KV_BYTES + 64;
};

// e^x on the SFU, `ex2.approx` of x log2(e) (relative error about 2^-22,
// and 0 for the -1e30 of a masked score): two instructions where expf's
// range reduction takes eight. The caller folds log2(e) into an FMA
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (CW, rows) box of a (D, T, H, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int t0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(t0),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma's shared memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, int lbo, int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         Layout<D>::SWZ << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d += A B, A from registers, B MN-major from shared memory
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d += A B, A from registers, B MN-major from shared memory
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d = A B^T (+ d when acc), A and B K-major from shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  // d += A B, A from registers, B MN-major from shared memory
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d[OFF, OFF + 64) += A B, A from registers, B MN-major from shared
  // memory (OFF 64: the second half of D 256's accumulator)
  template <int N = 64, int OFF = 0>
  static __device__ __forceinline__ void rs(float (&d)[N],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
          "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
          "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
          "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
          "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
          "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
          "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
          "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// two f32 rounded to nearest even into one bf16x2 register, lo in the low
// half (the lower k index)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int H, int BH,
                                int n_qt, int Tq, int Tk, int64_t o_sb,
                                int64_t o_sh, int64_t o_st, float scale,
                                int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + L::Q_BYTES;     // stage i: K, then V
  const uint32_t bars = sKV + kStages * 2 * L::KV_BYTES;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };
  const uint32_t qbar = bars + 8 * 2 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // heaviest causal tile first, across every (batch, head)
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kBQ;
  const int b = bh / H, h = bh % H;
  // keys any row of this tile can see: [0, kv_end)
  const int shift = causal ? Tk - Tq : 0;
  const int kv_end = causal ? min(q0 + kBQ + shift, Tk) : Tk;
  const int n_st = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumers * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 2 * 4) {
    // producer: Q once, then K/V stages through the ring
    if (lane == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < L::NCH; ++c)
        for (int r = 0; r < kBQ; r += kRows)
          tma_load(sQ + c * kBQ * L::RB + r * L::RB, &tq, qbar, c * L::CW,
                   q0 + r, h, b);
      for (int s = 0; s < n_st; ++s) {
        const int i = s % kStages;
        if (s >= kStages) mbar_wait(empty(i), (s / kStages - 1) & 1);
        mbar_expect_tx(full(i), 2 * L::KV_BYTES);
        const uint32_t sK = sKV + i * 2 * L::KV_BYTES;
        for (int c = 0; c < L::NCH; ++c) {
          tma_load(sK + c * kBK * L::RB, &tk, full(i), c * L::CW, s * kBK, h,
                   b);
          tma_load(sK + L::KV_BYTES + c * kBK * L::RB, &tv, full(i),
                   c * L::CW, s * kBK, h, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: rows q0 + 64 w + 16 (warp % 4) + g (and + 8),
  // held as key positions (row + shift, the last key each row sees when
  // causal) through the loop, so the mask takes no extra register
  const int w = warp >> 2, g = lane >> 2, t = lane & 3;
  const int rw = q0 + kRows * w + shift;      // the warpgroup's first row
  const int row0 = rw + 16 * (warp & 3) + g, row1 = row0 + 8;
  // stages this warpgroup's rows can see
  const int n_w = causal ? (min(rw + kRows, Tk) + kBK - 1) / kBK : n_st;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int s = 0; s < n_w; ++s) {
    const int i = s % kStages;
    mbar_wait(full(i), (s / kStages) & 1);
    const uint32_t sK = sKV + i * 2 * L::KV_BYTES;
    const uint32_t sV = sK + L::KV_BYTES;

    // S = Q K^T over the stage's 64 keys, f32; sc[4j + e] is row row0
    // (e < 2) or row1, key s * 64 + 8j + 2t + (e & 1)
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / L::CW, off = (kk * 16 % L::CW) * 2;
      Wgmma<64>::ss(sc,
                    desc<D>(sQ + c * kBQ * L::RB + kRows * w * L::RB + off,
                            16, 8 * L::RB),
                    desc<D>(sK + c * kBK * L::RB + off, 16, 8 * L::RB),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // online softmax in f32, the scale applied to S; masked scores get
    // p = 0. Only the diagonal stage (causal) and the last (past Tk) mask
    const bool edge = (causal && s * kBK + kBK > rw) || (s + 1) * kBK > Tk;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = s * kBK + 8 * (e >> 2) + 2 * t + (e & 1);
      const int row = (e & 2) ? row1 : row0;
      const bool ok = !edge || (key < Tk && (!causal || key <= row));
      sc[e] = ok ? sc[e] * scale : kNegInf;
      if (e & 2)
        mx1 = fmaxf(mx1, sc[e]);
      else
        mx0 = fmaxf(mx0, sc[e]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2_sfu((m0 - mn0) * kLog2e);
    const float al1 = exp2_sfu((m1 - mn1) * kLog2e);
    const float ml0 = mn0 * kLog2e, ml1 = mn1 * kLog2e;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = sc[e] != kNegInf
                          ? exp2_sfu(fmaf(sc[e], kLog2e, (e & 2) ? -ml1 : -ml0))
                          : 0.f;
      sc[e] = p;
      if (e & 2)
        rs1 += p;
      else
        rs0 += p;
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
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= al0;
      acc[4 * n + 1] *= al0;
      acc[4 * n + 2] *= al1;
      acc[4 * n + 3] *= al1;
    }

    // O += P V with P rounded to bf16: the accumulator layout of S's n8
    // tiles 2kk and 2kk + 1 is the A fragment of k-step kk as it stands;
    // V's tile (keys x D) is the MN-major B operand
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_rn(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (D <= 128) {
        Wgmma<D>::rs(acc, pa[kk],
                     desc<D>(sV + kk * 16 * L::RB, kBK * L::RB, 8 * L::RB));
      } else {
        // D 256: two n128 products, columns [0, 128) (chunks 0 and 1 of
        // V's tile) and [128, 256) (chunks 2 and 3) into acc's halves,
        // whose accumulator layout is acc's own (column 8n + 2t + (e & 1)
        // at acc[4n + e])
        Wgmma<128>::rs<D / 2, 0>(
            acc, pa[kk], desc<D>(sV + kk * 16 * L::RB, kBK * L::RB, 8 * L::RB));
        Wgmma<128>::rs<D / 2, 64>(
            acc, pa[kk],
            desc<D>(sV + 2 * kBK * L::RB + kk * 16 * L::RB, kBK * L::RB,
                    8 * L::RB));
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(empty(i));
  }

  // acc[4n + e] is row row0 (e < 2) or row1, column 8n + 2t + (e & 1)
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = (hh ? row1 : row0) - (causal ? Tk - Tq : 0);
    if (row >= Tq) continue;
    const float inv = hh ? inv1 : inv0;
    __nv_bfloat16* dst = ob + row * o_st + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc[4 * n + 2 * hh] * inv, acc[4 * n + 2 * hh + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(bh) * Tq + row] =
          (hh ? m1 : m0) + logf(fmaxf(hh ? l1 : l0, 1e-30f));
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time, so the
// library links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (D, T, H, B) map of a bf16 (B, H, T, D) view with element strides
// (sb, sh, st) and unit stride along D, boxes of (CW, 64 rows)
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int T,
              const int64_t* st) {
  using L = Layout<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::CW), kBK, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = L::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

// bf16 on the wgmma kernel, fp32 on the 3xTF32 one
template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                   int B, int H, int Tq, int Tk, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  static_assert(wg::kRows == wg::kBK, "Q boxes reuse the K/V box shape");
  CUtensorMap mq, mk, mv;
  if (!wg::make_map<D>(&mq, q, B, H, Tq, st) ||
      !wg::make_map<D>(&mk, k, B, H, Tk, st + 3) ||
      !wg::make_map<D>(&mv, v, B, H, Tk, st + 6))
    return cudaErrorInvalidValue;
  constexpr int smem = wg::Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + wg::kBQ - 1) / wg::kBQ;
  const int64_t blocks = static_cast<int64_t>(n_qt) * B * H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  wg::flash_attention_bf16_kernel<D>
      <<<static_cast<unsigned>(blocks), wg::kThreads, smem, stream>>>(
          mq, mk, mv, o, lse, H, B * H, n_qt, Tq, Tk, st[9], st[10], st[11],
          scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int H, int Tq, int Tk, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(n_qt) * B * H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_attention_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
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
    case 256:
      return launch<256>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o: (B, H, T, D) with element strides (batch, head, token) in
// `strides` = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb,
// o_sh, o_st} and unit stride along D; q, k and v 16-byte aligned with
// strides of 16 bytes' multiples, as cp.async (fp32) and TMA (bf16) need
// (checked by the caller). Causal needs Tq <= Tk (checked by the caller):
// row i sees keys j <= i + Tk - Tq.
// `lse`: null, or f32 (B, H, Tq) contiguous for the rows' log-sum-exp.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported head size or a tensor map the
// driver refuses. `_f32` takes and writes fp32; `_bf16` takes and writes
// bf16.
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
