// Blockwise (flash) attention backward, fp32 or bf16, sm_90a: dQ, dK and dV of
// out = softmax(scale * Q K^T [causal]) V, without writing the (Tq, Tk)
// score or probability matrix to device memory.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_chunked_attention_bwd`
// (reached through `_flash_diff_bwd`, the custom_vjp of the Pallas forward
// `_flash_diff` / `_flash_call`). That function is a jnp scan over query
// blocks that carries dK and dV from block to block; a GPU runs its blocks
// in parallel and in no order, so the work is cut the other way here.
//
// Inputs: q, k, v, the forward's output o, the output gradient dO, and the
// forward's row log-sum-exp lse = m + log(l) of the scaled scores (written
// by csrc/flash_attention.cu when training). With it P is recomputed
// exactly as the forward normalised it: P = exp(scale * Q K^T - lse).
//
// Three launches, one stream, for either type:
//  1. dot: Dv_i = rowsum(dO_i * O_i), one warp per query row, f32 scratch
//     (B, H, Tq). dS = P * (dP - Dv) with dP = dO V^T is the softmax VJP.
//  2. dK/dV: one CTA of 4 warps per (64-key block, head, batch). K_j and
//     V_j stay in shared memory; the CTA walks the 64-row query blocks
//     that can see them (from the diagonal on when causal), loads Q_i,
//     dO_i, lse_i and Dv_i, recomputes the scores and accumulates dV_j +=
//     P^T dO_i and dK_j += dS^T Q_i in registers; dK is scaled once at
//     the end.
//  3. dQ: one CTA of 4 warps per (64-row query block, head, batch). Q_i,
//     dO_i, lse_i and Dv_i stay; the CTA walks the key blocks the rows can
//     see, recomputes S, P, dP and dS, and accumulates dQ_i += dS K_j.
// Pass 3 recomputes S and dP, but every gradient is written once from one
// CTA: no atomicAdd into dQ, so the result is the same bits run to run.
// Both types share the skeleton of passes 2 and 3:
//  - in pass 2 each warp owns 16 keys and computes the transposed tiles
//    S^T = K_w Q_i^T and dP^T = V_w dO_i^T, so P^T and dS^T = P^T * (dP^T
//    - Dv) sit in the mma accumulator layout, which is (after the key
//    permutation below, for fp32) the A fragment of dV += P^T dO_i and
//    dK += dS^T Q_i as it stands: P and dS never touch shared memory. In
//    pass 3 each warp owns 16 query rows and S, dP come out the same way;
//  - tiles are loaded by 16-byte cp.async, zero-filled past T, into two
//    stages: the next Q/dO block (pass 2) or K/V block (pass 3) loads
//    while this one computes. So q, k, v and dO need 16-byte aligned base
//    addresses and strides (the wrapper copies any input that is not);
//  - 4 warps a CTA.
//
// Bound at the training path's shape (causal, B 8, H 12, T 2048, D 64):
// bytes q, k, v, o, dO read once, dq, dk, dv written once, lse read once:
// 8 * 8 * 12 * 2048 * 64 * 4 + 8 * 12 * 2048 * 4 = 403.4 MB, 0.120 ms at
// 3.35 TB/s. Operations: the five products the gradient needs (S, dP, dV,
// dK, dQ), 2 * D flops each per visible query-key pair, T (T + 1) / 2
// pairs per head when causal: 10 * 64 * 96 * 2048 * 2049 / 2 = 128.9
// GFLOP (the exponentials not counted). As for the forward, the least
// time takes the card's fastest route that meets the fp32 tolerance,
// 3xTF32 on the tensor cores:
//   max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s) = max(0.120, 0.781)
// = 0.781 ms, bound by operations (1.924 ms on the fp32 FMA pipes).
//
// fp32 (`mxt_flash_attention_bwd_f32`, `dkdv_f32_kernel` /
// `dq_f32_kernel`): every product runs on the tensor cores as 3xTF32,
// `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`, in the forward's form
// (csrc/flash_attention.cu). Each operand x is split into big = x rounded
// to TF32 (to nearest, ties away: `cvt.rna`'s rounding, done as an integer
// add and mask, two instructions where the cvt takes four) and small = x -
// big, which the tensor core reads as TF32 by ignoring its low 13 bits
// (big + small is x to within 2^-22). Per k-step of 16 (two m16n8k8) the
// products a_small * b_big and a_big * b_small go into a zeroed fragment
// first and a_big * b_big last, and the fragment is added to the running
// f32 sum with an FADD, so the tensor core's own accumulation touches one
// k-step's partial sum only (as the forward's P V does). One TF32 product
// alone (10 mantissa bits) misses the fp32 tolerance
// (tests/test_torch_attention.py
// `test_flash_bwd_1xtf32_emulation_misses_fp32_tolerance`).
//  - m16n8k8's A fragment holds columns t and t + 4 of a k-step, its
//    accumulator columns 2t and 2t + 1. So P^T, dS^T and dS feed the next
//    product with its k index permuted as the forward's P does: logical k
//    = t is accumulator column 2t, k = t + 4 is 2t + 1; the B operand's
//    rows (dO, Q or K, indexed by that k) are read in the same order.
//    P^T and dS^T are split into big and small as they leave the
//    accumulator;
//  - ldmatrix moves 16-bit elements only, so every f32 fragment is read
//    from shared memory by scalar loads and split as it is read (the
//    forward does the same for K and V). Tiles stay f32, rows of D + 4
//    floats: a fragment read along a row (lanes g, t at row g, column t)
//    falls on bank 4g + t, one read down the rows (row 2t, column g) on
//    bank 8t + g; both are 32 distinct banks. (The bf16 kernels' D + 8
//    would put rows 2t and 2t + 2 on one bank);
//  - P = expf(scale * S - lse), masked scores 0 (only in the blocks that
//    hold a diagonal or a ragged edge). expf as the FMA kernels it
//    replaces had it, not the bf16 kernels' `ex2.approx`: the SFU's
//    2^-22 is a few percent faster but takes a larger share of the f64
//    check this kernel is held to (no further from an f64 run than twice
//    the plain fp32 pipeline);
//  - shared memory: K, V and two stages of Q, dO (pass 2; lse and Dv
//    too) or Q, dO and two stages of K, V (pass 3): 6 tiles of 64 x (D +
//    4) floats, 105 KB at D 64, so two CTAs an SM; at D 128, 203 KB: one
//    CTA an SM with both stages kept (no 32-row tiles);
//  - registers: at D 64 pass 2 fills the 255 a thread may hold (dK and
//    dV, 16 keys x D each, the S^T and dP^T tiles and the fragments; a
//    few bytes spill), pass 3 a little less. The k-loop of the S and dP
//    products is not unrolled: unrolled, ptxas runs the loads ahead into
//    spills. Two CTAs an SM either way (shared memory). D 128 spills
//    more.
// The kernels' own floor: 7 products a visible pair (S and dP twice, dV,
// dK, dQ), 3 TF32 products each, 21 against the function's 15: 21/15 *
// 0.781 = 1.09 ms; mma.sync does not reach wgmma's peak rate.
//
// bf16 (`mxt_flash_attention_bwd_bf16`, `dkdv_bf16_kernel` /
// `dq_bf16_kernel`): q, k, v, o and dO bf16, every sum in f32, each
// gradient rounded once to bf16 (nearest even); lse and Dv f32. The
// products run on the bf16 tensor cores, `mma.sync.m16n8k16.row.col.f32.
// bf16.bf16.f32`, with operands read from shared memory by `ldmatrix`
// (`.trans` for an operand stored the other way round):
//  - S and dP: one product each, exact products of the bf16 inputs;
//  - P and dS are f32 (P = exp(scale * S - lse), dS = P * (dP - Dv), as
//    the TPU backward computes them), not bf16 values. Rounded once to
//    bf16 (the FA2 / SDPA rounding) they put the gradients outside the
//    bound the card holds them to against the plain version (rtol 1e-4 +
//    2^-7, atol 1e-5; tests/test_torch_attention.py
//    `test_flash_bwd_bf16_single_rounding_misses_chip_bound`). So each
//    is carried as two bf16 pieces, hi = bf16(x) and lo = bf16(x - hi),
//    which keep 16 of its 24 bits, and dV += P^T dO, dK += dS^T Q and
//    dQ += dS K take two products each, hi and lo, summed in the same f32
//    accumulator. In m16n8k16 the accumulator layout of two n8 tiles
//    (keys 2t, 2t + 1 then + 8) is the A fragment as it stands;
//  - P's exponential runs on the SFU, `ex2.approx` of the argument times
//    log2(e) folded into the FMA that forms it (about 2^-22 relative,
//    against expf's eight instructions an element);
//  - tiles stay bf16 in shared memory, rows of D + 8 (16 bytes of
//    padding: the eight 16-byte rows an ldmatrix reads hit distinct
//    banks), cp.async 16 bytes a copy (4 for lse and Dv).
// Three CTAs an SM below D 128. Bound at the same shape in bf16: bytes 8
// tensors of 96 * 2048 * 64 bf16 plus lse = 202.1 MB, 0.060 ms;
// operations 128.9 GFLOP at 989 TFLOP/s bf16, 0.130 ms: bound 0.130 ms,
// by operations. This kernel does 8 products of 2 * D flops per visible
// pair (S, dP, and two each for dV, dK and dQ), 10 with pass 3's
// recomputation of S and dP, so its own floor on the tensor cores is
// 10/5 * 0.130 = 0.26 ms; mma.sync does not reach wgmma's peak rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;                // query rows and keys per tile
constexpr int kDotWarps = 8;
constexpr int kWarps = 4;             // 16 rows (pass 3) or keys (pass 2) each
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D, typename E>
__global__ void __launch_bounds__(kDotWarps * 32)
    bwd_dot_kernel(const E* __restrict__ o, const E* __restrict__ dout,
               float* __restrict__ dvec, int H, int Tq, int rows,
               int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t g_sb,
               int64_t g_sh, int64_t g_st) {
  const int row = blockIdx.x * kDotWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int tok = row % Tq, bh = row / Tq, b = bh / H, h = bh % H;
  const E* orow = o + b * o_sb + h * o_sh + tok * o_st;
  const E* grow = dout + b * g_sb + h * g_sh + tok * g_st;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

template <typename E>
struct Args {
  const E *q, *k, *v, *dout;
  const float *lse, *dvec;
  E *dq, *dk, *dv;
  int H, BH, Tq, Tk;
  int64_t st[24];   // (batch, head, token) of q, k, v, o, dO, dq, dk, dv
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kPadF = 4;              // f32 row padding, in floats

template <int D>
constexpr int dkdv_f32_smem_bytes() {
  // K, V; two stages of (Q, dO); two stages of (lse, Dv)
  return (2 + 2 * 2) * kB * (D + kPadF) * 4 + 2 * 2 * kB * 4;
}

template <int D>
constexpr int dq_f32_smem_bytes() {
  // Q, dO; two stages of (K, V)
  return (2 + 2 * 2) * kB * (D + kPadF) * 4;
}

// x as TF32 big + small: big is x rounded to 10 mantissa bits, to nearest
// with ties away from zero (cvt.rna.tf32.f32's rounding, done as an
// integer add and mask: two instructions where the cvt takes four; Inf
// and NaN stay what they are), small = x - big, exact in f32, which the
// tensor core reads as TF32 by ignoring its low 13 bits: big + small is x
// to within 2^-22 of it
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// part += a * b in 3xTF32: the small cross terms first, the big product
// last
__device__ __forceinline__ void mma3(float (&part)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(part, as, bb[0], bb[1]);
  mma_tf32(part, ab, bs[0], bs[1]);
  mma_tf32(part, ab, bb[0], bb[1]);
}

// P = e^(scale * s - lse), by expf
__device__ __forceinline__ float p_exp(float scale, float s, float lse) {
  return expf(fmaf(scale, s, -lse));
}

// rows [row0, row0 + kB) of a (T, D) f32 slice with row stride `st` into
// a tile of rows D + 4, by cp.async; rows past T are zero
template <int D>
__device__ __forceinline__ void load_tile_f32(float* s, const float* g,
                                              int64_t st, int row0, int T) {
  constexpr int P = D + kPadF, C4 = D / 4;
  for (int e = threadIdx.x; e < kB * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4, row = row0 + r;
    const bool in = row < T;
    cp16(s + r * P + c, g + static_cast<int64_t>(in ? row : 0) * st + c, in);
  }
}

// the A fragment (big and small) of k-step kk from 16 rows of a tile of
// rows P: rows g, g + 8, columns 8kk + t, + 4
template <int P>
__device__ __forceinline__ void a_rows(const float* s, int kk, int g, int t,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float* r = s + g * P + 8 * kk + t;
  split(r[0], ab[0], as[0]);
  split(r[8 * P], ab[1], as[1]);
  split(r[4], ab[2], as[2]);
  split(r[8 * P + 4], ab[3], as[3]);
}

// the A fragment of k-step kk from an accumulator tile set x[8][4] (x[j]:
// rows g, g + 8, columns 8j + 2t, + 1), split as it leaves the
// accumulator: m16n8k8's A holds columns t and t + 4 of a k-step, so the
// k index is permuted, logical k = t is column 2t and t + 4 is 2t + 1
__device__ __forceinline__ void a_acc(const float (&x)[8][4], int kk,
                                      uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split(x[kk][0], ab[0], as[0]);
  split(x[kk][2], ab[1], as[1]);
  split(x[kk][1], ab[2], as[2]);
  split(x[kk][3], ab[3], as[3]);
}

// c[8][4] = A (16 rows of sA) times B^T (64 rows of sB) over D, both
// row-major tiles of rows D + 4: c[j] is rows g, g + 8 and columns 8j +
// 2t, + 1. Operands split as they are read; each 16-wide k-step (two
// m16n8k8) into a zeroed fragment, then one FADD into c
template <int D>
__device__ __forceinline__ void mma_abt_f32(float (&c)[8][4], const float* sA,
                                            const float* sB, int g, int t) {
  constexpr int P = D + kPadF;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  // one k-step at a time: unrolled, the loads run ahead into spills
#pragma unroll 1
  for (int k2 = 0; k2 < D / 16; ++k2) {
    uint32_t ab[2][4], as[2][4];
    a_rows<P>(sA, 2 * k2, g, t, ab[0], as[0]);
    a_rows<P>(sA, 2 * k2 + 1, g, t, ab[1], as[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* br = sB + (8 * j + g) * P + 16 * k2 + 8 * h + t;
        uint32_t bb[2], bs[2];
        split(br[0], bb[0], bs[0]);
        split(br[4], bb[1], bs[1]);
        mma3(part, ab[h], as[h], bb, bs);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] += part[i];
    }
  }
}

// acc[D/8][4] += X (16 x 64, an accumulator tile set as mma_abt_f32
// leaves it) times sB (64 rows of D + 4). k-step kk is X's n8 tile kk
// (a_acc's permuted k), with sB's rows 8kk + 2t and 8kk + 2t + 1 in the
// same order; two k-steps into a zeroed fragment, then one FADD
template <int D>
__device__ __forceinline__ void mma_xb_f32(float (&acc)[D / 8][4],
                                           const float (&x)[8][4],
                                           const float* sB, int g, int t) {
  constexpr int P = D + kPadF;
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    uint32_t ab[2][4], as[2][4];
    a_acc(x, 2 * k2, ab[0], as[0]);
    a_acc(x, 2 * k2 + 1, ab[1], as[1]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* br = sB + (16 * k2 + 8 * h + 2 * t) * P + 8 * n + g;
        uint32_t bb[2], bs[2];
        split(br[0], bb[0], bs[0]);
        split(br[P], bb[1], bs[1]);
        mma3(part, ab[h], as[h], bb, bs);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
    }
  }
}

// the 16 x D accumulator's rows r0 and r0 + 8 (columns 8n + 2t, + 1),
// times `scale`; rows at or past T are not written
template <int D>
__device__ __forceinline__ void store_rows_f32(float* g, int64_t st, int r0,
                                               int T,
                                               const float (&acc)[D / 8][4],
                                               float scale, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= T) continue;
    float* dst = g + static_cast<int64_t>(row) * st + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    dkdv_f32_kernel(const Args<float> a) {
  constexpr int P = D + kPadF;
  constexpr int TILE = kB * P;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TILE;
  float* sQ = sV + TILE;          // stage i at i * TILE
  float* sG = sQ + 2 * TILE;      // dO, stage i at i * TILE
  float* sL = sG + 2 * TILE;      // lse, stage i at i * kB
  float* sDv = sL + 2 * kB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest key block (the first, when causal) first
  const int bh = blockIdx.x % a.BH, kb = blockIdx.x / a.BH;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kb * kB;
  const int64_t* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[1];
  const float* gb = a.dout + b * st[12] + h * st[13];
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Tq;
  const float* dvec = a.dvec + static_cast<int64_t>(bh) * a.Tq;

  load_tile_f32<D>(sK, a.k + b * st[3] + h * st[4], st[5], k0, a.Tk);
  load_tile_f32<D>(sV, a.v + b * st[6] + h * st[7], st[8], k0, a.Tk);
  auto load_q = [&](int q0, int buf) {
    load_tile_f32<D>(sQ + buf * TILE, qb, st[2], q0, a.Tq);
    load_tile_f32<D>(sG + buf * TILE, gb, st[14], q0, a.Tq);
    // kThreads == 2 * kB: one f32 copy a thread
    const int r = threadIdx.x & (kB - 1), row = q0 + r;
    const bool in = row < a.Tq;
    const float* src = threadIdx.x < kB ? lse : dvec;
    float* dst = (threadIdx.x < kB ? sL : sDv) + buf * kB + r;
    cp4(dst, src + (in ? row : 0), in);
  };
  const int n_qb = (a.Tq + kB - 1) / kB;
  // causal needs Tq == Tk: rows below k0 see none of these keys
  const int first = a.causal ? k0 / kB : 0;
  load_q(first * kB, 0);
  cp_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  // this thread's keys: kw + g and kw + g + 8
  const int kw = k0 + 16 * warp;

  for (int qi = first; qi < n_qb; ++qi) {
    const int buf = (qi - first) & 1, q0 = qi * kB;
    if (qi + 1 < n_qb) {
      load_q(q0 + kB, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Q = sQ + buf * TILE;
    const float* G = sG + buf * TILE;
    const float* L = sL + buf * kB;
    const float* Dv = sDv + buf * kB;
    // P^T = exp(scale * K_w Q^T - lse): x[j][i] is key kw + g + 8 (i >> 1),
    // query q0 + 8j + 2t + (i & 1)
    float x[8][4];
    mma_abt_f32<D>(x, sK + 16 * warp * P, Q, g, t);
    const bool edge = (a.causal && q0 < kw + 16) || q0 + kB > a.Tq ||
                      kw + 16 > a.Tk;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * j + 2 * t + (i & 1), qg = q0 + qc;
          const int kg = kw + g + 8 * (i >> 1);
          const bool ok = qg < a.Tq && kg < a.Tk && (!a.causal || kg <= qg);
          x[j][i] = ok ? p_exp(a.scale, x[j][i], L[qc]) : 0.f;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[j][i] = p_exp(a.scale, x[j][i], L[8 * j + 2 * t + (i & 1)]);
    }
    mma_xb_f32<D>(dv, x, G, g, t);
    // dS^T = P^T * (V_w dO^T - Dv)
    float dp[8][4];
    mma_abt_f32<D>(dp, sV + 16 * warp * P, G, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[j][i] *= dp[j][i] - Dv[8 * j + 2 * t + (i & 1)];
    mma_xb_f32<D>(dk, x, Q, g, t);
    __syncthreads();   // the next block's loads overwrite this stage
  }

  store_rows_f32<D>(a.dk + b * st[18] + h * st[19], st[20], kw + g, a.Tk, dk,
                    a.scale, t);
  store_rows_f32<D>(a.dv + b * st[21] + h * st[22], st[23], kw + g, a.Tk, dv,
                    1.f, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    dq_f32_kernel(const Args<float> a) {
  constexpr int P = D + kPadF;
  constexpr int TILE = kB * P;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sG = sQ + TILE;
  float* sK = sG + TILE;          // stage i: K at 2 i TILE, V after
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qb = (a.Tq + kB - 1) / kB;
  // the heaviest query block (the last, when causal) first
  const int bh = blockIdx.x % a.BH, qi = n_qb - 1 - blockIdx.x / a.BH;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qi * kB;
  const int64_t* st = a.st;
  const float* kbase = a.k + b * st[3] + h * st[4];
  const float* vb = a.v + b * st[6] + h * st[7];

  load_tile_f32<D>(sQ, a.q + b * st[0] + h * st[1], st[2], q0, a.Tq);
  load_tile_f32<D>(sG, a.dout + b * st[12] + h * st[13], st[14], q0, a.Tq);
  auto load_kv = [&](int k0, int buf) {
    load_tile_f32<D>(sK + 2 * buf * TILE, kbase, st[5], k0, a.Tk);
    load_tile_f32<D>(sK + (2 * buf + 1) * TILE, vb, st[8], k0, a.Tk);
  };
  load_kv(0, 0);
  cp_commit();

  // this thread's rows: qw + g and qw + g + 8, with their lse and Dv
  const int qw = q0 + 16 * warp;
  float lse_r[2], dv_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    const int64_t at = static_cast<int64_t>(bh) * a.Tq + row;
    lse_r[hh] = row < a.Tq ? a.lse[at] : 0.f;
    dv_r[hh] = row < a.Tq ? a.dvec[at] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  // keys these rows can see: [0, kv_end)
  const int kv_end = a.causal ? min(q0 + kB, a.Tk) : a.Tk;
  const int n_kb = (kv_end + kB - 1) / kB;
  for (int kj = 0; kj < n_kb; ++kj) {
    const int buf = kj & 1, k0 = kj * kB;
    if (kj + 1 < n_kb) {
      load_kv(k0 + kB, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* K = sK + 2 * buf * TILE;
    const float* V = K + TILE;
    // P = exp(scale * Q_w K^T - lse): x[j][i] is row qw + g + 8 (i >> 1),
    // key k0 + 8j + 2t + (i & 1)
    float x[8][4];
    mma_abt_f32<D>(x, sQ + 16 * warp * P, K, g, t);
    const bool edge = (a.causal && k0 + kB > qw) || k0 + kB > a.Tk ||
                      qw + 16 > a.Tq;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kg = k0 + 8 * j + 2 * t + (i & 1);
          const int qg = qw + g + 8 * (i >> 1);
          const bool ok = qg < a.Tq && kg < a.Tk && (!a.causal || kg <= qg);
          x[j][i] = ok ? p_exp(a.scale, x[j][i], lse_r[i >> 1]) : 0.f;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[j][i] = p_exp(a.scale, x[j][i], lse_r[i >> 1]);
    }
    // dS = P * (dO_w V^T - Dv)
    float dp[8][4];
    mma_abt_f32<D>(dp, sG + 16 * warp * P, V, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[j][i] *= dp[j][i] - dv_r[i >> 1];
    mma_xb_f32<D>(dq, x, K, g, t);
    __syncthreads();   // the next block's loads overwrite this stage
  }

  store_rows_f32<D>(a.dq + b * st[15] + h * st[16], st[17], qw + g, a.Tq, dq,
                    a.scale, t);
}

// fp32 on the 3xTF32 tensor-core kernels
template <int D>
cudaError_t launch(const Args<float>& a, const float* o,
                   cudaStream_t stream) {
  const int rows = a.BH * a.Tq;
  bwd_dot_kernel<D, float><<<(rows + kDotWarps - 1) / kDotWarps,
                             kDotWarps * 32, 0, stream>>>(
      o, a.dout, const_cast<float*>(a.dvec), a.H, a.Tq, rows, a.st[9],
      a.st[10], a.st[11], a.st[12], a.st[13], a.st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem1 = dkdv_f32_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
  if (err != cudaSuccess) return err;
  const int64_t n_kb = (a.Tk + kB - 1) / kB;
  dkdv_f32_kernel<D><<<static_cast<unsigned>(n_kb * a.BH), kThreads, smem1,
                       stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem2 = dq_f32_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return err;
  const int64_t n_qb = (a.Tq + kB - 1) / kB;
  dq_f32_kernel<D><<<static_cast<unsigned>(n_qb * a.BH), kThreads, smem2,
                     stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
constexpr int dkdv_bf16_smem_bytes() {
  // K, V; two stages of (Q, dO); two stages of (lse, Dv)
  return (2 + 2 * 2) * kB * (D + 8) * 2 + 2 * 2 * kB * 4;
}

template <int D>
constexpr int dq_bf16_smem_bytes() {
  // Q, dO; two stages of (K, V)
  return (2 + 2 * 2) * kB * (D + 8) * 2;
}

// e^x on the SFU, `ex2.approx` of x log2(e) (relative error about 2^-22,
// and 0 for the -1e30 of a masked score): two instructions where expf's
// range reduction takes eight. The caller folds log2(e) into its FMA
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b on one m16n8k16 bf16 tile, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {x0, x1} as two bf16x2 registers hi = bf16(x), lo = bf16(x - hi), each
// rounded to nearest even; x0 in the low half (the lower k index)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A fragments (hi and lo) of k-step kk from an accumulator tile set
// x[8][4] (n8 tiles 2kk and 2kk + 1 are the step's 16 k indices)
__device__ __forceinline__ void a_split(const float (&x)[8][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// rows [row0, row0 + kB) of a (T, D) bf16 slice with row stride `st` into
// a tile of rows D + 8, by cp.async; rows past T are zero
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* s, const bf16* g,
                                               int64_t st, int row0, int T) {
  constexpr int P = D + 8, C8 = D / 8;
  for (int e = threadIdx.x; e < kB * C8; e += kThreads) {
    const int r = e / C8, c = (e % C8) * 8, row = row0 + r;
    const bool in = row < T;
    cp16(s + r * P + c, g + static_cast<int64_t>(in ? row : 0) * st + c, in);
  }
}

// c[8][4] = A (16 rows of sA from row a0) times B^T (64 rows of sB), both
// stored row-major with rows of D + 8: the m16n8k16 tiles of a 16 x 64
// product over D
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const bf16* sA,
                                        const bf16* sB, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, sA + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm4(b, sB + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * P +
                   kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(c[2 * jj], a, b[0], b[1]);
      mma16816(c[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc[D/8][4] += X (16 x 64, an accumulator tile set, as hi + lo) times
// sB (64 rows of D + 8, read transposed by ldmatrix)
template <int D>
__device__ __forceinline__ void mma_split_b(float (&acc)[D / 8][4],
                                            const float (&x)[8][4],
                                            const bf16* sB, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    a_split(x, kk, hi, lo);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm4_t(b, sB + (16 * kk + (lane & 15)) * P + 16 * np + (lane >> 4) * 8);
      mma16816(acc[2 * np], hi, b[0], b[1]);
      mma16816(acc[2 * np], lo, b[0], b[1]);
      mma16816(acc[2 * np + 1], hi, b[2], b[3]);
      mma16816(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// the 16 x (D) accumulator's rows r0 and r0 + 8 (columns 8n + 2t, + 1),
// times `scale`, rounded once to bf16; rows at or past T are not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, int64_t st, int r0, int T,
                                          const float (&acc)[D / 8][4],
                                          float scale, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= T) continue;
    bf16* dst = g + static_cast<int64_t>(row) * st + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D < 128 ? 3 : 2)
    dkdv_bf16_kernel(const Args<bf16> a) {
  constexpr int P = D + 8;
  constexpr int TILE = kB * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;          // stage i at i * TILE
  bf16* sG = sQ + 2 * TILE;      // dO, stage i at i * TILE
  float* sL = reinterpret_cast<float*>(sG + 2 * TILE);   // stage i at i * kB
  float* sDv = sL + 2 * kB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2e = a.scale * kLog2e;
  // the heaviest key block (the first, when causal) first
  const int bh = blockIdx.x % a.BH, kb = blockIdx.x / a.BH;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kb * kB;
  const int64_t* st = a.st;
  const bf16* qb = a.q + b * st[0] + h * st[1];
  const bf16* gb = a.dout + b * st[12] + h * st[13];
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Tq;
  const float* dvec = a.dvec + static_cast<int64_t>(bh) * a.Tq;

  load_tile_bf16<D>(sK, a.k + b * st[3] + h * st[4], st[5], k0, a.Tk);
  load_tile_bf16<D>(sV, a.v + b * st[6] + h * st[7], st[8], k0, a.Tk);
  auto load_q = [&](int q0, int buf) {
    load_tile_bf16<D>(sQ + buf * TILE, qb, st[2], q0, a.Tq);
    load_tile_bf16<D>(sG + buf * TILE, gb, st[14], q0, a.Tq);
    // kThreads == 2 * kB: one f32 copy a thread
    const int r = threadIdx.x & (kB - 1), row = q0 + r;
    const bool in = row < a.Tq;
    const float* src = threadIdx.x < kB ? lse : dvec;
    float* dst = (threadIdx.x < kB ? sL : sDv) + buf * kB + r;
    cp4(dst, src + (in ? row : 0), in);
  };
  const int n_qb = (a.Tq + kB - 1) / kB;
  // causal needs Tq == Tk: rows below k0 see none of these keys
  const int first = a.causal ? k0 / kB : 0;
  load_q(first * kB, 0);
  cp_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  // this thread's keys: kw + g and kw + g + 8
  const int kw = k0 + 16 * warp;

  for (int qi = first; qi < n_qb; ++qi) {
    const int buf = (qi - first) & 1, q0 = qi * kB;
    if (qi + 1 < n_qb) {
      load_q(q0 + kB, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Q = sQ + buf * TILE;
    const bf16* G = sG + buf * TILE;
    const float* L = sL + buf * kB;
    const float* Dv = sDv + buf * kB;
    // P^T = exp(scale * K_w Q^T - lse): x[j][i] is key kw + g + 8 (i >> 1),
    // query q0 + 8j + 2t + (i & 1)
    float x[8][4];
    mma_abt<D>(x, sK + 16 * warp * P, Q, lane);
    const bool edge = (a.causal && q0 < kw + 16) || q0 + kB > a.Tq ||
                      kw + 16 > a.Tk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = 8 * j + 2 * t + (i & 1), qg = q0 + qc;
        const int kg = kw + g + 8 * (i >> 1);
        const bool ok =
            !edge || (qg < a.Tq && kg < a.Tk && (!a.causal || kg <= qg));
        x[j][i] = ok ? exp2_sfu(fmaf(sl2e, x[j][i], -L[qc] * kLog2e)) : 0.f;
      }
    mma_split_b<D>(dv, x, G, lane);
    // dS^T = P^T * (V_w dO^T - Dv)
    float dp[8][4];
    mma_abt<D>(dp, sV + 16 * warp * P, G, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[j][i] *= dp[j][i] - Dv[8 * j + 2 * t + (i & 1)];
    mma_split_b<D>(dk, x, Q, lane);
    __syncthreads();   // the next block's loads overwrite this stage
  }

  store_rows<D>(a.dk + b * st[18] + h * st[19], st[20], kw + g, a.Tk, dk,
                a.scale, t);
  store_rows<D>(a.dv + b * st[21] + h * st[22], st[23], kw + g, a.Tk, dv,
                1.f, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D < 128 ? 3 : 2)
    dq_bf16_kernel(const Args<bf16> a) {
  constexpr int P = D + 8;
  constexpr int TILE = kB * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + TILE;
  bf16* sK = sG + TILE;          // stage i: K at 2 i TILE, V after
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2e = a.scale * kLog2e;
  const int n_qb = (a.Tq + kB - 1) / kB;
  // the heaviest query block (the last, when causal) first
  const int bh = blockIdx.x % a.BH, qi = n_qb - 1 - blockIdx.x / a.BH;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qi * kB;
  const int64_t* st = a.st;
  const bf16* kbase = a.k + b * st[3] + h * st[4];
  const bf16* vb = a.v + b * st[6] + h * st[7];

  load_tile_bf16<D>(sQ, a.q + b * st[0] + h * st[1], st[2], q0, a.Tq);
  load_tile_bf16<D>(sG, a.dout + b * st[12] + h * st[13], st[14], q0, a.Tq);
  auto load_kv = [&](int k0, int buf) {
    load_tile_bf16<D>(sK + 2 * buf * TILE, kbase, st[5], k0, a.Tk);
    load_tile_bf16<D>(sK + (2 * buf + 1) * TILE, vb, st[8], k0, a.Tk);
  };
  load_kv(0, 0);
  cp_commit();

  // this thread's rows: qw + g and qw + g + 8, with their lse (times
  // log2(e)) and Dv
  const int qw = q0 + 16 * warp;
  float lse_r[2], dv_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    const int64_t at = static_cast<int64_t>(bh) * a.Tq + row;
    lse_r[hh] = row < a.Tq ? a.lse[at] * kLog2e : 0.f;
    dv_r[hh] = row < a.Tq ? a.dvec[at] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  // keys these rows can see: [0, kv_end)
  const int kv_end = a.causal ? min(q0 + kB, a.Tk) : a.Tk;
  const int n_kb = (kv_end + kB - 1) / kB;
  for (int kj = 0; kj < n_kb; ++kj) {
    const int buf = kj & 1, k0 = kj * kB;
    if (kj + 1 < n_kb) {
      load_kv(k0 + kB, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* K = sK + 2 * buf * TILE;
    const bf16* V = K + TILE;
    // P = exp(scale * Q_w K^T - lse): x[j][i] is row qw + g + 8 (i >> 1),
    // key k0 + 8j + 2t + (i & 1)
    float x[8][4];
    mma_abt<D>(x, sQ + 16 * warp * P, K, lane);
    const bool edge = (a.causal && k0 + kB > qw) || k0 + kB > a.Tk ||
                      qw + 16 > a.Tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kg = k0 + 8 * j + 2 * t + (i & 1);
        const int qg = qw + g + 8 * (i >> 1);
        const bool ok =
            !edge || (qg < a.Tq && kg < a.Tk && (!a.causal || kg <= qg));
        x[j][i] = ok ? exp2_sfu(fmaf(sl2e, x[j][i], -lse_r[i >> 1])) : 0.f;
      }
    // dS = P * (dO_w V^T - Dv)
    float dp[8][4];
    mma_abt<D>(dp, sG + 16 * warp * P, V, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[j][i] *= dp[j][i] - dv_r[i >> 1];
    mma_split_b<D>(dq, x, K, lane);
    __syncthreads();   // the next block's loads overwrite this stage
  }

  store_rows<D>(a.dq + b * st[15] + h * st[16], st[17], qw + g, a.Tq, dq,
                a.scale, t);
}

// bf16 on the tensor-core kernels
template <int D>
cudaError_t launch(const Args<bf16>& a, const bf16* o, cudaStream_t stream) {
  const int rows = a.BH * a.Tq;
  bwd_dot_kernel<D, bf16><<<(rows + kDotWarps - 1) / kDotWarps,
                            kDotWarps * 32, 0, stream>>>(
      o, a.dout, const_cast<float*>(a.dvec), a.H, a.Tq, rows, a.st[9],
      a.st[10], a.st[11], a.st[12], a.st[13], a.st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem1 = dkdv_bf16_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
  if (err != cudaSuccess) return err;
  const int64_t n_kb = (a.Tk + kB - 1) / kB;
  dkdv_bf16_kernel<D><<<static_cast<unsigned>(n_kb * a.BH), kThreads, smem1,
                        stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem2 = dq_bf16_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return err;
  const int64_t n_qb = (a.Tq + kB - 1) / kB;
  dq_bf16_kernel<D><<<static_cast<unsigned>(n_qb * a.BH), kThreads, smem2,
                      stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
int dispatch(const E* q, const E* k, const E* v, const E* o, const E* dout,
             const float* lse, float* dvec, E* dq, E* dk, E* dv, int B, int H,
             int Tq, int Tk, int D, const int64_t* strides, float scale,
             int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args<E> a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dvec = dvec;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.BH = B * H;
  a.Tq = Tq;
  a.Tk = Tk;
  for (int i = 0; i < 24; ++i) a.st[i] = strides[i];
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(a, o, s);
    case 32:
      return launch<32>(a, o, s);
    case 64:
      return launch<64>(a, o, s);
    case 128:
      return launch<128>(a, o, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o/dout in and dq/dk/dv out: (B, H, T, D) with element strides
// (batch, head, token) in `strides` = {q, k, v, o, dout, dq, dk, dv} x
// {sb, sh, st} and unit stride along D; all fp32 (`_f32`) or all bf16
// (`_bf16`: read into f32, every sum in f32, the gradients rounded once
// to bf16). lse: the forward's f32 (B, H, Tq) contiguous row log-sum-exp;
// dvec: f32 (B, H, Tq) scratch. Causal needs Tq == Tk. Both types copy q,
// k, v and dout 16 bytes at a time (cp.async): their base addresses and
// (batch, head, token) strides must be multiples of 16 bytes; o takes any
// strides. The caller checks shapes, strides, alignment and that (Tq or
// Tk) / 64 times B * H fits a grid.
// Returns the first CUDA error of the three launches (0 on success), or
// cudaErrorInvalidValue for an unsupported head size.
extern "C" int mxt_flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dvec, float* dq, float* dk,
    float* dv, int B, int H, int Tq, int Tk, int D, const int64_t* strides,
    float scale, int causal, int device, void* stream) {
  return dispatch(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, H, Tq, Tk, D,
                  strides, scale, causal, device, stream);
}

extern "C" int mxt_flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
    float* dvec, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
    int B, int H, int Tq, int Tk, int D, const int64_t* strides, float scale,
    int causal, int device, void* stream) {
  return dispatch(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, H, Tq, Tk, D,
                  strides, scale, causal, device, stream);
}
