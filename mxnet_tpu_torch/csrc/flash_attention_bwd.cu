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
//  2. dK/dV: one CTA per (64-key block, head, batch). K_j and V_j stay in
//     shared memory; the CTA walks the 64-row query blocks that can see
//     them (from the diagonal on when causal), loads Q_i, dO_i, lse_i and
//     Dv_i, recomputes S = Q_i K_j^T and dP = dO_i V_j^T, and accumulates
//     dV_j += P^T dO_i and dK_j += dS^T Q_i in registers; dK is scaled
//     once at the end.
//  3. dQ: one CTA per (64-row query block, head, batch). Q_i, dO_i, lse_i
//     and Dv_i stay; the CTA walks the key blocks the rows can see,
//     recomputes S, P, dP and dS, and accumulates dQ_i += dS K_j.
// Pass 3 recomputes S and dP, but every gradient is written once from one
// CTA: no atomicAdd into dQ, so the result is the same bits run to run.
//
// fp32 (`mxt_flash_attention_bwd_f32`, `dkdv_kernel` / `dq_kernel`): fp32
// FMA on the CUDA cores, one rounding per multiply-add, so the result sits
// within the fp32 tolerance of the plain version (ops/attention.py
// `flash_attention_bwd_plain`) with no TF32 splitting. 256 threads as a
// 16 x 16 grid; each thread owns 4 x 4 scores (rows ty + 16r, keys
// tx + 16c) and 4 x D/16 outputs (rows ty + 16r, columns tx + 16c). Rows
// in shared memory are padded to D + 4 floats, so the float4 reads of the
// score products hit distinct banks in each quarter warp; P and dS are
// stored 68 floats a row. Bound at the training path's shape (causal,
// B 8, H 12, T 2048, D 64): bytes q, k, v, o, dO read once, dq, dk, dv
// written once, lse read once: 8 * 8 * 12 * 2048 * 64 * 4 + 8 * 12 *
// 2048 * 4 = 403.4 MB, 0.120 ms at 3.35 TB/s. Operations: the five
// products the gradient needs (S, dP, dV, dK, dQ), 2 * D flops each per
// visible query-key pair, T (T + 1) / 2 pairs per head when causal:
// 10 * 64 * 96 * 2048 * 2049 / 2 = 128.9 GFLOP (the exponentials not
// counted). As for the forward, the least time takes the card's fastest
// route that meets the fp32 tolerance, 3xTF32 on the tensor cores:
//   max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s) = max(0.120, 0.781)
// = 0.781 ms, bound by operations. These kernels run the products on the
// fp32 FMA pipes instead (1.924 ms at 67 TFLOP/s for the same work), with
// 14/10 of it (the recomputation of S and dP in pass 3).
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
//    accumulator;
//  - P and dS never touch shared memory. In pass 2 each warp owns 16 keys
//    and computes the transposed tiles S^T = K_w Q_i^T and dP^T = V_w
//    dO_i^T: P^T and dS^T then sit in the m16n8k16 accumulator layout,
//    which is the A fragment of the next product as it stands (two n8
//    tiles, keys 2t, 2t + 1 then + 8). In pass 3 each warp owns 16 query
//    rows and S, dP come out the same way;
//  - P's exponential runs on the SFU, `ex2.approx` of the argument times
//    log2(e) folded into the FMA that forms it (about 2^-22 relative,
//    against expf's eight instructions an element);
//  - tiles stay bf16 in shared memory, rows of D + 8 (16 bytes of
//    padding: the eight 16-byte rows an ldmatrix reads hit distinct
//    banks), loaded with cp.async 16 bytes a copy (4 for lse and Dv) and
//    zero-filled past T; the next Q/dO block (pass 2) or K/V block
//    (pass 3) loads into a second stage while this one computes. So q,
//    k, v and dO need 16-byte aligned base addresses and strides.
// 4 warps a CTA, three CTAs an SM below D 128. Bound at the same shape in
// bf16: bytes 8 tensors of 96 * 2048 * 64 bf16 plus lse = 202.1 MB,
// 0.060 ms; operations 128.9 GFLOP at 989 TFLOP/s bf16, 0.130 ms: bound
// 0.130 ms, by operations. This kernel does 8 products of 2 * D flops
// per visible pair (S, dP, and two each for dV, dK and dQ), 10 with pass
// 3's recomputation of S and dP, so its own floor on the tensor cores is
// 10/5 * 0.130 = 0.26 ms; mma.sync does not reach wgmma's peak rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;                // query rows and keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kPB = kB + 4;           // padded row of P and dS
constexpr int kDotWarps = 8;

template <int D>
constexpr int dkdv_smem_floats() {
  // K, V, Q, dO tiles; P^T and dS^T; lse and Dv of the query block
  return 4 * kB * (D + 4) + 2 * kB * kPB + 2 * kB;
}

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles; dS; lse and Dv of the query block
  return 4 * kB * (D + 4) + kB * kPB + 2 * kB;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [row0, row0 + kB) of a (T, D) f32 slice with row stride `st` into
// a padded tile; rows past T are zero
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          int64_t st, int row0, int T) {
  constexpr int P = D + 4;
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D, row = row0 + r;
    s[r * P + c] = row < T ? g[static_cast<int64_t>(row) * st + c] : 0.f;
  }
}

// lse and Dv of query rows [q0, q0 + kB); zero past Tq (those rows are
// masked)
__device__ __forceinline__ void load_rows(float* sL, float* sDv,
                                          const float* lse, const float* dv,
                                          int q0, int Tq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const bool in = q0 + r < Tq;
    sL[r] = in ? lse[q0 + r] : 0.f;
    sDv[r] = in ? dv[q0 + r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's 4 x 4 (row ty + 16r, key
// tx + 16c) of the 64 x 64 tile, unscaled
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qa[4], oa[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * r) * P + d);
      oa[r] = *reinterpret_cast<const float4*>(sdO + (ty + 16 * r) * P + d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 kb =
          *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * P + d);
      const float4 vb =
          *reinterpret_cast<const float4*>(sV + (tx + 16 * c) * P + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float a = s[r][c], b = dp[r][c];
        a = fmaf(qa[r].x, kb.x, a);
        a = fmaf(qa[r].y, kb.y, a);
        a = fmaf(qa[r].z, kb.z, a);
        a = fmaf(qa[r].w, kb.w, a);
        b = fmaf(oa[r].x, vb.x, b);
        b = fmaf(oa[r].y, vb.y, b);
        b = fmaf(oa[r].z, vb.z, b);
        b = fmaf(oa[r].w, vb.w, b);
        s[r][c] = a;
        dp[r][c] = b;
      }
    }
  }
}

// P = exp(scale * S - lse) and dS = P * (dP - Dv) of this thread's 4 x 4,
// zero where masked (a key past Tk, a row past Tq, a key above the causal
// diagonal), stored transposed (key-major, for dK/dV) or query-major (dQ)
template <bool kKeyMajor>
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* sL, const float* sDv,
                                      float* sP, float* sdS, int ty, int tx,
                                      int q0, int k0, int Tq, int Tk,
                                      float scale, int causal) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qr = ty + 16 * r, qg = q0 + qr;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kc = tx + 16 * c, kg = k0 + kc;
      const bool ok = qg < Tq && kg < Tk && (!causal || kg <= qg);
      const float p = ok ? expf(fmaf(scale, s[r][c], -sL[qr])) : 0.f;
      const float ds = p * (dp[r][c] - sDv[qr]);
      if constexpr (kKeyMajor) {
        sP[kc * kPB + qr] = p;
        sdS[kc * kPB + qr] = ds;
      } else {
        sdS[qr * kPB + kc] = ds;
      }
    }
  }
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

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args<float> a) {
  constexpr int P = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kB * P;
  float* sQ = sV + kB * P;
  float* sdO = sQ + kB * P;
  float* sP = sdO + kB * P;     // key-major: [key][query]
  float* sdS = sP + kB * kPB;
  float* sL = sdS + kB * kPB;
  float* sDv = sL + kB;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // the heaviest key block (the first, when causal) first
  const int bh = blockIdx.x % a.BH, kb = blockIdx.x / a.BH;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kb * kB;
  const int64_t* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[1];
  const float* kbase = a.k + b * st[3] + h * st[4];
  const float* vb = a.v + b * st[6] + h * st[7];
  const float* gb = a.dout + b * st[12] + h * st[13];
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Tq;
  const float* dvec = a.dvec + static_cast<int64_t>(bh) * a.Tq;

  load_tile<D>(sK, kbase, st[5], k0, a.Tk);
  load_tile<D>(sV, vb, st[8], k0, a.Tk);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  const int n_qb = (a.Tq + kB - 1) / kB;
  // causal needs Tq == Tk: rows below k0 see none of these keys
  for (int qb_i = a.causal ? k0 / kB : 0; qb_i < n_qb; ++qb_i) {
    const int q0 = qb_i * kB;
    load_tile<D>(sQ, qb, st[2], q0, a.Tq);
    load_tile<D>(sdO, gb, st[14], q0, a.Tq);
    load_rows(sL, sDv, lse, dvec, q0, a.Tq);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(sQ, sdO, sK, sV, ty, tx, s, dp);
    probs<true>(s, dp, sL, sDv, sP, sdS, ty, tx, q0, k0, a.Tq, a.Tk,
                a.scale, a.causal);
    __syncthreads();
#pragma unroll 2
    for (int qq = 0; qq < kB; qq += 4) {
      float4 pr[4], dsr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = *reinterpret_cast<const float4*>(sP + (ty + 16 * r) * kPB + qq);
        dsr[r] =
            *reinterpret_cast<const float4*>(sdS + (ty + 16 * r) * kPB + qq);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float go = sdO[(qq + i) * P + tx + 16 * c];
          const float qv = sQ[(qq + i) * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pv = i == 0 ? pr[r].x : i == 1 ? pr[r].y
                           : i == 2 ? pr[r].z : pr[r].w;
            const float dsv = i == 0 ? dsr[r].x : i == 1 ? dsr[r].y
                            : i == 2 ? dsr[r].z : dsr[r].w;
            dv[r][c] = fmaf(pv, go, dv[r][c]);
            dk[r][c] = fmaf(dsv, qv, dk[r][c]);
          }
        }
      }
    }
    __syncthreads();   // the next block's loads overwrite Q, dO, P, dS
  }

  float* dkb = a.dk + b * st[18] + h * st[19];
  float* dvb = a.dv + b * st[21] + h * st[22];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[static_cast<int64_t>(key) * st[20] + tx + 16 * c] =
          a.scale * dk[r][c];
      dvb[static_cast<int64_t>(key) * st[23] + tx + 16 * c] = dv[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args<float> a) {
  constexpr int P = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kB * P;
  float* sK = sdO + kB * P;
  float* sV = sK + kB * P;
  float* sdS = sV + kB * P;     // query-major: [query][key]
  float* sL = sdS + kB * kPB;
  float* sDv = sL + kB;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_qb = (a.Tq + kB - 1) / kB;
  // the heaviest query block (the last, when causal) first
  const int bh = blockIdx.x % a.BH, qb_i = n_qb - 1 - blockIdx.x / a.BH;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qb_i * kB;
  const int64_t* st = a.st;
  const float* kbase = a.k + b * st[3] + h * st[4];
  const float* vb = a.v + b * st[6] + h * st[7];

  load_tile<D>(sQ, a.q + b * st[0] + h * st[1], st[2], q0, a.Tq);
  load_tile<D>(sdO, a.dout + b * st[12] + h * st[13], st[14], q0, a.Tq);
  load_rows(sL, sDv, a.lse + static_cast<int64_t>(bh) * a.Tq,
            a.dvec + static_cast<int64_t>(bh) * a.Tq, q0, a.Tq);

  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;

  // keys these rows can see: [0, kv_end)
  const int kv_end = a.causal ? min(q0 + kB, a.Tk) : a.Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    load_tile<D>(sK, kbase, st[5], k0, a.Tk);
    load_tile<D>(sV, vb, st[8], k0, a.Tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(sQ, sdO, sK, sV, ty, tx, s, dp);
    probs<false>(s, dp, sL, sDv, nullptr, sdS, ty, tx, q0, k0, a.Tq, a.Tk,
                 a.scale, a.causal);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kB; kk += 4) {
      float4 dsr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dsr[r] =
            *reinterpret_cast<const float4*>(sdS + (ty + 16 * r) * kPB + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float kv = sK[(kk + i) * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float dsv = i == 0 ? dsr[r].x : i == 1 ? dsr[r].y
                            : i == 2 ? dsr[r].z : dsr[r].w;
            dq[r][c] = fmaf(dsv, kv, dq[r][c]);
          }
        }
      }
    }
    __syncthreads();   // the next block's loads overwrite K, V, dS
  }

  float* dqb = a.dq + b * st[15] + h * st[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dqb[static_cast<int64_t>(row) * st[17] + tx + 16 * c] =
          a.scale * dq[r][c];
  }
}

// fp32 on the FMA kernels
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

  constexpr size_t smem1 = dkdv_smem_floats<D>() * sizeof(float);
  err = cudaFuncSetAttribute(dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  const int64_t n_kb = (a.Tk + kB - 1) / kB;
  dkdv_kernel<D><<<static_cast<unsigned>(n_kb * a.BH), kThreads, smem1,
                   stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem2 = dq_smem_floats<D>() * sizeof(float);
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const int64_t n_qb = (a.Tq + kB - 1) / kB;
  dq_kernel<D><<<static_cast<unsigned>(n_qb * a.BH), kThreads, smem2,
                 stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarpsB = 4;            // 16 rows (pass 3) or keys (pass 2) each
constexpr int kThreadsB = kWarpsB * 32;

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
  for (int e = threadIdx.x; e < kB * C8; e += kThreadsB) {
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
__global__ void __launch_bounds__(kThreadsB, D < 128 ? 3 : 2)
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
    // kThreadsB == 2 * kB: one f32 copy a thread
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
__global__ void __launch_bounds__(kThreadsB, D < 128 ? 3 : 2)
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
  dkdv_bf16_kernel<D><<<static_cast<unsigned>(n_kb * a.BH), kThreadsB, smem1,
                        stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem2 = dq_bf16_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return err;
  const int64_t n_qb = (a.Tq + kB - 1) / kB;
  dq_bf16_kernel<D><<<static_cast<unsigned>(n_qb * a.BH), kThreadsB, smem2,
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
// dvec: f32 (B, H, Tq) scratch. Causal needs Tq == Tk. `_bf16` copies q,
// k, v and dout 16 bytes at a time (cp.async): their base addresses and
// (batch, head, token) strides must be multiples of 16 bytes; `_f32` and
// o take any strides. The caller checks shapes, strides, alignment and
// that (Tq or Tk) / 64 times B * H fits a grid.
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
