// Blockwise (flash) attention backward, fp32, sm_90a: dQ, dK and dV of
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
// Three launches, one stream:
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
// Two passes recompute S and dP twice (14 instead of 10 products of
// T x T x D per head) but write every gradient once from one CTA: no
// atomicAdd into dQ, so the result is the same bits run to run.
//
// Arithmetic: fp32 FMA on the CUDA cores, one rounding per multiply-add,
// so the result sits within the fp32 tolerance of the plain version
// (ops/attention.py `flash_attention_bwd_plain`) with no TF32 splitting.
// 256 threads as a 16 x 16 grid; each thread owns 4 x 4 scores (rows
// ty + 16r, keys tx + 16c) and 4 x D/16 outputs (rows ty + 16r, columns
// tx + 16c). Rows in shared memory are padded to D + 4 floats, so the
// float4 reads of the score products hit distinct banks in each quarter
// warp; P and dS are stored 68 floats a row.
//
// Bound on this card at the training path's shape (causal, B 8, H 12,
// T 2048, D 64). Bytes: q, k, v, o, dO read once, dq, dk, dv written once,
// lse read once: 8 * 8 * 12 * 2048 * 64 * 4 + 8 * 12 * 2048 * 4 bytes
// = 403.4 MB, 0.120 ms at 3.35 TB/s. Operations: the five products the
// gradient needs (S, dP, dV, dK, dQ), 2 * D flops each per visible
// query-key pair, T (T + 1) / 2 pairs per head when causal:
// 10 * 64 * 96 * 2048 * 2049 / 2 = 128.9 GFLOP (the exponentials not
// counted). As for the forward, the least time takes the card's fastest
// route that meets the fp32 tolerance, 3xTF32 on the tensor cores (three
// TF32 products each):
//   max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s) = max(0.120, 0.781)
// = 0.781 ms, bound by operations. This kernel runs the products on the
// fp32 FMA pipes instead, where the same work could take no less than
// 1.924 ms (67 TFLOP/s), and does 14/10 of that work (the recomputation
// of S and dP in pass 3).
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

// rows [row0, row0 + kB) of a (T, D) slice with row stride `st` into a
// padded tile; rows past T are zero
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

template <int D>
__global__ void __launch_bounds__(kDotWarps * 32)
    bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ dvec, int H, int Tq, int rows,
               int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t g_sb,
               int64_t g_sh, int64_t g_st) {
  const int row = blockIdx.x * kDotWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int tok = row % Tq, bh = row / Tq, b = bh / H, h = bh % H;
  const float* orow = o + b * o_sb + h * o_sh + tok * o_st;
  const float* grow = dout + b * g_sb + h * g_sh + tok * g_st;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], grow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *dvec;
  float *dq, *dk, *dv;
  int H, BH, Tq, Tk;
  int64_t st[24];   // (batch, head, token) of q, k, v, o, dO, dq, dk, dv
  float scale;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
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
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
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

template <int D>
cudaError_t launch(const Args& a, const float* o, int B,
                   cudaStream_t stream) {
  const int rows = a.BH * a.Tq;
  bwd_dot_kernel<D><<<(rows + kDotWarps - 1) / kDotWarps, kDotWarps * 32, 0,
                  stream>>>(o, a.dout, const_cast<float*>(a.dvec), a.H,
                            a.Tq, rows, a.st[9], a.st[10], a.st[11],
                            a.st[12], a.st[13], a.st[14]);
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

}  // namespace

// q/k/v/o/dout in and dq/dk/dv out: (B, H, T, D) fp32 with element strides
// (batch, head, token) in `strides` = {q, k, v, o, dout, dq, dk, dv} x
// {sb, sh, st} and unit stride along D. lse: the forward's f32 (B, H, Tq)
// contiguous row log-sum-exp; dvec: f32 (B, H, Tq) scratch. Causal needs
// Tq == Tk; the caller checks shapes, strides and that (Tq or Tk) / 64
// times B * H fits a grid. Returns the first CUDA error of the three
// launches (0 on success), or cudaErrorInvalidValue for an unsupported
// head size.
extern "C" int mxt_flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dvec, float* dq, float* dk,
    float* dv, int B, int H, int Tq, int Tk, int D, const int64_t* strides,
    float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
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
      return launch<16>(a, o, B, s);
    case 32:
      return launch<32>(a, o, B, s);
    case 64:
      return launch<64>(a, o, B, s);
    case 128:
      return launch<128>(a, o, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}
