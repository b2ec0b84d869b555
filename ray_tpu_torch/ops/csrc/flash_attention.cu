// Flash attention for Hopper (sm_90a): forward (with and without the
// log-sum-exp residual) and the two tiled backward kernels.
//
// Replaces the four Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   bf16 inputs (the train step's)        f32 inputs
//   fwd_kernel_tc<.., WRITE_LSE=false>    fwd_kernel<.., WRITE_LSE=false>  <- _attn_fwd_kernel      (B1)
//   fwd_kernel_tc<.., WRITE_LSE=true>     fwd_kernel<.., WRITE_LSE=true>   <- _attn_fwd_kernel_lse  (B2)
//   bwd_dq_kernel_tc                      bwd_dq_kernel                    <- _attn_bwd_dq_kernel   (B3)
//   bwd_dkv_kernel_tc                     bwd_dkv_kernel                   <- _attn_bwd_dkv_kernel  (B4)
//
// Layout [BH, T, D] for q/do/o and [BH, S, D] for k/v, row-major and
// contiguous; lse and delta are [BH, T] f32; dq, dk and dv are f32. D is 64
// or 128. All sums are f32.
//
// What bounds them on the card. The least time for the work is set by the
// bytes at the train step's shape (causal, T = 1024, D = 64: ~256 flops per
// byte moved, in the forward and in each backward kernel, just under the
// ~295 at which an H100's bf16 tensor cores stop waiting on memory), so a
// fast kernel reads each input once and keeps everything O(T*S) on chip.
//
// The tensor-core kernels (*_tc, bf16 only; second half of this file). Their
// products run on mma.sync m16n8k16 (bf16 operands, f32 sums), fed from
// shared memory by ldmatrix, and the streamed tiles arrive by cp.async into
// a two-stage ring, so the next tile's load overlaps this tile's products.
//   * Exactness. q, k, v and do are bf16, so their products are exact in f32
//     and S = q.k^T and dP = do.v^T match the f32 plain versions up to the
//     order of the sums. P (in P.V and P^T.dO) and dS (in dS.K and dS^T.Q)
//     are f32 values made on chip; rounded once to bf16 they would miss the
//     limits of chip_smoke.py several times over (tests/test_torch_ops.py,
//     test_tensor_core_operands_need_the_hi_lo_split). Each is split into
//     hi = bf16(x) and lo = bf16(x - hi), both multiplied into the same f32
//     sum: the error falls to ~2^-16 of x, and the kernels compute what the
//     TPU kernels' f32 dots compute. The split costs 1.5x the useful tensor
//     flops, still far under the bound set by the bytes.
//   * mma.sync, not wgmma: P and dS are made in registers, and mma.sync takes
//     its A operand in the layout of its own accumulator, so both terms of
//     the split go straight from registers into the next product.
//   * Tiles of 64 rows, 4 warps, each warp owning 16 rows of the block's
//     resident operand (q rows in the forward and bwd_dq, k rows in
//     bwd_dkv), whose fragments and sums stay in registers. Shared
//     rows are padded by 16 bytes so the 8 row addresses of an ldmatrix hit
//     8 distinct bank groups. Rows at or past T or S are zero-filled by
//     cp.async (src-size 0), never read: in a flat [BH*T, D] view they would
//     be the next head's rows.
//   * The backward kernels walk each streamed tile in chunks of 16 columns
//     (q columns in bwd_dkv, keys in bwd_dq): S, dP, P and dS of a chunk
//     live in 8 registers each, so only the warp's own rows stay resident
//     (dK and dV in bwd_dkv; Q, dO and dQ fragments in bwd_dq), and D = 128
//     fits 4 warps without a spill. On the causal diagonal, bwd_dq skips the
//     chunks that lie wholly above the warp's rows.
//   * Tile loads are unrolled to a fixed count per thread: a loop bounded by
//     threadIdx.x compiles to ~300 instructions with branches per tile.
// f32 inputs keep the first kernels below: the tensor cores take f32 only as
// TF32 or through a three-way bf16 split, and the f32 path exists for the
// tests.
//
// The first kernels (f32 only) do their arithmetic on the f32 CUDA cores
// (67 TFLOP/s, not the tensor cores' 989), and that is what bounds them: a
// forward at the train shape is 13 GFLOP, at least 0.19 ms there.
// What their design does about it:
//   * The TPU kernels carry the online-softmax state (m, l, acc) in VMEM
//     scratch from one sequential grid step to the next. Blocks on Hopper
//     run in no order, so each block owns one q tile (one k tile for dkv)
//     and walks the other axis in a loop inside the block, with the running
//     state in registers. Nothing O(T*S) ever reaches device memory, and
//     no atomics are needed: every output row is written by one block.
//   * Each tile of q, k, v (and do) is staged once in shared memory as f32
//     and reused by all 256 threads; a thread computes a 4x4 patch of the
//     64x64 score tile (rows ty*4+i, columns tx+16*j), so eight shared-memory
//     loads feed sixteen multiply-adds. Rows are padded to D+1 floats so the 16
//     lanes of a row group read 16 different banks.
//   * Causal tiles strictly above the diagonal are skipped, as the TPU
//     kernels skip them; rows past T or S are loaded as 0 and masked, never
//     read from device memory (0 * NaN would poison a sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads: 16 row groups (ty) x 16 lanes (tx)
constexpr float BIG_NEG = -1e30f;  // masked score, as _BIG_NEG in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [row0, row0 + 64) of an [n, D] matrix into a [64][D + 1] f32
// tile. Rows at or past n are written as 0 and never read from memory.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int n) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? to_f32(src[static_cast<size_t>(g) * D + c]) : 0.f;
  }
}

// Reductions over the 16 lanes that share a row group (half a warp).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------- forward
// Replaces _attn_fwd_kernel (WRITE_LSE = false) and _attn_fwd_kernel_lse
// (WRITE_LSE = true). One block per (q tile, bh); online softmax over the k
// tiles, as the TPU kernel does over its innermost grid axis.
template <typename T, int D, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int seq_q, int seq_k, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][LD]
  float* ks = qs + BQ * LD;   // [BK][LD]
  float* vs = ks + BK * LD;   // [BK][LD]
  float* ps = vs + BK * LD;   // [BQ][LP]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += static_cast<size_t>(bh) * seq_q * D;
  o += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;

  load_tile<T, D>(qs, q, q0, seq_q);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (seq_k + BK - 1) / BK;
  if (CAUSAL) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    load_tile<T, D>(ks, k, k0, seq_k);
    load_tile<T, D>(vs, v, k0, seq_k);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mc = BIG_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < seq_k && (!CAUSAL || qp >= kp);
        s[i][j] = ok[j] ? s[i][j] * scale : BIG_NEG;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(mc));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = vs[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= seq_q) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      o[static_cast<size_t>(qp) * D + tx + 16 * jj] = from_f32<T>(acc[i][jj] / lsafe);
    if (WRITE_LSE && tx == 0) lse[static_cast<size_t>(bh) * seq_q + qp] = m[i] + logf(lsafe);
  }
}

// ------------------------------------------------------------ backward dq
// Replaces _attn_bwd_dq_kernel (tile math of _bwd_tile). One block per
// (q tile, bh); loops over k tiles. Per tile it re-derives
// p = exp(s - lse) and ds = p * (do.v^T - delta) * scale, then dq += ds.k.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int seq_q, int seq_k, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ks = dos + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* dss = vs + BK * LD;    // [BQ][LP]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += static_cast<size_t>(bh) * seq_q * D;
  dout += static_cast<size_t>(bh) * seq_q * D;
  dq += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;
  lse += static_cast<size_t>(bh) * seq_q;
  delta += static_cast<size_t>(bh) * seq_q;

  load_tile<T, D>(qs, q, q0, seq_q);
  load_tile<T, D>(dos, dout, q0, seq_q);

  float lr[4], dl[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    lr[i] = qp < seq_q ? lse[qp] : 0.f;
    dl[i] = qp < seq_q ? delta[qp] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (seq_k + BK - 1) / BK;
  if (CAUSAL) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(ks, k, k0, seq_k);
    load_tile<T, D>(vs, v, k0, seq_k);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * LD + d];
        g[i] = dos[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(tx + 16 * j) * LD + d];
        w[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < seq_k && qp < seq_q && (!CAUSAL || qp >= kp);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(ty * 4 + i) * LP + tx + 16 * j] = ok ? p * (dp[i][j] - dl[i]) * scale : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float kv = ks[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(ds[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= seq_q) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dq[static_cast<size_t>(qp) * D + tx + 16 * jj] = acc[i][jj];
  }
}

// ----------------------------------------------------------- backward dkv
// Replaces _attn_bwd_dkv_kernel. One block per (k tile, bh); loops over the
// q tiles that can see it, so dk and dv need no atomics. The
// score tile is computed transposed (k rows x q columns) so that each
// thread's rows are the k rows whose dk and dv it accumulates.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int seq_q, int seq_k, float scale) {
  constexpr int LD = D + 1, LP = BQ + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* qs = vs + BK * LD;     // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ps = dos + BQ * LD;    // [BK][LP]  p transposed
  float* dss = ps + BK * LP;    // [BK][LP]  ds transposed
  float* ls = dss + BK * LP;    // [BQ] lse of the q tile
  float* dls = ls + BQ;         // [BQ] delta of the q tile

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += static_cast<size_t>(bh) * seq_q * D;
  dout += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;
  dk += static_cast<size_t>(bh) * seq_k * D;
  dv += static_cast<size_t>(bh) * seq_k * D;
  lse += static_cast<size_t>(bh) * seq_q;
  delta += static_cast<size_t>(bh) * seq_q;

  load_tile<T, D>(ks, k, k0, seq_k);
  load_tile<T, D>(vs, v, k0, seq_k);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int nq = (seq_q + BQ - 1) / BQ;
  // The reference's skip: q tile qi sees k tile ki iff qi*bq + bq - 1 >= ki*bk.
  const int qt0 = CAUSAL ? k0 / BQ : 0;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D>(qs, q, q0, seq_q);
    load_tile<T, D>(dos, dout, q0, seq_q);
    if (threadIdx.x < BQ) {
      const int qp = q0 + threadIdx.x;
      ls[threadIdx.x] = qp < seq_q ? lse[qp] : 0.f;
      dls[threadIdx.x] = qp < seq_q ? delta[qp] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty * 4 + i) * LD + d];
        w[i] = vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qs[(tx + 16 * j) * LD + d];
        g[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qp = q0 + r;
        const bool ok = kp < seq_k && qp < seq_q && (!CAUSAL || qp >= kp);
        const float p = ok ? expf(s[i][j] * scale - ls[r]) : 0.f;
        ps[(ty * 4 + i) * LP + r] = p;
        dss[(ty * 4 + i) * LP + r] = ok ? p * (dp[i][j] - dls[r]) * scale : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ps[(ty * 4 + i) * LP + c];
        ds[i] = dss[(ty * 4 + i) * LP + c];
      }
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float g = dos[c * LD + tx + 16 * jj];
        const float a = qs[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][jj] = fmaf(p[i], g, dva[i][jj]);
          dka[i][jj] = fmaf(ds[i], a, dka[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= seq_k) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk[static_cast<size_t>(kp) * D + tx + 16 * jj] = dka[i][jj];
      dv[static_cast<size_t>(kp) * D + tx + 16 * jj] = dva[i][jj];
    }
  }
}

// ================================================= tensor-core kernels (bf16)

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // 4 warps, 16 rows of the resident tile each
constexpr int TC_LD_PAD = 8;     // bf16 per shared row past D: 16 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in the background; zero-filled when !valid, and
// then `src` is not read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the row address of
// row i % 8 of matrix i / 8. With .trans each lane gets a column pair
// instead of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a.b for one 16x8 tile: a 16x16 (row), b 16x8 (col), bf16, f32 sum.
// Lane (g = lane / 4, t = lane % 4) holds c at rows g, g + 8 and columns
// 2t, 2t + 1: c[0], c[1] on row g, c[2], c[3] on row g + 8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two adjacent 16x8 tiles that share one A fragment: b as ldsm_x4 gives it.
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_16816(c0, a, b[0], b[1]);
  mma_16816(c1, a, b[2], b[3]);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}
// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16((x, y) - hi), the
// difference taken in f32 (exact). x goes in the low half, the lower column.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}
// The A fragments (hi and lo) of a 16x16 tile held as the accumulators of
// its two 16x8 halves: mma's A layout is its accumulator layout.
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + ROWS) of an [n, D] bf16 matrix into shared rows of
// D + TC_LD_PAD, by cp.async; rows at or past n are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* __restrict__ src, int row0, int n) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % TC_THREADS == 0, "every thread copies the same count");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / TC_THREADS; ++i) {
    const int e = threadIdx.x + i * TC_THREADS, r = e / CHUNKS, c = e % CHUNKS, g = row0 + r;
    cp_async_16(dst + r * (D + TC_LD_PAD) + c * 8, src + static_cast<size_t>(g < n ? g : 0) * D + c * 8,
                g < n);
  }
}

// Lane offsets into a 16x16 tile for ldsm_x4: (A_ROW, A_COL) gives the four
// matrices in A-fragment order (rows 0-7 | 8-15, then columns 8-15), which is
// also the B order of a [k][n] tile loaded with .trans; (N_ROW, N_COL) gives
// the B fragments of two 8-wide n tiles from an [n][k] tile.
__device__ __forceinline__ int a_row(int lane) { return lane % 8 + 8 * (lane / 8 % 2); }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int n_row(int lane) { return lane % 8 + 8 * (lane / 16); }
__device__ __forceinline__ int n_col(int lane) { return 8 * (lane / 8 % 2); }

// One k tile of the forward's online softmax for this lane's rows r0 and
// r0 + 8: scale S (MASK: masked entries -> BIG_NEG), fold the tile into the
// running max m and this lane's part l of the row sum, rescale acc, and leave
// P = exp(S - m) (0 where masked) in s. c0 is the k position of s[0][0].
// Without a mask the scale is applied inside exp's argument, one FMA: scale
// > 0, so the max of the scaled row is the scaled max of the row.
template <bool MASK, bool CAUSAL, int NT, int DT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&acc)[DT][4], float (&m)[2],
                                               float (&l)[2], int r0, int c0, int seq_k, float scale) {
  auto ok = [&](int j, int e) {
    const int qp = r0 + 8 * (e / 2), kp = c0 + j * 8 + e % 2;
    return kp < seq_k && (!CAUSAL || qp >= kp);
  };
  float mx[2] = {BIG_NEG, BIG_NEG};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) s[j][e] = ok(j, e) ? s[j][e] * scale : BIG_NEG;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], MASK ? quad_max(mx[r]) : quad_max(mx[r]) * scale);
    alpha[r] = expf(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK)
        s[j][e] = ok(j, e) ? expf(s[j][e] - m[e / 2]) : 0.f;
      else
        s[j][e] = expf(fmaf(s[j][e], scale, -m[e / 2]));
      l[e / 2] += s[j][e];
    }
}

// ------------------------------------------------------- forward (tensor cores)
// Replaces _attn_fwd_kernel (WRITE_LSE = false) and _attn_fwd_kernel_lse
// (WRITE_LSE = true) for bf16. One block per (64-row q tile, bh); warp w
// owns q rows 16w..16w+15 and keeps their Q fragments in registers. K and V
// tiles stream through a two-stage ring. Per tile: S = Q.K^T (f32), scale
// and mask, online max and sum (a row spans the 4 lanes of a quad), then
// acc += P_hi.V + P_lo.V.
template <int D, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(TC_THREADS) fwd_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int seq_q, int seq_k, float scale) {
  constexpr int LD = D + TC_LD_PAD, KC = D / 16, NT = BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tc_smem_fwd[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem_fwd);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                          // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                      // [2][BK][LD]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tg = lane % 4;
  const int r0 = q0 + warp * 16 + lane / 4;  // this lane's rows: r0 and r0 + 8
  q += static_cast<size_t>(bh) * seq_q * D;
  o += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;

  int n_kv_tiles = (seq_k + BK - 1) / BK;
  if (CAUSAL) n_kv_tiles = min(n_kv_tiles, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  tile_async<BQ, D>(qs, q, q0, seq_q);
  cp_async_commit();
  tile_async<BK, D>(ks, k, 0, seq_k);
  tile_async<BK, D>(vs, v, 0, seq_k);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[kc], qs + (warp * 16 + a_row(lane)) * LD + kc * 16 + a_col(lane));

  float acc[DT][4] = {};
  float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};  // l: this lane's part of the row sum

  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    cp_async_wait<0>();  // tile kt is in, for every thread after the barrier, which
    __syncthreads();     // also means every warp is done with tile kt - 1's stage
    if (kt + 1 < n_kv_tiles) {  // so the next tile loads there while this one is multiplied
      tile_async<BK, D>(ks + (st ^ 1) * BK * LD, k, k0 + BK, seq_k);
      tile_async<BK, D>(vs + (st ^ 1) * BK * LD, v, k0 + BK, seq_k);
      cp_async_commit();
    }
    const bf16* kst = ks + st * BK * LD;
    const bf16* vst = vs + st * BK * LD;

    float s[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, kst + (j * 16 + n_row(lane)) * LD + kc * 16 + n_col(lane));
        mma_pair(s[2 * j], s[2 * j + 1], qf[kc], b);
      }

    // Only a tile on the diagonal or past seq_k has masked entries.
    if (k0 + BK > seq_k || (CAUSAL && k0 + BK - 1 > q0))
      online_softmax<true, CAUSAL>(s, acc, m, l, r0, k0 + 2 * tg, seq_k, scale);
    else
      online_softmax<false, CAUSAL>(s, acc, m, l, r0, k0 + 2 * tg, seq_k, scale);

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {  // 16 keys of P at a time
      uint32_t p_hi[4], p_lo[4];
      split_a(s[2 * kc], s[2 * kc + 1], p_hi, p_lo);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, vst + (kc * 16 + a_row(lane)) * LD + j * 16 + a_col(lane));
        mma_pair(acc[2 * j], acc[2 * j + 1], p_hi, b);
        mma_pair(acc[2 * j], acc[2 * j + 1], p_lo, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    const float lsafe = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qp >= seq_q) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(qp) * D + j * 8 + 2 * tg) =
          __floats2bfloat162_rn(acc[j][2 * r] / lsafe, acc[j][2 * r + 1] / lsafe);
    if (WRITE_LSE && tg == 0) lse[static_cast<size_t>(bh) * seq_q + qp] = m[r] + logf(lsafe);
  }
}

// P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta) scale of one
// 16 x 16 chunk (k rows x q columns), in place of S^T in s and dP^T in dp;
// 0 where masked (MASK). i0 is the column of s[0][0] within the q tile, r0
// this lane's first k row.
template <bool MASK, bool CAUSAL>
__device__ __forceinline__ void chunk_grads(float (&s)[2][4], float (&dp)[2][4], const float* lst,
                                            const float* dlst, int i0, int r0, int q0, int seq_q,
                                            int seq_k, float scale) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + j * 8 + e % 2, kp = r0 + 8 * (e / 2), qp = q0 + i;
      const bool ok = !MASK || (kp < seq_k && qp < seq_q && (!CAUSAL || qp >= kp));
      const float p = ok ? expf(s[j][e] * scale - lst[i]) : 0.f;
      s[j][e] = p;
      dp[j][e] = ok ? p * (dp[j][e] - dlst[i]) * scale : 0.f;
    }
}

// P = exp(S * scale - lse) and dS = P (dP - delta) scale of one 16 x 16
// chunk (q rows x k columns), in place of dP in dp; 0 where masked (MASK).
// r0 is this lane's first q row, c0 the k position of s[0][0]; lr and dl
// hold the lse and delta of rows r0 and r0 + 8.
template <bool MASK, bool CAUSAL>
__device__ __forceinline__ void chunk_grads_q(const float (&s)[2][4], float (&dp)[2][4],
                                              const float (&lr)[2], const float (&dl)[2], int r0,
                                              int c0, int seq_k, float scale) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = r0 + 8 * (e / 2), kp = c0 + j * 8 + e % 2;
      const bool ok = !MASK || (kp < seq_k && (!CAUSAL || qp >= kp));
      const float p = expf(s[j][e] * scale - lr[e / 2]);
      dp[j][e] = ok ? p * (dp[j][e] - dl[e / 2]) * scale : 0.f;
    }
}

// ------------------------------------------------- backward dq (tensor cores)
// Replaces _attn_bwd_dq_kernel for bf16. One block per (64-row q tile, bh);
// warp w owns q rows 16w..16w+15 and keeps their Q and dO fragments, lse,
// delta and dQ in registers. K and V tiles stream through a two-stage ring.
// Each k tile is taken 16 keys at a time: S = Q.K^T and dP = dO.V^T, P and
// dS in registers, then dQ += dS_hi.K + dS_lo.K. Rows past T are computed
// from zeros and never written: a dq row depends on its own dS row only.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 3 : 1) bwd_dq_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int seq_q, int seq_k, float scale) {
  constexpr int LD = D + TC_LD_PAD, KC = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tc_smem_dq[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem_dq);  // [BQ][LD]
  bf16* dos = qs + BQ * LD;                        // [BQ][LD]
  bf16* ks = dos + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tg = lane % 4;
  const int r0 = q0 + warp * 16 + lane / 4;  // this lane's rows: r0 and r0 + 8
  q += static_cast<size_t>(bh) * seq_q * D;
  dout += static_cast<size_t>(bh) * seq_q * D;
  dq += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;
  lse += static_cast<size_t>(bh) * seq_q;
  delta += static_cast<size_t>(bh) * seq_q;

  int n_k_tiles = (seq_k + BK - 1) / BK;
  if (CAUSAL) n_k_tiles = min(n_k_tiles, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal tile

  tile_async<BQ, D>(qs, q, q0, seq_q);
  tile_async<BQ, D>(dos, dout, q0, seq_q);
  cp_async_commit();
  tile_async<BK, D>(ks, k, 0, seq_k);
  tile_async<BK, D>(vs, v, 0, seq_k);
  cp_async_commit();
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    lr[r] = qp < seq_q ? lse[qp] : 0.f;
    dl[r] = qp < seq_q ? delta[qp] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KC][4], dof[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ldsm_x4(qf[kc], qs + (warp * 16 + a_row(lane)) * LD + kc * 16 + a_col(lane));
    ldsm_x4(dof[kc], dos + (warp * 16 + a_row(lane)) * LD + kc * 16 + a_col(lane));
  }

  float dqa[DT][4] = {};

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    cp_async_wait<0>();  // tile kt is in, for every thread after the barrier, which
    __syncthreads();     // also means every warp is done with tile kt - 1's stage
    if (kt + 1 < n_k_tiles) {  // so the next tile loads there while this one is multiplied
      tile_async<BK, D>(ks + (st ^ 1) * BK * LD, k, k0 + BK, seq_k);
      tile_async<BK, D>(vs + (st ^ 1) * BK * LD, v, k0 + BK, seq_k);
      cp_async_commit();
    }
    const bf16* kst = ks + st * BK * LD;
    const bf16* vst = vs + st * BK * LD;
    // Only a tile on the diagonal or past seq_k has masked entries.
    const bool edge = k0 + BK > seq_k || (CAUSAL && k0 + BK - 1 > q0);

#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {  // 16 keys at a time
      // On the diagonal, a chunk wholly above this warp's rows adds nothing.
      if (CAUSAL && k0 + c * 16 > q0 + warp * 16 + 15) break;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ldsm_x4(b, kst + (c * 16 + n_row(lane)) * LD + kc * 16 + n_col(lane));
        mma_pair(s[0], s[1], qf[kc], b);
        ldsm_x4(b, vst + (c * 16 + n_row(lane)) * LD + kc * 16 + n_col(lane));
        mma_pair(dp[0], dp[1], dof[kc], b);
      }
      if (edge)
        chunk_grads_q<true, CAUSAL>(s, dp, lr, dl, r0, k0 + c * 16 + 2 * tg, seq_k, scale);
      else
        chunk_grads_q<false, CAUSAL>(s, dp, lr, dl, r0, k0 + c * 16 + 2 * tg, seq_k, scale);
      uint32_t ds_hi[4], ds_lo[4];
      split_a(dp[0], dp[1], ds_hi, ds_lo);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, kst + (c * 16 + a_row(lane)) * LD + j * 16 + a_col(lane));
        mma_pair(dqa[2 * j], dqa[2 * j + 1], ds_hi, b);
        mma_pair(dqa[2 * j], dqa[2 * j + 1], ds_lo, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    if (qp >= seq_q) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(dq + static_cast<size_t>(qp) * D + j * 8 + 2 * tg) =
          make_float2(dqa[j][2 * r], dqa[j][2 * r + 1]);
  }
}

// ------------------------------------------------ backward dkv (tensor cores)
// Replaces _attn_bwd_dkv_kernel for bf16. One block per (64-row k tile, bh);
// warp w owns k rows 16w..16w+15 and accumulates their dK and dV in
// registers. Q, dO, lse and delta tiles of the q tiles that can see this k
// tile stream through a two-stage ring. Each q tile is taken 16 q columns
// at a time: S^T = K.Q^T and dP^T = V.dO^T (so the warp's rows are its k
// rows), P^T = exp(S^T * scale - lse) masked, dS^T = P^T (dP^T - delta) scale,
// then dV += P^T_hi.dO + P^T_lo.dO and dK += dS^T_hi.Q + dS^T_lo.Q.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 3 : 1) bwd_dkv_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int seq_q, int seq_k, float scale) {
  constexpr int LD = D + TC_LD_PAD, KC = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tc_smem_dkv[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem_dkv);  // [BK][LD]
  bf16* vs = ks + BK * LD;                          // [BK][LD]
  bf16* qs = vs + BK * LD;                          // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                     // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ] lse
  float* dls = ls + 2 * BQ;                                 // [2][BQ] delta

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tg = lane % 4;
  const int r0 = k0 + warp * 16 + lane / 4;  // this lane's k rows: r0 and r0 + 8
  q += static_cast<size_t>(bh) * seq_q * D;
  dout += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;
  dk += static_cast<size_t>(bh) * seq_k * D;
  dv += static_cast<size_t>(bh) * seq_k * D;
  lse += static_cast<size_t>(bh) * seq_q;
  delta += static_cast<size_t>(bh) * seq_q;

  const int n_q_tiles = (seq_q + BQ - 1) / BQ;
  // The reference's skip: q tile qi sees k tile ki iff qi*bq + bq - 1 >= ki*bk.
  const int qt0 = CAUSAL ? k0 / BQ : 0;

  auto load_q_tile = [&](int stage, int qt) {
    const int q0 = qt * BQ;
    tile_async<BQ, D>(qs + stage * BQ * LD, q, q0, seq_q);
    tile_async<BQ, D>(dos + stage * BQ * LD, dout, q0, seq_q);
    static_assert(2 * BQ == TC_THREADS, "one lse or delta entry per thread");
    const int i = threadIdx.x % BQ, qp = q0 + i;
    const bool is_lse = threadIdx.x < BQ;
    cp_async_4((is_lse ? ls : dls) + stage * BQ + i, (is_lse ? lse : delta) + (qp < seq_q ? qp : 0),
               qp < seq_q);
  };

  tile_async<BK, D>(ks, k, k0, seq_k);
  tile_async<BK, D>(vs, v, k0, seq_k);
  if (qt0 < n_q_tiles) load_q_tile(0, qt0);
  cp_async_commit();

  float dka[DT][4] = {}, dva[DT][4] = {};

  for (int qt = qt0; qt < n_q_tiles; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * BQ;
    cp_async_wait<0>();  // q tile qt is in, for every thread after the barrier, which
    __syncthreads();     // also means every warp is done with the previous stage
    if (qt + 1 < n_q_tiles) {  // so the next q tile loads there while this one is multiplied
      load_q_tile(st ^ 1, qt + 1);
      cp_async_commit();
    }
    const bf16* qst = qs + st * BQ * LD;
    const bf16* dost = dos + st * BQ * LD;
    const float* lst = ls + st * BQ;
    const float* dlst = dls + st * BQ;
    // Only a tile that crosses the diagonal or the end of T or S has masked entries.
    const bool edge = q0 + BQ > seq_q || k0 + BK > seq_k || (CAUSAL && q0 < k0 + BK - 1);

#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {  // 16 q columns at a time
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4], b[4];
        ldsm_x4(ka, ks + (warp * 16 + a_row(lane)) * LD + kc * 16 + a_col(lane));
        ldsm_x4(va, vs + (warp * 16 + a_row(lane)) * LD + kc * 16 + a_col(lane));
        ldsm_x4(b, qst + (c * 16 + n_row(lane)) * LD + kc * 16 + n_col(lane));
        mma_pair(s[0], s[1], ka, b);
        ldsm_x4(b, dost + (c * 16 + n_row(lane)) * LD + kc * 16 + n_col(lane));
        mma_pair(dp[0], dp[1], va, b);
      }
      if (edge)
        chunk_grads<true, CAUSAL>(s, dp, lst, dlst, c * 16 + 2 * tg, r0, q0, seq_q, seq_k, scale);
      else
        chunk_grads<false, CAUSAL>(s, dp, lst, dlst, c * 16 + 2 * tg, r0, q0, seq_q, seq_k, scale);
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      split_a(s[0], s[1], p_hi, p_lo);
      split_a(dp[0], dp[1], ds_hi, ds_lo);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, dost + (c * 16 + a_row(lane)) * LD + j * 16 + a_col(lane));
        mma_pair(dva[2 * j], dva[2 * j + 1], p_hi, b);
        mma_pair(dva[2 * j], dva[2 * j + 1], p_lo, b);
        ldsm_x4_trans(b, qst + (c * 16 + a_row(lane)) * LD + j * 16 + a_col(lane));
        mma_pair(dka[2 * j], dka[2 * j + 1], ds_hi, b);
        mma_pair(dka[2 * j], dka[2 * j + 1], ds_lo, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = r0 + 8 * r;
    if (kp >= seq_k) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const size_t at = static_cast<size_t>(kp) * D + j * 8 + 2 * tg;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[j][2 * r], dka[j][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launchers

// Every kernel takes more than the default 48 KB of shared memory, which a
// kernel is allowed only once its limit is raised on the device. Raise it at
// the kernel's first launch on each device, not at every launch: the smem
// size of one instantiation is fixed. THREADS is the kernel's block size.
template <auto Kernel, int THREADS = NT, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  Kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (causal) {
    return lse ? launch<fwd_kernel<T, D, true, true>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                      seq_q, seq_k, scale)
               : launch<fwd_kernel<T, D, true, false>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                       seq_q, seq_k, scale);
  }
  return lse ? launch<fwd_kernel<T, D, false, true>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                     seq_q, seq_k, scale)
             : launch<fwd_kernel<T, D, false, false>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                      seq_q, seq_k, scale);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, float* dq, int bh, int seq_q, int seq_k,
                   float scale, bool causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  return causal ? launch<bwd_dq_kernel<T, D, true>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                    delta, dq, seq_q, seq_k, scale)
                : launch<bwd_dq_kernel<T, D, false>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                     delta, dq, seq_q, seq_k, scale);
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, float* dk, float* dv, int bh,
                    int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
  const dim3 grid((seq_k + BK - 1) / BK, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  return causal ? launch<bwd_dkv_kernel<T, D, true>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                     delta, dk, dv, seq_q, seq_k, scale)
                : launch<bwd_dkv_kernel<T, D, false>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                      delta, dk, dv, seq_q, seq_k, scale);
}

template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (BQ + 4 * BK) * (D + TC_LD_PAD);
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  if (causal) {
    return lse ? launch<fwd_kernel_tc<D, true, true>, TC_THREADS>(grid, smem, stream, qt, kt, vt,
                                                                  ot, lse, seq_q, seq_k, scale)
               : launch<fwd_kernel_tc<D, true, false>, TC_THREADS>(grid, smem, stream, qt, kt, vt,
                                                                   ot, lse, seq_q, seq_k, scale);
  }
  return lse ? launch<fwd_kernel_tc<D, false, true>, TC_THREADS>(grid, smem, stream, qt, kt, vt,
                                                                 ot, lse, seq_q, seq_k, scale)
             : launch<fwd_kernel_tc<D, false, false>, TC_THREADS>(grid, smem, stream, qt, kt, vt,
                                                                  ot, lse, seq_q, seq_k, scale);
}

template <int D>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * BK + 4 * BQ) * (D + TC_LD_PAD) + sizeof(float) * 4 * BQ;
  const dim3 grid((seq_k + BK - 1) / BK, bh);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  return causal ? launch<bwd_dkv_kernel_tc<D, true>, TC_THREADS>(
                      grid, smem, stream, qt, kt, vt, dot, lse, delta, dk, dv, seq_q, seq_k, scale)
                : launch<bwd_dkv_kernel_tc<D, false>, TC_THREADS>(
                      grid, smem, stream, qt, kt, vt, dot, lse, delta, dk, dv, seq_q, seq_k, scale);
}

template <int D>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, int bh, int seq_q,
                      int seq_k, float scale, bool causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * BQ + 4 * BK) * (D + TC_LD_PAD);
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  return causal ? launch<bwd_dq_kernel_tc<D, true>, TC_THREADS>(
                      grid, smem, stream, qt, kt, vt, dot, lse, delta, dq, seq_q, seq_k, scale)
                : launch<bwd_dq_kernel_tc<D, false>, TC_THREADS>(
                      grid, smem, stream, qt, kt, vt, dot, lse, delta, dq, seq_q, seq_k, scale);
}

}  // namespace

// ------------------------------------------------------------ C interface
// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. Each function
// returns the cudaError_t of its launch (0 on success); the kernel runs on
// `stream` and nothing here synchronises or allocates. f32 goes to F32_FN,
// the CUDA-core kernels; bf16 to BF16_FN, the tensor-core kernels.

#define RT_DISPATCH(F32_FN, BF16_FN, ...)                                              \
  if (dtype == 0 && head_dim == 64) return F32_FN<float, 64>(__VA_ARGS__);             \
  if (dtype == 0 && head_dim == 128) return F32_FN<float, 128>(__VA_ARGS__);           \
  if (dtype == 1 && head_dim == 64) return BF16_FN<64>(__VA_ARGS__);                   \
  if (dtype == 1 && head_dim == 128) return BF16_FN<128>(__VA_ARGS__);                 \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" {

int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                 int seq_q, int seq_k, int head_dim, float scale, int causal, int dtype,
                 void* stream) {
  RT_DISPATCH(fwd, fwd_tc, q, k, v, o, static_cast<float*>(lse), bh, seq_q, seq_k, scale,
              causal != 0, static_cast<cudaStream_t>(stream))
}

int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int bh, int seq_q, int seq_k,
                    int head_dim, float scale, int causal, int dtype, void* stream) {
  RT_DISPATCH(bwd_dq, bwd_dq_tc, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dq), bh, seq_q, seq_k, scale,
              causal != 0, static_cast<cudaStream_t>(stream))
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bh, int seq_q,
                     int seq_k, int head_dim, float scale, int causal, int dtype, void* stream) {
  RT_DISPATCH(bwd_dkv, bwd_dkv_tc, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
              bh, seq_q, seq_k, scale, causal != 0, static_cast<cudaStream_t>(stream))
}

const char* rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
